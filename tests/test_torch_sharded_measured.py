"""The measured speed model under the sharded placement: each shard's own
window feeds ``MeasuredSpeedModel.observe_shards``.

The shards mark their windows from their own threads, so the order of
their clock reads is not fixed, and neither is the order of the
reference's per-shard callbacks. The parity tests therefore script the
per-shard *windows* (through ``ShardWindowTimer.take``), not a list of
clock readings, and feed the same windows to both packages: the port over
four CPU shards, the reference's sharded placement on its one CPU device
(a one-shard mesh, whose timer's ``take`` is scripted alike). The
mega-batch clock (``begin``/``elapsed``) reads one scripted timer in each,
as in tests/test_torch_measured_speed.py. Host decisions and the factors
after every mega-batch must be identical; losses and the global model
within rtol 1e-5 / atol 1e-6 (tests/torch_elastic_runs.py).
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.core.heterogeneity import MeasuredSpeedModel as JMeasuredSpeedModel
from repro_torch.core.heterogeneity import MeasuredSpeedModel

pytestmark = pytest.mark.usefixtures("one_thread")

N_MB = 6
# one window a shard and mega-batch: shard 2 slow, shard 0 slowing down
WINDOWS = [np.array(w) for w in (
    [0.40, 0.20, 0.60, 0.20], [0.20, 0.21, 0.59, 0.20], [0.25, 0.20, 0.61, 0.19],
    [0.30, 0.20, 0.58, 0.21], [0.35, 0.19, 0.60, 0.20], [0.40, 0.20, 0.62, 0.20])]


class Clock:
    """A scripted mega-batch clock: 1.0 s a window."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


class Probe:
    """``run``'s checkpoint hook: the factors after each mega-batch."""

    def __init__(self):
        self.rows = []

    def maybe_save(self, trainer, state):
        self.rows.append(np.array(trainer.speed.factors, np.float64))

    def wait(self):
        pass


def _script(trainer, calls):
    """Script the shard timer's windows and count the speed model's
    observation paths."""
    windows = iter(WINDOWS)
    take = trainer._shard_timer.take

    def scripted():
        real = take()
        calls.append("take" if real is not None else "none")
        return next(windows) if real is not None else None

    trainer._shard_timer.take = scripted
    for name in ("observe_shards", "observe_plan"):
        fn = getattr(trainer.speed, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        setattr(trainer.speed, name, counted)


@pytest.mark.parametrize("overlap", [True, False], ids=["scan-True", "scan-False"])
def test_shard_windows_drive_the_plans_as_in_the_reference(overlap):
    runs = []
    for package in ("port", "ref"):
        calls, probe = [], Probe()
        if package == "port":
            tr, test = E.port_trainer("adaptive", mesh=["cpu"] * 4, overlap=overlap,
                                      speed=MeasuredSpeedModel(4, timer=Clock()))
        else:
            tr, test = E.ref_trainer("adaptive", placement="sharded", overlap=overlap,
                                     speed=JMeasuredSpeedModel(4, timer=Clock()))
        _script(tr, calls)
        state, mlog = tr.run(N_MB, test_batches=test, checkpoint=probe)
        if package == "port":
            tr.close()
        runs.append((state, mlog, calls, probe.rows))
    (state, mlog, calls, rows), (jstate, jlog, jcalls, jrows) = runs
    # every shard marked its window: one take and one observe_shards a
    # mega-batch, the whole-window path never
    assert calls == jcalls == ["take", "observe_shards"] * N_MB
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in E.EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
    for f, jf in zip(rows, jrows):
        np.testing.assert_array_equal(f, jf)
    # the windows reached the plans: shard 2's replica is the slowest
    assert rows[-1][2] == max(rows[-1]) > 1.5
    assert mlog.records[-1]["u"][2] == min(mlog.records[-1]["u"])
    for k in E.METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **E.TOL)
    E.assert_state_matches(state, jstate)


def test_cpu_windows_reach_the_model():
    """Unscripted: the shards time their own rounds with the host clock
    (no card), every window is positive and, past the warmup, every
    replica holds a measured, finite factor."""
    tr, test = E.port_trainer("adaptive", mesh=["cpu"] * 2, speed=MeasuredSpeedModel(4))
    seen = []
    take = tr._shard_timer.take
    tr._shard_timer.take = lambda: seen.append(take()) or seen[-1]
    tr.run(3, test_batches=test)
    tr.close()
    assert len(seen) == 3 and all(w is not None and len(w) == 2 and (w > 0).all() for w in seen)
    assert (tr.speed.n_obs > 0).all() and np.isfinite(tr.speed.factors).all()
