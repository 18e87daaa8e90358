"""The measured speed model in the port (``core.heterogeneity.
MeasuredSpeedModel`` and the trainer's ``_observe_window``), held to the
reference's under one scripted timer.

The timer is the only input a card adds to the loop: under a measured
model every host decision is a function of its readings. ``ScriptedTimer``
hands out a fixed list of readings in order, so the same list drives both
packages, and each must read it exactly twice a mega-batch (``begin`` just
before the rounds, ``elapsed`` just after their metrics are collected).

* unit parity — the same sequences of observations, windows, resizes,
  permutations and state-dict round trips through both packages' models:
  EMAs, observation counts, window counters and factors identical (both
  run the same float64 numpy arithmetic);
* trainer parity — ``adaptive``, ``crossbow`` and ``elastic`` with the
  pipeline on and off, the XML model and reduced tinyllama:
  per mega-batch the records' host decisions and ``speed.factors`` and
  ``n_obs`` identical to the reference's, losses and the global model
  within rtol 1e-5 / atol 1e-6 (``tests/torch_elastic_runs.py``; the LM
  within ``tests/torch_lm_runs.py``'s f32 tolerance);
* the elastic layer — a resize schedule (4 -> 6 -> 3), an eviction and a
  stall under ``FleetController`` (a stall is skipped under a measured
  model, in both packages), and the timeout detector reading measured
  factors;
* checkpoints — taken mid-prefetch with a measured model, restored in both
  packages from either package's checkpoint, continuing identically;
* the launcher — ``--speed measured`` on the CPU gives the reference
  launcher's run under the same timer.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest

import torch_elastic_runs as E
import torch_lm_runs as L
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.checkpoint import store as jstore
from repro.core import heterogeneity as jhet
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import TokenProvider as JTokenProvider
from repro.launch import train as jtrain
from repro.models import model as JMDL
from repro_torch.checkpoint import store
from repro_torch.core import heterogeneity as het
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import TokenProvider
from repro_torch.launch import train
from repro_torch.models import model as MDL
from repro_torch.models.protocol import TrainableModel
from repro_torch.utils import tree as tu

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

N_MB = 5


class ScriptedTimer:
    """A clock that returns ``readings`` in order and counts its reads."""

    def __init__(self, readings):
        self.readings = list(readings)
        self.calls = 0

    def __call__(self) -> float:
        if self.calls >= len(self.readings):
            raise AssertionError(f"timer read {self.calls + 1} times, "
                                 f"{len(self.readings)} readings scripted")
        value = self.readings[self.calls]
        self.calls += 1
        return value


def readings(n_windows: int, seed: int = 0) -> list:
    """``begin``/``elapsed`` pairs, window k opening at 1000 + 10 k seconds
    and lasting 0.2-2.0 s."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_windows):
        t0 = 1000.0 + 10.0 * k
        out += [t0, t0 + float(rng.uniform(0.2, 2.0))]
    return out


def models(n_replicas: int, n_windows: int = 64, seed: int = 0, **kw):
    """(port model, reference model, their timers) on the same readings."""
    timers = [ScriptedTimer(readings(n_windows, seed)) for _ in range(2)]
    return (het.MeasuredSpeedModel(n_replicas, timer=timers[0], **kw),
            jhet.MeasuredSpeedModel(n_replicas, timer=timers[1], **kw), timers)


def assert_models_equal(m, jm):
    np.testing.assert_array_equal(m.t_per_work, jm.t_per_work)
    np.testing.assert_array_equal(m.n_obs, jm.n_obs)
    assert (m.n_replicas, m.n_windows, m.skip_windows) == (
        jm.n_replicas, jm.n_windows, jm.skip_windows)
    np.testing.assert_array_equal(m.factors, jm.factors)
    assert [m.step_factor(i) for i in range(m.n_replicas)] == [
        jm.step_factor(i) for i in range(jm.n_replicas)]


# --------------------------------------------------------------------------
# unit parity
# --------------------------------------------------------------------------

UNIT_KW = [dict(), dict(ema=0.25, min_obs=2, warmup_windows=2), dict(warmup_windows=0)]


@pytest.mark.parametrize("kw", UNIT_KW, ids=["default", "ema-min_obs-warmup", "no-warmup"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measured_model_matches_reference(kw, seed):
    """A random sequence of every operation — single observations (some of
    zero work or seconds), plan windows (with and without ``u``, and
    degenerate: no rounds, all-zero ``u``), per-shard windows (a shard
    count that divides the population and one that does not), resizes up
    and down, permutations, discarded windows and state-dict round trips —
    leaves both models equal after each step."""
    rng = np.random.default_rng(seed)
    m, jm, _ = models(4, seed=seed, **kw)
    assert_models_equal(m, jm)
    ops = ("observe", "plan", "plan", "plan_no_u", "degenerate", "shards", "resize",
           "permute", "discard", "roundtrip", "window")
    for _ in range(60):
        op = ops[rng.integers(len(ops))]
        R = m.n_replicas
        work = rng.integers(0, 400, R).astype(np.float64)
        u = rng.integers(0, 6, R)
        if op == "observe":
            args = (int(rng.integers(R)), float(rng.choice([0.0, rng.uniform(1, 50)])),
                    float(rng.choice([0.0, rng.uniform(0.01, 2)])))
            m.observe(*args)
            jm.observe(*args)
        elif op == "plan":
            seconds = float(rng.uniform(0.1, 3))
            m.observe_plan(work, seconds, u=u, n_rounds=int(u.max()))
            jm.observe_plan(work, seconds, u=u, n_rounds=int(u.max()))
        elif op == "plan_no_u":
            m.observe_plan(work, 1.5)
            jm.observe_plan(work, 1.5)
        elif op == "degenerate":
            zero_u = np.zeros(R, np.int64)
            for mm in (m, jm):
                mm.observe_plan(work, 1.0, u=u, n_rounds=0)
                mm.observe_plan(work, 1.0, u=zero_u, n_rounds=3)
        elif op == "shards":
            # a divisor of R, and a stale count from before a resize
            n_shards = int(rng.choice([d for d in (1, 2, 3, 4, 6) if R % d == 0]))
            for n in (n_shards, R + 1):
                windows = rng.uniform(0.1, 2, n)
                m.observe_shards(windows, work, u=u, n_rounds=int(u.max()))
                jm.observe_shards(windows, work, u=u, n_rounds=int(u.max()))
        elif op == "resize":
            new_R = int(rng.integers(2, 7))
            m.resize(new_R)
            jm.resize(new_R)
        elif op == "permute":
            perm = rng.permutation(R)
            m.permute(perm)
            jm.permute(perm)
        elif op == "discard":
            m.discard_next_window()
            jm.discard_next_window()
        elif op == "roundtrip":
            # each package's state dict loads into a fresh model of the
            # other's at another width
            sd, jsd = m.state_dict(), jm.state_dict()
            assert sd["meta"] == jsd["meta"] and sd["meta"]["kind"] == "measured"
            m = het.MeasuredSpeedModel(1, timer=m.timer, **kw)
            jm = jhet.MeasuredSpeedModel(2, timer=jm.timer, **kw)
            m.load_state_dict(copy.deepcopy(jsd))
            jm.load_state_dict(copy.deepcopy(sd))
        else:  # a timed window through the timers
            assert m.elapsed(m.begin()) == jm.elapsed(jm.begin())
        assert_models_equal(m, jm)
    assert m.timer.calls == jm.timer.calls


def test_warmup_min_obs_and_share_normalisation():
    """The first window is discarded; a replica masked out of half the
    rounds is charged half the window, so equal per-round throughput reads
    equal speed; a replica with fewer than ``min_obs`` observations keeps
    the prior 1.0; a resize discards the next window and starts joiners at
    the prior; the cached factors follow every observation."""
    m, jm, _ = models(3, min_obs=2)
    for mm in (m, jm):
        mm.observe_plan([100, 100, 50], 9.0, u=[4, 4, 2], n_rounds=4)   # warmup
        assert mm.n_windows == 1 and not mm.n_obs.any()
        mm.observe_plan([100, 100, 50], 2.0, u=[4, 4, 2], n_rounds=4)
        np.testing.assert_array_equal(mm.factors, [1.0, 1.0, 1.0])    # min_obs 2
        mm.observe_plan([100, 200, 50], 2.0, u=[4, 4, 2], n_rounds=4)
        # replica 1 did twice the work in the same share: twice as fast
        np.testing.assert_allclose(mm.factors, [1.0 / 0.75, 1.0, 1.0 / 0.75])
        mm.resize(4)
        assert mm.skip_windows == 1 and mm.factors[3] == 1.0
        before = mm.t_per_work.copy()
        mm.observe_plan([1, 1, 1, 1], 5.0, u=[1, 1, 1, 1], n_rounds=1)  # discarded
        np.testing.assert_array_equal(mm.t_per_work, before)
    assert_models_equal(m, jm)


# --------------------------------------------------------------------------
# trainer parity under one scripted timer
# --------------------------------------------------------------------------


class Probe:
    """``run``'s checkpoint hook: after each mega-batch, the speed model's
    factors and observation counts (and a real manager's save, if given)."""

    def __init__(self, manager=None):
        self.manager = manager
        self.rows = []

    def maybe_save(self, trainer, state):
        self.rows.append((np.array(trainer.speed.factors, np.float64),
                          np.array(trainer.speed.n_obs, np.int64)))
        if self.manager is not None:
            self.manager.maybe_save(trainer, state)

    def wait(self):
        if self.manager is not None:
            self.manager.wait()


def assert_speed_rows_equal(rows, jrows):
    assert len(rows) == len(jrows)
    for (f, n), (jf, jn) in zip(rows, jrows):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(n, jn)


def xml_runs(algo, overlap=True, n_mb=N_MB, schedule=None, faults=None,
             timeout_factor=0.0, seed=0):
    """A port and a reference XML run, each with a measured model on the
    same scripted readings; returns both runs, probes and timers."""
    out = []
    for make, run in ((E.port_trainer, E.run_port), (E.ref_trainer, E.run_ref)):
        mod = het if make is E.port_trainer else jhet
        timer = ScriptedTimer(readings(4 * n_mb, seed))
        speed = mod.MeasuredSpeedModel(E._cfg(E.ElasticConfig, algo, E.R0).n_replicas,
                                       timer=timer)
        tr, test = make(algo, speed=speed, overlap=overlap)
        probe = Probe()
        result = run(algo, n_mb=n_mb, schedule=schedule, faults=faults,
                     timeout_factor=timeout_factor, trainer=(tr, test), checkpoint=probe)
        out.append((result, probe, timer))
    return out


def assert_measured_runs_match(runs, n_mb=N_MB):
    (port_run, probe, timer), (ref_run, jprobe, jtimer) = runs
    E.assert_runs_match(port_run, ref_run, n_mb=n_mb)
    assert_speed_rows_equal(probe.rows, jprobe.rows)
    assert timer.calls == jtimer.calls == 2 * n_mb
    # the loop really ran on measured speeds: the factors moved off 1.0
    assert any(np.any(f != 1.0) for f, _ in probe.rows)


CASES = [(a, o) for a in ("adaptive", "crossbow", "elastic") for o in (True, False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-scan-overlap_{c[1]}")
def test_xml_trainer_matches_reference_under_one_timer(case):
    """Host decisions, factors and observation counts identical every
    mega-batch; losses and the global model within 1e-5."""
    algo, overlap = case
    runs = xml_runs(algo, overlap)
    assert_measured_runs_match(runs)
    if algo == "adaptive":
        # the measured factors reached the plans: the update counts differ
        assert any(len(set(r["u"])) > 1 for r in runs[0][0][1].records)


def test_overlap_plans_one_window_stale():
    """Under the pipeline, plan N+1 is made before window N is observed, so
    the pipelined and the sequential run part ways once the measured
    factors move (each held to its reference counterpart above)."""
    on, off = xml_runs("adaptive", True), xml_runs("adaptive", False)
    u_on = [r["u"] for r in on[0][0][1].records]
    u_off = [r["u"] for r in off[0][0][1].records]
    assert u_on[:2] == u_off[:2] and u_on != u_off


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap_on", "overlap_off"])
def test_elastic_scenario_under_a_measured_model_matches_reference(overlap):
    """The resize schedule (4 -> 6 at mega-batch 2 -> 3 at 5) and every
    fault kind of ``tests/torch_elastic_runs.py``: a NaN, a crash (an
    eviction), a stall, a preemption, the readmissions and a join. The
    stall is skipped under a measured model (``stall_skipped``, as in the
    reference): its factors come from the timer alone."""
    runs = xml_runs("adaptive", overlap, n_mb=E.N_MB, schedule=E.SCHEDULE,
                    faults=E.FAULTS)
    assert_measured_runs_match(runs, n_mb=E.N_MB)
    events = runs[0][0][2]
    assert {"evict", "join", "rejoin", "stall_skipped"} <= {e["action"] for e in events}
    assert [r["n_replicas"] for r in runs[0][0][1].records][:3] == [4, 4, 6]


def test_timeout_detector_reads_measured_factors_as_the_reference():
    """The health detector evicts the replica whose measured factor passes
    1.2 times the median, at the same mega-batch in both packages."""
    runs = xml_runs("adaptive", True, n_mb=6, timeout_factor=1.2, seed=3)
    assert_measured_runs_match(runs, n_mb=6)
    assert any(e["action"] == "evict" for e in runs[0][0][2])


def _lm_port_trainer(overlap, speed):
    _, tcfg = L.configs("tinyllama-1.1b")
    p0 = L.init_np("tinyllama-1.1b")
    model = TrainableModel(init=lambda generator: tu.flatten(MDL.params_from_jax(p0, "cpu")),
                           loss_fn=MDL.make_model(tcfg).loss_fn, config=tcfg)
    prov = TokenProvider.make(tcfg.vocab_size, L.SEQ, seed=0)
    tr = ElasticTrainer(model, prov, L._elastic(L.ElasticConfig, "adaptive"), base_lr=L.LR,
                        seed=0, device="cpu", overlap=overlap, speed=speed)
    return tr, prov.test_batches(2, L.B_MAX)


def _lm_ref_trainer(overlap, speed):
    jcfg, _ = L.configs("tinyllama-1.1b")
    prov = JTokenProvider.make(jcfg.vocab_size, L.SEQ, seed=0)
    tr = JTrainer(JMDL.make_model(jcfg), prov, L._elastic(L.JElasticConfig, "adaptive"),
                  base_lr=L.LR, seed=0, overlap=overlap, speed=speed)
    return tr, prov.test_batches(2, L.B_MAX)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap_on", "overlap_off"])
def test_lm_trainer_matches_reference_under_one_timer(overlap):
    """Reduced tinyllama (f32), Adaptive SGD, ``TokenProvider``: work units
    are tokens. Host decisions, factors and counts identical; metrics and
    the global model within the f32 LM tolerance. Every sample holds the
    same number of tokens, so a replica's share of the window over its
    tokens is the same for all: the factors stay at 1.0 while the counts
    grow (the whole-window attribution sees no contrast here)."""
    runs = []
    for make, mod in ((_lm_port_trainer, het), (_lm_ref_trainer, jhet)):
        timer = ScriptedTimer(readings(4 * L.N_MB, seed=5))
        tr, test = make(overlap, mod.MeasuredSpeedModel(4, timer=timer))
        probe = Probe()
        runs.append((tr.run(L.N_MB, test_batches=test, checkpoint=probe), probe, timer))
    (port_run, probe, timer), (ref_run, jprobe, jtimer) = runs
    L.assert_runs_match(port_run, ref_run, L.F32_TOL)
    assert_speed_rows_equal(probe.rows, jprobe.rows)
    assert timer.calls == jtimer.calls == 2 * L.N_MB
    assert probe.rows[-1][1].tolist() == [L.N_MB - 1] * 4       # the warmup window, then all
    np.testing.assert_array_equal(probe.rows[-1][0], np.ones(4))


# --------------------------------------------------------------------------
# checkpoints taken mid-prefetch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mid_prefetch_checkpoint_with_a_measured_model_crosses_packages(tmp_path, writer):
    """The writer runs three pipelined mega-batches under a measured model,
    so the fourth is staged, and saves a checkpoint: it holds the live
    EMAs and counters (not a snapshot) and the staged plan's pre-staging
    cursors. Both packages restore it (each discards its first window, as
    the reference does after a restore) and continue for three mega-batches
    on the same readings with identical decisions and factors."""
    w_mod, w_make, w_store = ((jhet, E.ref_trainer, jstore) if writer == "reference"
                              else (het, E.port_trainer, store))
    w_timer = ScriptedTimer(readings(16))
    w_tr, _ = w_make("adaptive", speed=w_mod.MeasuredSpeedModel(4, timer=w_timer))
    state = w_tr.init_state()
    for _ in range(3):
        state, _ = w_tr.run_megabatch(state, prefetch=True)
    assert w_tr._staged is not None
    mgr = w_store.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(w_tr, state)
    mgr.wait()
    path = mgr.step_path(3)
    meta = store.load_metadata(path)
    assert meta["speed_meta"] == w_tr.speed.state_dict()["meta"]   # live, not rolled back
    assert meta["provider"] != w_tr.provider.state_dict()           # the staged plan's cursors
    results = []
    for make, mod in ((E.port_trainer, het), (E.ref_trainer, jhet)):
        timer = ScriptedTimer(readings(16, seed=9))
        tr, _ = make("adaptive", speed=mod.MeasuredSpeedModel(4, timer=timer))
        s = tr.restore_checkpoint(path)
        assert tr.speed.skip_windows == meta["speed_meta"]["skip_windows"] + 1
        recs, rows = [], []
        for prefetch in (True, True, False):
            s, info = tr.run_megabatch(s, prefetch=prefetch)
            recs.append(info)
            rows.append((np.array(tr.speed.factors), np.array(tr.speed.n_obs)))
        results.append((s, recs, rows, timer))
    (p_state, p_recs, p_rows, p_timer), (j_state, j_recs, j_rows, j_timer) = results
    for rec, jrec in zip(p_recs, j_recs):
        for k in E.EXACT:
            assert rec[k] == jrec[k], k
        for k in ("train_loss", "train_accuracy"):
            np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **E.TOL)
    assert_speed_rows_equal(p_rows, j_rows)
    assert p_timer.calls == j_timer.calls == 6
    E.assert_state_matches(p_state, j_state)


def test_prefetch_revocation_leaves_a_measured_model_live():
    """``invalidate_prefetch`` rolls the provider and clocks back but not
    a measured model (its snapshot is ``None``, as the reference's): the
    window observed after the staging stays observed."""
    timer = ScriptedTimer(readings(8))
    tr, _ = E.port_trainer("adaptive", speed=het.MeasuredSpeedModel(4, timer=timer))
    state, _ = tr.run_megabatch(tr.init_state(), prefetch=True)
    state, _ = tr.run_megabatch(state, prefetch=True)
    assert tr._staged.snapshot["speed"] is None
    sd = tr.speed.state_dict()
    assert sd["meta"]["n_windows"] == 2 and sd["arrays"]["n_obs"].sum() > 0
    tr.invalidate_prefetch()
    after = tr.speed.state_dict()
    assert after["meta"] == sd["meta"]
    np.testing.assert_array_equal(after["arrays"]["t_per_work"], sd["arrays"]["t_per_work"])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def test_launcher_speed_measured_matches_the_reference_launcher(monkeypatch):
    """``--speed measured`` builds a ``MeasuredSpeedModel``; with both
    launchers' models reading one scripted timer, the port's tiny XML run
    on the CPU plans as the reference launcher's run: the same update
    counts, batch sizes, learning rates, rounds, virtual time and factors.
    The launchers draw their initial weights from their own generators
    (torch's and ``jax.random``), so losses are not compared here."""
    built = []

    def scripted(module):
        real = module.MeasuredSpeedModel

        def make(n_replicas):
            model = real(n_replicas, timer=ScriptedTimer(readings(12, seed=4)))
            built.append(model)
            return model

        return make

    monkeypatch.setattr(train, "MeasuredSpeedModel", scripted(het))
    monkeypatch.setattr(jtrain, "MeasuredSpeedModel", scripted(jhet))
    argv = ["--workload", "xml", "--algorithm", "adaptive", "--replicas", "4",
            "--megabatches", "4", "--samples", "512", "--features", "256", "--classes", "32",
            "--avg-nnz", "16", "--hidden", "16", "--b-max", "32", "--mega-batch", "10",
            "--speed", "measured"]
    _, mlog = train.main(argv + ["--device", "cpu"])
    _, jlog = jtrain.main(argv)
    assert [type(m) for m in built] == [het.MeasuredSpeedModel, jhet.MeasuredSpeedModel]
    assert built[0].timer.calls == built[1].timer.calls == 8
    np.testing.assert_array_equal(built[0].factors, built[1].factors)
    assert len(mlog.records) == len(jlog.records) == 4
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in ("n_replicas", "u", "b", "lr", "n_rounds", "virtual_time"):
            assert rec[k] == jrec[k], k
    assert any(len(set(r["u"])) > 1 for r in mlog.records)
    with pytest.raises(SystemExit):
        train.parser().parse_args(["--speed", "fast"])
