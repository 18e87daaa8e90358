"""A host-span fleet of the port's trainer, on the CPU: two trainers in two
threads, one ``MultihostContext`` each on one fleet dir, each holding its
block of two replicas on two CPU shards (global R = 4).

* Against the port's single-process sharded run (four CPU shards), every
  algorithm the host span takes: host decisions (u, b, lr, alphas,
  n_rounds, virtual time, perturbation) identical in both processes,
  losses, accuracies and the global model within rtol 1e-5 / atol 1e-6 (the
  slice-1 tolerance, tests/torch_elastic_runs.py). The merge's partials are
  summed per process and then over the processes, another order than one
  process's sum over its shards.
* Against the reference's single-process sharded run through its launcher
  (``repro.launch.train.main``, ``--placement sharded --multihost off``) at
  the reference's own e2e widths (tests/test_multihost.py): u and b
  identical, losses and model within the same tolerance; the port's
  trainers start from the reference's initial weights.
* An eviction through the heartbeat path (a monitor stub proposes the crash
  of process 1 once it has stopped, a liveness stub reports it dead):
  process 0 drops it mid-exchange, evicts its slots through the
  FleetController and finishes alone at R = 2, against the reference's
  ``remove_replicas(merge_leavers=False)`` of the same slots.
* A span checkpoint (process 0 publishes) restores in a single-process port
  trainer and in the reference, and each finishes as the fleet did.
* The span's refusals: the vmap placement, the legacy engine, a passed
  mesh, the measured speed model, in-round collectives on the host span,
  ``resize``.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs.base import ElasticConfig
from repro_torch.core.fleet import FaultEvent, FleetController
from repro_torch.core.heterogeneity import MeasuredSpeedModel, SpeedModel
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.launch.multihost import MultihostSpec, bootstrap
from repro_torch.models import xml_mlp as port
from repro_torch.models.protocol import TrainableModel

pytestmark = pytest.mark.usefixtures("one_thread")

LOCAL = ("cpu", "cpu")
HOST_ALGOS = ("adaptive", "elastic")
N_MB = 3


def ctx(fleet_dir, pid, n=2):
    return bootstrap(MultihostSpec(num_processes=n, process_id=pid, fleet_dir=str(fleet_dir),
                                   spanning="host", local_devices=LOCAL))


def span_trainer(algo, mh, **kw):
    """E.port_trainer's model, data and config under the sharded placement,
    spanning through ``mh`` (or over four CPU shards without it)."""
    ds = make_xml_dataset(**E.DATA)
    train, test = train_test_split(ds, 0.2, seed=0)
    prov = SparseProvider.make(train, seed=0)
    base = port.make_model(port.XMLMLPConfig(n_features=E.NF, n_classes=E.NC, hidden=E.H))
    p0 = E.init_np()
    model = TrainableModel(init=lambda generator: port.params_from_jax(p0, "cpu"),
                           loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                           config=base.config)
    cfg = E._cfg(ElasticConfig, algo, E.R0, "sharded")
    mesh = None if mh is not None else ["cpu"] * 4
    tr = ElasticTrainer(model, prov, cfg, base_lr=E.LR, seed=0, device=None, mesh=mesh,
                        multihost=mh, **kw)
    return tr, prov.test_batches(test, E.B_MAX)


def in_threads(*fns):
    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def fleet_run(tmp_path, algo, n_mb=N_MB, **trainer_kw):
    """Both processes' (trainer, state, mlog)."""
    def proc(pid):
        tr, test = span_trainer(algo, ctx(tmp_path, pid), **trainer_kw)
        state, mlog = tr.run(n_mb, test_batches=test)
        tr.close()
        return tr, state, mlog

    return in_threads(lambda: proc(0), lambda: proc(1))


def assert_records_match(mlog, jlog, exact=E.EXACT):
    assert len(mlog.records) == len(jlog.records)
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in exact:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
    for k in E.METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **E.TOL)


def assert_models_match(model, want):
    for k, v in model.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), err_msg=k, **E.TOL)


@pytest.mark.parametrize("algo,overlap", [(a, True) for a in HOST_ALGOS] + [("adaptive", False)])
def test_two_process_span_matches_single_process_sharded(tmp_path, algo, overlap):
    """Both pipelines: the overlap pipeline's staging and the sequential
    path's upload each pack and upload only the process's own columns."""
    single, test = span_trainer(algo, None, overlap=overlap)
    sstate, slog = single.run(N_MB, test_batches=test)
    single.close()
    for tr, state, mlog in fleet_run(tmp_path, algo, overlap=overlap):
        staged = tr.staging_log[-1]
        assert staged["bytes"] < single.staging_log[-1]["bytes"]
        assert tr._span.local_count() == 2 and len(tr.mesh) == 2
        assert len(state.replicas.blocks) == 2
        assert_records_match(mlog, slog)
        np.testing.assert_array_equal(state.b, sstate.b)
        np.testing.assert_array_equal(state.lr, sstate.lr)
        assert_models_match(state.global_model, sstate.global_model)
        # each process holds its own block of the single run's replicas
        lo, hi = tr._span.local_bounds()
        whole = sstate.replicas.gather("cpu")
        local = state.replicas.gather("cpu")
        for k in whole:
            np.testing.assert_allclose(local[k].numpy(), whole[k][lo:hi].numpy(), err_msg=k,
                                       **E.TOL)
        assert tr._span.stats["merge"]["calls"] == N_MB


def test_two_process_span_matches_reference_launcher(tmp_path):
    """The reference's single-process sharded trajectory, through its own
    launcher, at its e2e widths (tests/test_multihost.py's _workload_args):
    the port's fleet from the same data and the reference's initial
    weights."""
    import jax

    from repro.launch import train as jtrain
    from repro.models import xml_mlp as jref

    args = ["--workload", "xml", "--samples", "1024", "--features", "256", "--classes", "64",
            "--hidden", "32", "--b-max", "32", "--mega-batch", "6", "--replicas", "4",
            "--algorithm", "adaptive", "--megabatches", str(N_MB), "--seed", "0"]
    jstate, jlog = jtrain.main(args + ["--placement", "sharded", "--multihost", "off"])

    p0 = {k: np.asarray(v) for k, v in jref.init_params(
        jref.XMLMLPConfig(n_features=256, n_classes=64, hidden=32),
        jax.random.PRNGKey(0)).items()}

    def proc(pid):
        ds = make_xml_dataset(n_samples=1024, n_features=256, n_classes=64, avg_nnz=64, seed=0)
        train, test = train_test_split(ds, test_frac=0.2, seed=0)
        prov = SparseProvider.make(train, seed=0)
        base = port.make_model(port.XMLMLPConfig(n_features=256, n_classes=64, hidden=32))
        model = TrainableModel(init=lambda generator: port.params_from_jax(p0, "cpu"),
                               loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                               config=base.config)
        cfg = ElasticConfig.from_bmax(32, algorithm="adaptive", n_replicas=4, mega_batch=6,
                                      placement="sharded")
        tr = ElasticTrainer(model, prov, cfg, base_lr=0.05, seed=0,
                            speed=SpeedModel(4, max_gap=0.32, seed=0),
                            multihost=ctx(tmp_path, pid))
        state, mlog = tr.run(N_MB, test_batches=prov.test_batches(test, 32, max_samples=2048))
        tr.close()
        return state, mlog

    for state, mlog in in_threads(lambda: proc(0), lambda: proc(1)):
        assert_records_match(mlog, jlog, exact=("u", "b", "lr", "n_rounds", "n_replicas"))
        assert_models_match(state.global_model, jstate.global_model)


class _StubMonitor:
    """A monitor whose process 0 proposes the crash of process 1 at one
    boundary (the heartbeat path's proposal, without real leases)."""

    def __init__(self, crash_at=None):
        self.crash_at = crash_at
        self.dead = []

    def renew(self, megabatch=None, status=None):
        pass

    def poll(self, mb):
        return [FaultEvent("crash", process=1)] if mb == self.crash_at else []

    def mark_dead(self, pid, mb):
        self.dead.append((pid, mb))


class _Liveness:
    """The exchange's wait predicate: process 1 is alive until it stops."""

    def __init__(self, stopped: threading.Event):
        self.stopped = stopped
        self.condemned = []

    def peer_fresh(self, pid):
        return not self.stopped.is_set()

    def note_condemned(self, pid):
        self.condemned.append(pid)


def test_heartbeat_eviction_matches_reference_remove_replicas(tmp_path):
    crash_at, n_mb = 2, 4
    stopped = threading.Event()
    monitor0 = _StubMonitor(crash_at)
    liveness = _Liveness(stopped)

    def proc(pid):
        mh = ctx(tmp_path, pid)
        if pid == 0:
            mh.attach_liveness(liveness)
        tr, test = span_trainer("adaptive", mh)
        ctl = FleetController(monitor=monitor0 if pid == 0 else _StubMonitor())
        try:
            state, mlog = tr.run(n_mb if pid == 0 else crash_at, test_batches=test, fleet=ctl)
        finally:
            if pid == 1:
                stopped.set()      # process 1 "dies" after two mega-batches
        tr.close()
        return tr, state, mlog, ctl

    (tr, state, mlog, ctl), _ = in_threads(lambda: proc(0), lambda: proc(1))
    assert ctl.events == [{"mb": crash_at, "action": "evict", "replica": [2, 3],
                           "reason": "crash", "graceful": False, "process": 1}]
    assert monitor0.dead == [(1, crash_at)] and set(liveness.condemned) == {1}
    assert tr._span.active_processes() == [0] and tr.cfg.n_replicas == 2
    assert [r["n_replicas"] for r in mlog.records] == [4, 4, 2, 2]

    jtr, jtest = E.ref_trainer("adaptive", placement="vmap")
    jstate = jtr.init_state()
    jrecs = []
    for mb in range(n_mb):
        if mb == crash_at:
            jstate = jtr.remove_replicas(jstate, [2, 3], merge_leavers=False)
        jstate, info = jtr.run_megabatch(jstate)
        jrecs.append(info)
    for rec, jrec in zip(mlog.records, jrecs):
        for k in E.EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
        np.testing.assert_allclose(rec["train_loss"], jrec["train_loss"], **E.TOL)
    np.testing.assert_array_equal(state.b, np.asarray(jstate.b))
    assert_models_match(state.global_model, jstate.global_model)


def test_span_checkpoint_restores_in_one_process_and_in_reference(tmp_path):
    ckpt = tmp_path / "ckpt"
    n_mb = 4
    fleet = in_threads(*[
        (lambda pid=pid: _ckpt_proc(tmp_path / "fleet", pid, ckpt, n_mb)) for pid in (0, 1)])
    (_, state, mlog), _ = fleet
    written = sorted(p.name for p in ckpt.iterdir())
    assert written == ["ckpt-000002", "ckpt-000004"]

    # one process, the port's sharded placement on four CPU shards
    single, test = span_trainer("adaptive", None)
    sstate, slog = single.run(n_mb, test_batches=test, restore_from=str(ckpt / "ckpt-000002"))
    single.close()
    assert_records_match(slog, _tail(mlog, 2))
    assert_models_match(sstate.global_model, state.global_model)

    # the reference, vmap on one process
    jtr, jtest = E.ref_trainer("adaptive")
    jstate, jlog = jtr.run(n_mb, test_batches=jtest, restore_from=str(ckpt / "ckpt-000002"))
    assert_records_match(_tail(mlog, 2), jlog)
    assert_models_match(state.global_model, jstate.global_model)


def _ckpt_proc(fleet_dir, pid, ckpt, n_mb):
    tr, test = span_trainer("adaptive", ctx(fleet_dir, pid))
    manager = CheckpointManager(str(ckpt), every=2, publisher=pid == 0)
    state, mlog = tr.run(n_mb, test_batches=test, checkpoint=manager)
    tr.close()
    return tr, state, mlog


def _tail(mlog, start):
    from repro_torch.utils.logging import MetricsLog

    out = MetricsLog()
    for rec in mlog.records[start:]:
        out.append(**rec)
    return out


@pytest.mark.parametrize("case", ["vmap", "legacy_loop", "mesh", "measured", "sync"])
def test_span_refusals(tmp_path, case):
    mh = ctx(tmp_path, 0)
    base = port.make_model(port.XMLMLPConfig(n_features=16, n_classes=4, hidden=8))
    cfg = ElasticConfig.from_bmax(8, algorithm="sync" if case == "sync" else "adaptive",
                                  n_replicas=4, placement="vmap" if case == "vmap" else "sharded")
    kw = dict(engine="legacy_loop" if case == "legacy_loop" else "scan",
              mesh=["cpu", "cpu"] if case == "mesh" else None,
              speed=MeasuredSpeedModel(4) if case == "measured" else None)
    with pytest.raises(ValueError, match="multihost|round_collectives"):
        ElasticTrainer(base, None, cfg, multihost=mh, **kw)


def test_span_refuses_resize(tmp_path):
    tr, _ = span_trainer("adaptive", ctx(tmp_path, 0, n=1))
    state = tr.init_state()
    with pytest.raises(ValueError, match="process grain"):
        tr.resize(state, 2)
    tr.close()
