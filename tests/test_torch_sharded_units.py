"""The pieces of the port's sharded placement, each on its own: the replica
mesh rules against the reference's, the shard executor's collectives and
its failure path, ``normalized_merge``'s axis branch against the
reference's merge, ``ShardWindowTimer`` against the reference's, the
placement-aware tree helpers, the kernel wrappers' launch counters under
threads, and the trainer's and launcher's refusals.

A mesh of CPU devices (``("cpu",) * 4``) stands where the reference forces
a host device count: four logical shards, each in a worker thread of its
own."""
from __future__ import annotations

import inspect
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.core import adaptive_sgd as jasgd
from repro.core.heterogeneity import ShardWindowTimer as JShardWindowTimer
from repro.sharding.rules import replica_mesh_size as jax_replica_mesh_size
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import adaptive_sgd as asgd
from repro_torch.core.heterogeneity import ShardWindowTimer
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.kernels import _build
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.weighted_merge.ops import merge_cuda
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.models.xml_mlp import XMLMLPConfig, make_model
from repro_torch.sharding.executor import ShardExecutor, bound_axis
from repro_torch.sharding.rules import (
    REPLICA_AXIS,
    ReplicaMeshPool,
    replica_block,
    replica_mesh,
    replica_mesh_size,
)
from repro_torch.utils import tree as tu

pytestmark = pytest.mark.usefixtures("one_thread")

CPU4 = ("cpu",) * 4


# --------------------------------------------------------------------------
# the replica mesh
# --------------------------------------------------------------------------


def test_replica_mesh_size_matches_reference_table():
    """The reference's table (tests/test_sharded_placement.py) and every
    pair up to 12 x 12."""
    assert replica_mesh_size(4, 6) == 4
    assert replica_mesh_size(4, 4) == 4
    assert replica_mesh_size(6, 4) == 3
    assert replica_mesh_size(5, 4) == 1
    assert replica_mesh_size(8, 8) == 8
    for R in range(1, 13):
        for n in range(1, 13):
            assert replica_mesh_size(R, n) == jax_replica_mesh_size(R, n), (R, n)


def test_replica_mesh_and_blocks():
    mesh = replica_mesh(6, CPU4)
    assert mesh == (torch.device("cpu"),) * 3
    assert make_replica_mesh(6, CPU4) == mesh
    assert [replica_block(6, 3, s) for s in range(3)] == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError):
        replica_block(6, 4, 0)


def test_pool_returns_the_same_mesh_for_a_shard_count_it_has_seen():
    pool = ReplicaMeshPool(CPU4)
    m4 = pool.mesh_for(4)
    assert len(m4) == 4 and pool.mesh_for(8) is m4       # 8 over 4: the same count
    m2 = pool.mesh_for(2)
    assert len(m2) == 2 and pool.mesh_for(6) is not m2   # 6 over 4 devices: 3 shards
    assert pool.mesh_for(2) is m2 and pool.mesh_for(4) is m4
    own = (torch.device("cpu"),) * 2
    pool.adopt(own)
    assert pool.mesh_for(2) is own


def test_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaMeshPool()


# --------------------------------------------------------------------------
# the executor: collectives as a rendezvous
# --------------------------------------------------------------------------


@pytest.fixture
def executor():
    ex = ShardExecutor(CPU4, REPLICA_AXIS)
    yield ex
    ex.close()


def test_collectives_sum_in_shard_order_on_every_shard(executor):
    """Every shard gets the same bits: the partials summed in shard order,
    ((p0 + p1) + p2) + p3, whichever thread arrives first."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32) * 10.0 ** s)
             for s in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]

    def fn(s):
        axis = bound_axis(REPLICA_AXIS)
        return (axis.all_sum(parts[s]), axis.all_max(parts[s]), axis.all_max(s == 2),
                axis.all_sum(float(s)), threading.current_thread().name)

    for _ in range(3):
        outs = executor.run(fn)
        for s, (total, mx, any2, host, name) in enumerate(outs):
            assert torch.equal(total, want)
            assert torch.equal(mx, torch.stack(parts).amax(0))
            assert any2 is True and host == 6.0
            assert name == f"shard-{s}-of-4"


def test_collectives_under_stress():
    """More shards than cores, the interpreter switching threads as often
    as it can, 200 collectives in a row: every shard gets the shard-order
    sum and the maximum every time (a slot overwritten or read early by a
    neighbour's next collective would break it)."""
    n, steps = 16, 200
    rng = np.random.default_rng(5)
    values = rng.normal(size=(steps, n)).astype(np.float32)
    want = values[:, 0].copy()
    for s in range(1, n):
        want = want + values[:, s]
    ex = ShardExecutor(("cpu",) * n, REPLICA_AXIS)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(s):
            axis = bound_axis(REPLICA_AXIS)
            return [(axis.all_sum(torch.tensor(values[i, s])).item(),
                     axis.all_max(float(values[i, s]))) for i in range(steps)]

        outs = ex.run(fn)
    finally:
        sys.setswitchinterval(switch)
        ex.close()
    for out in outs:
        assert [t for t, _ in out] == want.tolist()
        assert [m for _, m in out] == values.max(axis=1).astype(np.float64).tolist()


def test_axis_is_unbound_outside_a_worker():
    with pytest.raises(RuntimeError, match="not bound"):
        tu.replica_all_sum(torch.ones(2), REPLICA_AXIS)
    x = torch.ones(2)
    assert tu.replica_all_sum(x, None) is x and tu.replica_all_max(3, None) == 3


def test_a_shard_that_raises_aborts_the_barrier_and_surfaces(executor):
    """Shard 2 fails before the collective the others wait in: they leave
    it with a broken barrier, ``run`` raises shard 2's own error, and the
    next call runs normally."""
    def fn(s):
        if s == 2:
            raise ValueError("shard 2 failed")
        return bound_axis(REPLICA_AXIS).all_sum(torch.ones(1))

    with pytest.raises(ValueError, match="shard 2 failed"):
        executor.run(fn)
    outs = executor.run(lambda s: bound_axis(REPLICA_AXIS).all_sum(torch.ones(1)))
    assert all(o.item() == 4.0 for o in outs)


def test_a_trainer_whose_shard_raises_surfaces_the_error():
    """Inside a sharded mega-batch: one shard's gradient raises while the
    others reach the round's collectives (sync's gradient mean). The
    caller gets that error, no thread hangs, and the trainer runs again."""
    import torch_elastic_runs as E

    tr, _ = E.port_trainer("sync", mesh=CPU4)
    state = tr.init_state()
    grads = tr._grads

    def failing(replicas, batch):
        if threading.current_thread().name.startswith("shard-1-"):
            raise FloatingPointError("shard 1 broke")
        return grads(replicas, batch)

    tr._grads = failing
    with pytest.raises(FloatingPointError, match="shard 1 broke"):
        tr.run_megabatch(state)
    tr._grads = grads
    tr.invalidate_prefetch()
    _, info = tr.run_megabatch(tr.init_state())
    assert np.isfinite(info["train_loss"])
    tr.close()


# --------------------------------------------------------------------------
# the merge's axis branch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [False, True])
def test_shard_reduced_merge_matches_reference(executor, momentum):
    """Each of 4 shards merges its 2 replicas (the no-momentum op), the
    partials are summed over the shards and the momentum term is added to
    the whole sum: the reference's normalized merge within f32 rounding;
    one shard of all 8 replicas equals the vmap merge bitwise."""
    rng = np.random.default_rng(3)
    reps = {"w": rng.normal(size=(8, 6, 5)).astype(np.float32),
            "b": rng.normal(size=(8, 5)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape[1:]).astype(np.float32) for k, v in reps.items()}
    gp = {k: rng.normal(size=v.shape[1:]).astype(np.float32) for k, v in reps.items()}
    alphas = rng.dirichlet(np.ones(8))
    gamma = 0.9 if momentum else 0.0
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    tg, tgp = (t(g), t(gp)) if momentum else (None, None)

    def fn(s):
        rows = replica_block(8, 4, s)
        block = {k: v[rows] for k, v in t(reps).items()}
        return asgd.normalized_merge(block, alphas[rows], tg, tgp, gamma, axis=REPLICA_AXIS)

    outs = executor.run(fn)
    want = jasgd.normalized_merge({k: jnp.asarray(v) for k, v in reps.items()},
                                  alphas, {k: jnp.asarray(v) for k, v in g.items()},
                                  {k: jnp.asarray(v) for k, v in gp.items()}, gamma)
    for k in reps:
        for out in outs:
            assert torch.equal(out[k], outs[0][k])
        np.testing.assert_allclose(outs[0][k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    one = ShardExecutor(("cpu",), REPLICA_AXIS)
    whole = one.run(lambda s: asgd.normalized_merge(t(reps), alphas, tg, tgp, gamma,
                                                    axis=REPLICA_AXIS))[0]
    one.close()
    vmap = asgd.normalized_merge(t(reps), alphas, tg, tgp, gamma)
    for k in reps:
        assert torch.equal(whole[k], vmap[k])


# --------------------------------------------------------------------------
# ShardWindowTimer
# --------------------------------------------------------------------------


class _Ticks:
    def __init__(self, values):
        self.values, self.i = list(values), 0

    def __call__(self):
        self.i += 1
        return self.values[self.i - 1]


def test_shard_window_timer_matches_reference():
    """The same marker calls on the same timer readings give the same
    windows; an incomplete set, a non-positive window and a window taken
    twice give None; the first start marker of a shard opens it."""
    ticks = [0.0, 0.5, 0.1, 1.0, 2.5, 0.7, 3.0, 4.0, 9.0, 9.0, 9.0]
    calls = [("reset", 3), ("start", 0), ("start", 1), ("start", 1), ("start", 2),
             ("end", 1), ("end", 0), ("end", 2), ("end", 2), "take", "take",
             ("reset", 2), ("start", 0), ("end", 0), "take",
             ("reset", 1), ("start", 0), ("end", 0), "take"]
    outs = []
    for cls in (ShardWindowTimer, JShardWindowTimer):
        timer, got = cls(timer=_Ticks(ticks)), []
        for c in calls:
            if c == "take":
                got.append(timer.take())
            elif c[0] == "reset":
                timer.reset(c[1])
            else:
                getattr(timer, f"mark_{c[0]}")(c[1])
        outs.append(got)
    port, ref = outs
    assert len(port) == len(ref) == 4
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[0], [2.5 - 0.0, 1.0 - 0.5, 3.0 - 0.1])
    assert port[1] is ref[1] is None and port[2] is ref[2] is None
    assert port[3] is ref[3] is None       # a zero window


# --------------------------------------------------------------------------
# the placement-aware tree helpers
# --------------------------------------------------------------------------


def test_tree_helpers_take_either_layout():
    rng = np.random.default_rng(1)
    whole = {"w": torch.from_numpy(rng.normal(size=(6, 3, 2)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(6, 2)).astype(np.float32))}
    sharded = tu.ShardedTree([{k: v[replica_block(6, 3, s)].clone() for k, v in whole.items()}
                              for s in range(3)])
    assert sharded.rows_per_block == 2 and tu.tree_size(sharded) == tu.tree_size(whole) == 48
    for i in range(6):
        for k in whole:
            assert torch.equal(tu.tree_replica_slice(sharded, i)[k], whole[k][i])
    filled = tu.tree_fill_rows(sharded, [1, 4], float("nan"))
    want = tu.tree_fill_rows(whole, [1, 4], float("nan"))
    for k in whole:
        assert torch.equal(filled.gather("cpu")[k].nan_to_num(7.0), want[k].nan_to_num(7.0))
        assert torch.isnan(want[k][[1, 4]]).all() and not torch.isnan(whole[k]).any()
        assert torch.equal(sharded.gather("cpu")[k], whole[k])


# --------------------------------------------------------------------------
# the kernel wrappers under threads
# --------------------------------------------------------------------------


class _YieldingCounters:
    """A kernel wrapper's counters whose reads hand the interpreter to
    another thread between the read and the write of an increment, as a
    preempted shard thread would."""

    def __init__(self):
        self._launches = self._no_momentum = 0

    def _get(self, name):
        value = getattr(self, name)
        time.sleep(1e-5)
        return value

    launches = property(lambda self: self._get("_launches"),
                        lambda self, v: setattr(self, "_launches", v))
    no_momentum_launches = property(lambda self: self._get("_no_momentum"),
                                    lambda self, v: setattr(self, "_no_momentum", v))


def test_launch_counters_lose_no_increment_across_threads():
    """The counter path every wrapper takes after a launch
    (``_build.count_launch``), from 8 threads at once: no increment is
    lost, though each read of a counter yields to another thread."""
    n_threads, n_calls = 8, 300
    counters = _YieldingCounters()

    def work():
        for i in range(n_calls):
            _build.count_launch(counters, no_momentum_launches=i % 2 == 0)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert counters.launches == n_threads * n_calls
    assert counters.no_momentum_launches == n_threads * n_calls // 2
    # every wrapper counts through it
    for wrapper in (merge_cuda, spmm_ops.spmm_cuda, spmm_ops.spmm_grad_w_cuda,
                    spmm_ops.sort_rows_cuda):
        assert "_build.count_launch(" in inspect.getsource(wrapper)


def test_library_builds_once_across_threads(monkeypatch):
    """The first ``library()`` from several threads at once builds and
    loads the kernels once (build and load are stubbed: no nvcc here)."""
    import types

    builds, loads = [], []

    def build():
        builds.append(1)
        time.sleep(0.05)            # a slow build: the others arrive meanwhile
        return "librepro_torch_stub.so"

    class Lib:
        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loads.append(path) or Lib())
    barrier = threading.Barrier(6)
    got = []

    def call():
        barrier.wait()
        got.append(_build.library())

    threads = [threading.Thread(target=call) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(builds) == len(loads) == 1 and _build.loaded()
    assert len(got) == 6 and all(lib is got[0] for lib in got)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def _model():
    return make_model(XMLMLPConfig(n_features=16, n_classes=4, hidden=8))


def test_sharded_trainer_refusals(monkeypatch):
    cfg = ElasticConfig(placement="sharded", n_replicas=6)
    with pytest.raises(ValueError, match="not divisible"):
        ElasticTrainer(_model(), provider=None, cfg=cfg, mesh=CPU4)
    with pytest.raises(ValueError, match="needs cfg.placement='sharded'"):
        ElasticTrainer(_model(), provider=None, cfg=ElasticConfig(), mesh=CPU4, device="cpu")
    with pytest.raises(ValueError, match="placement must be one of"):
        ElasticTrainer(_model(), provider=None, cfg=ElasticConfig(placement="pmap"),
                       device="cpu")
    tr = ElasticTrainer(_model(), provider=None, cfg=cfg, device="cpu")
    assert tr.mesh == (torch.device("cpu"),) and tr.device == torch.device("cpu")
    tr.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(_model(), provider=None, cfg=cfg)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

_XML = ["--workload", "xml", "--device", "cpu", "--replicas", "4", "--samples", "512",
        "--features", "256", "--classes", "64", "--avg-nnz", "16", "--hidden", "16",
        "--b-max", "16", "--mega-batch", "8"]


@pytest.mark.parametrize("schedule", [[], ["--elastic-schedule", "0:4,1:2"]])
def test_launcher_placement_sharded_on_the_cpu(schedule):
    """``--placement sharded --device cpu``: a size-1 CPU mesh (or, under
    an elastic schedule, the trainer's pool of that device), whose run is
    the vmap run's, record for record."""
    from repro_torch.launch import train

    runs = []
    for placement in ("vmap", "sharded"):
        state, mlog = train.main(_XML + schedule + ["--megabatches", "2",
                                                    "--placement", placement])
        runs.append(([{k: v for k, v in r.items() if not k.startswith("wall")}
                      for r in mlog.records], state))
    (vlog, vstate), (slog, sstate) = runs
    assert vlog == slog and isinstance(sstate.replicas, tu.ShardedTree)
    assert len(sstate.replicas.blocks) == 1
    for k, v in vstate.global_model.items():
        assert torch.equal(v, sstate.global_model[k])


def test_a_dropped_trainer_stops_its_shard_threads():
    """A sharded trainer that is not closed stops its worker threads when
    it is collected: no worker keeps its last call (and so the trainer and
    its tensors) alive."""
    import gc

    import torch_elastic_runs as E

    def shard_threads():
        return [t for t in threading.enumerate() if t.name.startswith("shard-")]

    before = len(shard_threads())
    tr, test = E.port_trainer("adaptive", mesh=CPU4)
    tr.run(1, test_batches=test)
    assert len(shard_threads()) == before + 4
    del tr
    gc.collect()
    assert len(shard_threads()) == before
