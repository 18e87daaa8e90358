"""The overlapped mega-batch pipeline in the port (``ElasticTrainer(overlap=
True)``, the default): mega-batch N+1 is planned, packed into a staging
slot and uploaded while N runs, and evaluation is issued at a boundary and
collected at the next.

* bit-identity — on the CPU the pipelined run equals the sequential one
  (``overlap=False``) exactly: records, evaluation metrics, virtual time,
  the final global model, replicas, momentum, b and lr; for every
  registered algorithm without and with SGD momentum, with evaluation
  after every mega-batch; and for the LM through ``TokenProvider``;
* the reference — the pipelined port against a live reference run with its
  own pipeline on (host decisions exact, losses and global model within
  rtol 1e-5 / atol 1e-6: ``tests/torch_elastic_runs.py``), XML and LM, and
  a ``merge_cost`` other than the default;
* staging — the port's fused ``stack_lazy_plan`` is byte-equal to the
  reference's and to the port's eager pack; ``StagingBuffers`` alternate,
  come back zeroed, latch, and grow their leading dim in powers of two;
* the prefetch's life — ports of the reference's ``tests/test_overlap.py``:
  no staged plan is left by default, ``invalidate_prefetch`` rolls the
  provider, clocks and speed model back to the reference's cursors, the
  snapshot holds the sample order as an array the live stream cannot
  touch (and the LM provider's is a copy of its RNG state), a stale plan
  is discarded, turning overlap off consumes one safely, and
  ``evaluate_async`` and ``run``'s backfill agree with the sequential
  evaluation.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
import torch_lm_runs as L
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.batcher import StagingBuffers as JStagingBuffers
from repro.data.batcher import stack_lazy_plan as jstack_lazy_plan
from repro.data.providers import SparseProvider as JSparseProvider
from repro.data.providers import TokenProvider as JTokenProvider
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro.models import model as JMDL
from repro_torch.core import algorithms
from repro_torch.core.trainer import MERGE_COST, ElasticTrainer
from repro_torch.data.batcher import StagingBuffers, stack_lazy_plan
from repro_torch.data.providers import SparseProvider, TokenProvider
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.models import model as MDL
from repro_torch.models.protocol import TrainableModel
from repro_torch.utils import tree as tu

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

N_MB = 3
WALL = ("wall_clock", "wall_s")


def _strip(records):
    return [{k: v for k, v in r.items() if k not in WALL} for r in records]


def _trainer(algo="adaptive", overlap=True, momentum=0.0):
    tr, test = E.port_trainer(algo, momentum=momentum)
    tr.overlap = overlap
    return tr, test


def _assert_same_state(a, b):
    np.testing.assert_array_equal(a.b, b.b)
    np.testing.assert_array_equal(a.lr, b.lr)
    assert a.megabatch_idx == b.megabatch_idx
    for name in ("replicas", "global_model", "prev_global", "momentum"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert (ta is None) == (tb is None), name
        for k in (ta or {}):
            assert torch.equal(ta[k], tb[k]), (name, k)


# --------------------------------------------------------------------------
# bit-identity: the pipelined run against the sequential one
# --------------------------------------------------------------------------

CASES = [(a, m) for m in (0.0, 0.9) for a in algorithms.available()]


@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: f"{c[0]}-scan" + ("-momentum" if c[1] else ""))
def test_overlap_bit_identical(case):
    """run(overlap on) == run(overlap off) on the CPU, evaluation after
    every mega-batch (``momentum`` > 0 keeps SGD momentum buffers)."""
    algo, momentum = case
    runs = []
    for overlap in (True, False):
        tr, test = _trainer(algo, overlap, momentum)
        state, mlog = tr.run(N_MB, test_batches=test, eval_every=1)
        assert tr._staged is None                       # run leaves nothing staged
        runs.append((state, mlog.records))
    (s_on, r_on), (s_off, r_off) = runs
    assert _strip(r_on) == _strip(r_off)
    assert all("accuracy" in r and "test_loss" in r for r in r_on)
    _assert_same_state(s_on, s_off)


def test_token_provider_overlap_bit_identical_and_matches_reference():
    """The LM path (reduced tinyllama, f32, Adaptive SGD) through
    ``TokenProvider``'s staging: on == off bitwise, and the pipelined run
    held to the reference's (its pipeline on) within the f32 LM tolerance
    of ``tests/torch_lm_runs.py``."""
    _, tcfg = L.configs("tinyllama-1.1b")
    p0 = L.init_np("tinyllama-1.1b")

    def port_run(overlap):
        model = TrainableModel(init=lambda generator: tu.flatten(MDL.params_from_jax(p0, "cpu")),
                               loss_fn=MDL.make_model(tcfg).loss_fn, config=tcfg)
        prov = TokenProvider.make(tcfg.vocab_size, L.SEQ, seed=0)
        test = prov.test_batches(2, L.B_MAX)
        tr = ElasticTrainer(model, prov, L._elastic(L.ElasticConfig, "adaptive"),
                            base_lr=L.LR, seed=0, device="cpu", overlap=overlap)
        return tr.run(L.N_MB, test_batches=test)

    on, off = port_run(True), port_run(False)
    assert _strip(on[1].records) == _strip(off[1].records)
    _assert_same_state(on[0], off[0])
    jcfg, _ = L.configs("tinyllama-1.1b")
    prov = JTokenProvider.make(jcfg.vocab_size, L.SEQ, seed=0)
    jtr = JTrainer(JMDL.make_model(jcfg), prov, L._elastic(L.JElasticConfig, "adaptive"),
                   base_lr=L.LR, seed=0, overlap=True)
    L.assert_runs_match(on, jtr.run(L.N_MB, test_batches=prov.test_batches(2, L.B_MAX)),
                        L.F32_TOL)


# --------------------------------------------------------------------------
# the pipelined port against the pipelined reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("merge_cost", [MERGE_COST, 0.02])
def test_overlap_matches_reference(merge_cost):
    """Adaptive SGD, both pipelines on, evaluation after every mega-batch,
    at the default merge cost and another: host decisions exact, losses
    and the global model within rtol 1e-5 / atol 1e-6."""
    tr, test = _trainer()
    jtr, jtest = E.ref_trainer("adaptive")
    tr.merge_cost = jtr.merge_cost = merge_cost
    assert tr.overlap and jtr.overlap
    port_run = E.run_port("adaptive", n_mb=N_MB, schedule=None, faults=None,
                          trainer=(tr, test), eval_every=1)
    ref_run = E.run_ref("adaptive", n_mb=N_MB, schedule=None, faults=None,
                        trainer=(jtr, jtest), eval_every=1)
    E.assert_runs_match(port_run, ref_run, n_mb=N_MB)
    # two merges' worth of cost: the clock moved by the field, not the constant
    vt = [r["virtual_time"] for r in port_run[1].records]
    if merge_cost != MERGE_COST:
        default, _ = _trainer()
        _, dlog, _ = E.run_port("adaptive", n_mb=2, schedule=None, faults=None,
                                trainer=(default, test))
        assert vt[1] - dlog.records[1]["virtual_time"] == pytest.approx(
            2 * (merge_cost - MERGE_COST))


# --------------------------------------------------------------------------
# staging
# --------------------------------------------------------------------------


def _lazy_grids(b_slots=16):
    """The same fetches through the port's and the reference's providers
    (lazy) and the port's (eager); returns the three grids."""
    kw = dict(n_samples=400, n_features=300, n_classes=40, avg_nnz=24, seed=5)
    port, ref, eager = (SparseProvider.make(make_xml_dataset(**kw), seed=9),
                        JSparseProvider.make(jax_make_dataset(**kw), seed=9),
                        SparseProvider.make(make_xml_dataset(**kw), seed=9))
    grids = ([], [], [])
    for takes in ((8, 3, 0), (16, 0, 16), (5, 16, 1), (0, 0, 7)):
        rows = ([], [], [])
        for t in takes:
            if t == 0:
                for row in rows:
                    row.append(None)
                continue
            p, work = port.fetch_staged(t, b_slots)
            jp, jwork = ref.fetch_staged(t, b_slots)
            e = eager.fetch(t, b_slots)
            assert work == jwork == eager.work_units(e)
            np.testing.assert_array_equal(p.ids, jp.ids)
            for row, payload in zip(rows, (p, jp, e)):
                row.append(payload)
        for grid, row in zip(grids, rows):
            grid.append(row)
    assert port.state_dict() == eager.state_dict() == ref.state_dict()
    return (port, ref, eager), grids


def test_stack_lazy_plan_matches_reference_and_eager():
    """The fused gather, packed into a staging slot's numpy views, is
    byte-equal to the reference's fused gather (into its own slot) and to
    the port's per-sample pack."""
    b_slots = 16
    (port, ref, eager), (grid, jgrid, egrid) = _lazy_grids(b_slots)
    n_rounds, R = len(grid), len(grid[0])
    _, slot = StagingBuffers().acquire(port.staging_spec(n_rounds, R, b_slots))
    got, mask = port.stack_plan(grid, b_slots, out={k: v.numpy() for k, v in slot.items()})
    _, jslot = JStagingBuffers().acquire(ref.staging_spec(n_rounds, R, b_slots))
    want, jmask = ref.stack_plan(jgrid, b_slots, out=jslot)
    eager_arrays, emask = eager.stack_plan(egrid, b_slots)
    plain = stack_lazy_plan(port.batcher.ds, grid, b_slots, port.batcher.max_nnz,
                            port.batcher.max_labels)
    jplain = jstack_lazy_plan(ref.batcher.ds, jgrid, b_slots, ref.batcher.max_nnz,
                              ref.batcher.max_labels)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(mask, emask)
    assert set(got) == set(want) == set(eager_arrays) == set(plain)
    for k in got:
        for other in (want, eager_arrays, plain, jplain):
            assert got[k].dtype == other[k].dtype and got[k].shape == other[k].shape, k
            assert got[k].tobytes() == other[k].tobytes(), k
        # the slot's torch tensors hold what the packer wrote
        assert slot[k].numpy().tobytes() == got[k].tobytes(), k


SPEC = {"x": ((3, 2), np.float32), "m": ((3,), bool)}


def test_staging_buffers_alternate_and_zero():
    bufs = StagingBuffers()
    k0, s0 = bufs.acquire(SPEC)
    s0["x"].fill_(7.0)
    s0["m"].fill_(True)
    k1, s1 = bufs.acquire(SPEC)
    assert k0 != k1 and s1["x"].data_ptr() != s0["x"].data_ptr()
    bufs.release(k0)
    k2, s2 = bufs.acquire(SPEC)      # slot 0 again, zeroed in place
    assert k2 == k0 and s2["x"].data_ptr() == s0["x"].data_ptr()
    assert not s2["x"].any() and not s2["m"].any()
    assert s2["x"].dtype == torch.float32 and s2["m"].dtype == torch.bool
    assert not s2["x"].is_pinned()   # pinned only for a CUDA trainer
    assert bufs.allocations == 2


def test_staging_buffers_busy_latch():
    bufs = StagingBuffers()
    k0, _ = bufs.acquire(SPEC)
    bufs.acquire(SPEC)
    with pytest.raises(RuntimeError, match="in flight"):
        bufs.acquire(SPEC)           # both slots staged, none collected
    bufs.release(k0)
    assert bufs.acquire(SPEC)[0] == k0   # released: slot 0 is free again


def test_staging_buffers_capacity_views_and_reallocation():
    """The leading dim is allocated at a power-of-two capacity: fewer rows
    reuse the slot through a view of the first rows, more rows than the
    capacity, another trailing shape, dtype or name set reallocate."""
    bufs = StagingBuffers()

    def acquire(n, h=2, dt=np.float32, names=("x", "m")):
        spec = {"x": ((n, h), dt), "m": ((n,), bool)}
        spec = {k: spec.get(k, ((n,), np.int32)) for k in names}
        k, views = bufs.acquire(spec)
        k1, _ = bufs.acquire(spec)   # the other slot, so the next call sees slot k
        bufs.release(k)
        bufs.release(k1)
        return views

    v = acquire(5)
    assert v["x"].shape == (5, 2) and v["m"].shape == (5,)
    base = v["x"]._base if v["x"]._base is not None else v["x"]
    assert base.shape == (8, 2) and v["x"].is_contiguous()
    before = bufs.allocations
    for n in (3, 8, 6):              # within the capacity of 8: views, no allocation
        assert acquire(n)["x"].shape == (n, 2)
    assert bufs.allocations == before
    assert acquire(9)["x"]._base.shape == (16, 2)        # grew to the next power of two
    assert bufs.allocations == before + 2
    for change in (dict(h=3), dict(dt=np.int32), dict(names=("x", "m", "y"))):
        before = bufs.allocations
        views = acquire(4, **change)
        assert bufs.allocations == before + 2, change
        assert views["x"].shape[1] == change.get("h", 2)


# --------------------------------------------------------------------------
# the prefetch's life (ports of the reference's tests/test_overlap.py)
# --------------------------------------------------------------------------


def test_prefetch_leaves_no_dangling_state_by_default():
    tr, _ = _trainer()
    state, _ = tr.run_megabatch(tr.init_state())     # prefetch not requested
    assert tr._staged is None


def test_invalidate_prefetch_rolls_cursors_back_as_the_reference():
    """Staging advances the provider, clocks and speed model past the
    sequential oracle's; revocation restores them exactly, to the
    reference's cursors after its own revocation, and the continued run
    matches the oracle bit for bit."""
    tr, _ = _trainer()
    oracle, _ = _trainer(overlap=False)
    jtr, _ = E.ref_trainer("adaptive")
    state, o_state, j_state = tr.init_state(), oracle.init_state(), jtr.init_state()
    state, _ = tr.run_megabatch(state, prefetch=True)
    o_state, _ = oracle.run_megabatch(o_state)
    j_state, _ = jtr.run_megabatch(j_state, prefetch=True)
    assert tr._staged is not None and jtr._staged is not None
    assert tr.provider.state_dict() != oracle.provider.state_dict()
    assert tr.provider.state_dict() == jtr.provider.state_dict()   # staged alike
    tr.invalidate_prefetch()
    jtr.invalidate_prefetch()
    assert tr._staged is None
    for other in (oracle, jtr):
        assert tr.provider.state_dict() == other.provider.state_dict()
        np.testing.assert_array_equal(tr.scheduler.clock.t, other.scheduler.clock.t)
        assert repr(tr.speed.state_dict()) == repr(other.speed.state_dict())
    state, info = tr.run_megabatch(state, prefetch=False)
    o_state, o_info = oracle.run_megabatch(o_state)
    assert _strip([info]) == _strip([o_info])
    _assert_same_state(state, o_state)


def test_prefetch_snapshot_holds_an_order_array_the_stream_cannot_touch():
    """The staged plan's cursor snapshot holds the sample order as an int64
    array (not the ``state_dict`` list), equal to the sequential oracle's
    order at the same point; the live stream running on past an epoch end
    (a reshuffle) leaves it intact, and ``invalidate_prefetch`` from it
    replays the oracle's sample ids and mega-batch, and the reference's
    after its own revocation."""
    tr, _ = _trainer()
    oracle, _ = _trainer(overlap=False)
    jtr, _ = E.ref_trainer("adaptive")
    state, o_state, j_state = tr.init_state(), oracle.init_state(), jtr.init_state()
    state, _ = tr.run_megabatch(state, prefetch=True)
    o_state, _ = oracle.run_megabatch(o_state)
    j_state, _ = jtr.run_megabatch(j_state, prefetch=True)
    snap = tr._staged.snapshot["provider"]["stream"]
    o_stream = oracle.provider.batcher.stream
    assert type(snap["order"]) is np.ndarray and snap["order"].dtype == np.int64
    np.testing.assert_array_equal(snap["order"], o_stream.order)
    want = {k: v.copy() if k == "order" else v for k, v in snap.items()}
    live = tr.provider.batcher.stream
    assert not np.shares_memory(snap["order"], live.order)
    epoch = live.epoch
    live.take(live.n + 1)                             # past an epoch end: reshuffled
    assert live.epoch == epoch + 1 and live.order is not snap["order"]
    assert snap["pos"] == want["pos"] and snap["epoch"] == want["epoch"]
    assert snap["rng"] == want["rng"]
    np.testing.assert_array_equal(snap["order"], want["order"])
    tr.invalidate_prefetch()
    jtr.invalidate_prefetch()
    for other in (oracle, jtr):
        assert tr.provider.state_dict() == other.provider.state_dict()
    state, info = tr.run_megabatch(state, prefetch=False)
    o_state, o_info = oracle.run_megabatch(o_state)
    j_state, j_info = jtr.run_megabatch(j_state, prefetch=False)
    assert _strip([info]) == _strip([o_info])
    _assert_same_state(state, o_state)
    for k in E.EXACT:
        assert info[k] == j_info[k], k
    np.testing.assert_allclose(info["train_loss"], j_info["train_loss"], **E.TOL)
    # the streams then draw the same ids, across the next epoch end too
    n = o_stream.n + 1
    ids = tr.provider.batcher.stream.take(n)
    np.testing.assert_array_equal(ids, o_stream.take(n))
    np.testing.assert_array_equal(ids, jtr.provider.batcher.stream.take(n))


def test_token_provider_cursor_is_its_state_dict_apart_from_the_stream():
    """The LM provider's snapshot cursor is its ``state_dict`` (the
    stream's RNG state), a copy the stream's further draws do not move."""
    prov = TokenProvider.make(64, 8, seed=3)
    prov.fetch(4, 4)
    cur = prov.cursor()
    assert cur == prov.state_dict() and cur["rng"] is not prov.state_dict()["rng"]
    before = repr(cur)
    drawn = prov.fetch(4, 4)
    assert repr(cur) == before and cur != prov.state_dict()
    prov.load_state_dict(cur)
    again = prov.fetch(4, 4)
    for k in drawn:
        np.testing.assert_array_equal(drawn[k], again[k])


def test_stale_prefetch_discarded_on_mismatch():
    """A staged plan that no longer matches (b, lr) is planned again, from
    rolled-back cursors: the mega-batch equals the sequential oracle's on
    the same mutated state."""
    tr, _ = _trainer()
    oracle, _ = _trainer(overlap=False)
    state, o_state = tr.init_state(), oracle.init_state()
    state, _ = tr.run_megabatch(state, prefetch=True)
    o_state, _ = oracle.run_megabatch(o_state)
    assert tr._staged is not None
    for s in (state, o_state):                        # out-of-band mutation
        s.b = s.b * 0 + float(tr.cfg.b_min)
        s.lr = s.lr * 0 + 0.125
    state, info = tr.run_megabatch(state)
    o_state, o_info = oracle.run_megabatch(o_state)
    assert tr._staged is None
    assert _strip([info]) == _strip([o_info])
    _assert_same_state(state, o_state)


def test_overlap_off_consumes_stale_prefetch_safely():
    """Turning overlap off between calls rolls the prefetch back."""
    tr, _ = _trainer()
    oracle, _ = _trainer(overlap=False)
    state, o_state = tr.init_state(), oracle.init_state()
    state, _ = tr.run_megabatch(state, prefetch=True)
    o_state, _ = oracle.run_megabatch(o_state)
    tr.overlap = False
    for _ in range(2):
        state, info = tr.run_megabatch(state)
        o_state, o_info = oracle.run_megabatch(o_state)
        assert _strip([info]) == _strip([o_info])
    assert tr._staging._busy == [False, False]        # the slot was released
    _assert_same_state(state, o_state)


def test_evaluate_async_equals_evaluate():
    """Issued before a mega-batch and collected after it, the evaluation
    equals the sequential one; the test set is uploaded once and re-staged
    only for another list."""
    tr, test = _trainer()
    state, _ = tr.run_megabatch(tr.init_state())
    params = {k: v.clone() for k, v in state.global_model.items()}
    sync = tr.evaluate(params, test)
    staged = tr._eval_batches
    collect = tr.evaluate_async(params, test)
    assert tr._eval_batches is staged
    state, _ = tr.run_megabatch(state)                # runs behind the evaluation
    assert collect() == sync
    assert tr.evaluate(params, list(test)) == sync    # a new list: staged again
    assert tr._eval_batches is not staged


def test_run_backfills_every_due_record():
    """eval_every=2 over 5 mega-batches: the evaluation, collected one
    boundary late, lands in the records of mega-batches 2 and 4, as the
    sequential run's does."""
    logs = []
    for overlap in (True, False):
        tr, test = _trainer(overlap=overlap)
        _, mlog = tr.run(5, test_batches=test, eval_every=2)
        logs.append(mlog.records)
    due = [i for i, r in enumerate(logs[0]) if "accuracy" in r]
    assert due == [1, 3]
    assert all(np.isfinite(logs[0][i]["accuracy"]) for i in due)
    assert _strip(logs[0]) == _strip(logs[1])


def test_staging_log_and_slots_in_a_run():
    """Each staged mega-batch logs its host seconds and bytes; after the
    first two mega-batches no slot is allocated again."""
    tr, test = _trainer()
    allocations = []

    class Probe:
        def maybe_save(self, trainer, state):
            allocations.append(trainer._staging.allocations)

        def wait(self):
            pass

    _, mlog = tr.run(4, test_batches=test, checkpoint=Probe())
    assert allocations[1] == allocations[-1] == 2
    log = list(tr.staging_log)
    assert [e["megabatch"] for e in log] == [0, 1, 2, 3]
    R, B = tr.cfg.n_replicas, tr.cfg.b_max
    # a round: the provider's fields and the update mask; then the (R,) lrs
    per_round = sum(int(np.prod(shape[1:])) * np.dtype(dt).itemsize
                    for shape, dt in tr.provider.staging_spec(1, R, B).values()) + 4 * R
    for e, rec in zip(log, mlog.records):
        assert min(e["plan_s"], e["pack_s"], e["upload_s"]) >= 0
        assert e["bytes"] == rec["n_rounds"] * per_round + 4 * R
