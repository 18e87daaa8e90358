"""Elastic membership in the port: the replica count changes between
mega-batches (``ElasticTrainer.resize``), held against a live reference
run from the same weights and data (``tests/torch_elastic_runs.py`` has
the runs, the scenario and the tolerance).

* ``adaptive`` (resize policy ``merge``), ``crossbow`` (``preserve``),
  ``sync`` (its own ``resize_b``) and ``single`` (every resize a no-op) on
  both gradient paths, under a grow-then-shrink schedule and a fault script
  with every fault kind: host decisions and the fleet log identical, the
  losses and global model within 1e-5, and the run's merges (counted at
  the weighted-merge op) equal to what its records and fleet log need;
* a constant schedule is bit-identical to the unscheduled run, for every
  algorithm;
* the pieces: ``parse_elastic_schedule``, the virtual clock, the speed
  model and the scheduler against the reference's, and the state a resize
  carries (momentum rows, joiners, copies instead of views, and global
  and prev_global holding the same tensors, which nothing writes in
  place).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_elastic_runs import merge_counter  # noqa: F401 (a fixture)
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.core import heterogeneity as jhet
from repro.core import scheduler as jsched
from repro.configs.base import ElasticConfig as JElasticConfig
from repro.launch.train import parse_elastic_schedule as jparse
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import algorithms
from repro_torch.core.heterogeneity import CostModel, SpeedModel, VirtualClock
from repro_torch.core.scheduler import DynamicScheduler
from repro_torch.launch.train import parse_elastic_schedule

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

# single has one replica: its script names slot 0, so the NaN reaches it
# (the guard restarts it from the last barrier) and the crash and
# preemption are refused at min_replicas
FAULTS_SINGLE = "1:nan:0,3:crash:0,3:stall:0,4:preempt:0:1,6:join"
CASES = [(a, sparse) for a in ("adaptive", "crossbow", "sync", "single")
         for sparse in (True, False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'sparse' if c[1] else 'dense'}")
def test_schedule_and_faults_match_reference(case, merge_counter):
    algo, sparse = case
    faults = FAULTS_SINGLE if algo == "single" else E.FAULTS
    port_run = E.run_port(algo, sparse=sparse, faults=faults)
    E.assert_runs_match(port_run, E.run_ref(algo, sparse=sparse, faults=faults))
    _, mlog, events = port_run
    actions = {e["action"] for e in events}
    if algo != "single":
        assert {"nan", "evict", "stall", "stall_recovered", "rejoin", "join"} <= actions
        assert [r["n_replicas"] for r in mlog.records] == [4, 4, 6, 5, 4, 5, 6]
    assert any("guard_repaired" in r for r in mlog.records)
    n_leaves = len(E.init_np())
    assert len(merge_counter) == n_leaves * E.merge_calls(mlog, events, E.SCHEDULE, algo)


@pytest.mark.parametrize("algo", algorithms.available())
def test_constant_schedule_bit_identical(algo):
    """A schedule whose every entry is the current R changes nothing: the
    records (but their wall times) and the final state are exactly the
    unscheduled run's."""
    runs = [E.run_port(algo, n_mb=3, schedule=schedule, faults=None)
            for schedule in (None, {0: 4, 1: 4, 2: 4})]
    (s0, m0, _), (s1, m1, _) = runs
    drop = ("wall_clock", "wall_s")
    assert ([{k: v for k, v in r.items() if k not in drop} for r in m0.records]
            == [{k: v for k, v in r.items() if k not in drop} for r in m1.records])
    for k in s0.global_model:
        assert torch.equal(s0.global_model[k], s1.global_model[k])
        assert torch.equal(s0.replicas[k], s1.replicas[k])


# --------------------------------------------------------------------------
# the pieces, against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["0:4,20:6,40:3", "40:3, 0:4", "5:2,5:3", "0:1,"])
def test_parse_elastic_schedule_matches_reference(spec):
    assert parse_elastic_schedule(spec) == jparse(spec)


@pytest.mark.parametrize("bad", ["", "x", "1", "1:", ":2", "1:0", "-1:2"])
def test_parse_elastic_schedule_rejects(bad):
    with pytest.raises(ValueError):
        jparse(bad)
    with pytest.raises(ValueError):
        parse_elastic_schedule(bad)


def test_virtual_clock_resize_and_permute_match_reference():
    clocks = VirtualClock(4), jhet.VirtualClock(4)
    for c in clocks:
        c.t[:] = [1.0, 3.0, 2.0, 0.5]
        c.permute([2, 0, 3, 1])
        c.resize(6)                 # joiners at the latest survivor time
        c.resize(5)
    np.testing.assert_array_equal(clocks[0].t, clocks[1].t)
    np.testing.assert_array_equal(clocks[0].t, [2.0, 1.0, 0.5, 3.0, 3.0])
    assert clocks[0].n_replicas == 5


def test_speed_model_resize_permute_and_state_match_reference():
    port, ref = SpeedModel(5, seed=3), jhet.SpeedModel(5, seed=3)
    for m in (port, ref):
        m.permute([4, 3, 2, 1, 0])
        m.resize(3)                 # shrink: the fastest survivor renormalized to 1.0
        m.resize(6)                 # joiners at the prior 1.0
        m.step_factor(0)
    np.testing.assert_array_equal(port.factors, ref.factors)
    sd = port.state_dict()
    assert sd["meta"] == ref.state_dict()["meta"]
    draws = [port.step_factor(i) for i in range(6)]
    other = SpeedModel(2, seed=9)
    other.load_state_dict(sd)
    ref.load_state_dict(sd)         # the port's state restores into the reference's
    assert other.n_replicas == ref.n_replicas == 6
    assert [other.step_factor(i) for i in range(6)] == draws == [
        ref.step_factor(i) for i in range(6)]


def test_scheduler_resize_plans_new_population():
    cfgs = (ElasticConfig.from_bmax(32, n_replicas=4, mega_batch=10),
            JElasticConfig.from_bmax(32, n_replicas=4, mega_batch=10))
    plans = []
    for cfg, cls, het in ((cfgs[0], DynamicScheduler, None), (cfgs[1], jsched.DynamicScheduler,
                                                               jhet)):
        speed = (het.SpeedModel if het else SpeedModel)(4, seed=1)
        sched = cls(cfg, (het.CostModel if het else CostModel)(speed))
        sched.plan_megabatch(np.full(4, 32), 320)
        speed.resize(6)
        sched.resize(cfg.__class__.from_bmax(32, n_replicas=6, mega_batch=10))
        plans.append(sched.plan_megabatch(np.full(6, 32), 320))
        assert sched.clock.n_replicas == 6 and sched.cfg.n_replicas == 6
    np.testing.assert_array_equal(plans[0].u, plans[1].u)
    assert len(plans[0].u) == 6


# --------------------------------------------------------------------------
# what a resize carries
# --------------------------------------------------------------------------


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("algo", ["adaptive", "crossbow"])
def test_grow_then_shrink_carries_state(algo):
    """Survivors keep their momentum rows (crossbow: their parameters
    too), joiners start from the merged global with zero momentum; after a
    shrink every leaf is a copy that owns exactly its rows, never a view
    that keeps the leavers' memory alive."""
    tr, _ = E.port_trainer(algo, momentum=0.9)
    state, _ = tr.run_megabatch(tr.init_state())
    old_reps = {k: v.clone() for k, v in state.replicas.items()}
    old_mom = {k: v.clone() for k, v in state.momentum.items()}
    grown = tr.resize(state, 6)
    assert tr.cfg.n_replicas == 6 and len(grown.b) == 6
    for k, v in grown.momentum.items():
        assert torch.equal(v[:4], old_mom[k]) and not v[4:].any()
    for k, v in grown.replicas.items():
        assert torch.equal(v[4], grown.global_model[k]) and torch.equal(v[5], v[4])
        if algo == "crossbow":
            assert torch.equal(v[:4], old_reps[k])
        else:
            assert all(torch.equal(v[i], grown.global_model[k]) for i in range(4))

    shrunk = tr.resize(grown, 3)
    assert tr.cfg.n_replicas == 3 and len(shrunk.lr) == 3
    for tree, before in ((shrunk.replicas, grown.replicas), (shrunk.momentum, grown.momentum)):
        for k, v in tree.items():
            assert v.shape[0] == 3 and not _shares_storage(v, before[k])
            assert v.untyped_storage().nbytes() == v.numel() * v.element_size()


def test_merged_global_is_shared_and_never_written():
    """After a resize, global_model and prev_global hold the same tensors
    (as the reference's hold one array); a mega-batch, a guard repair and a
    further resize leave them exactly as they were."""
    tr, _ = E.port_trainer("adaptive", momentum=0.9)
    state = tr.resize(tr.init_state(), 5)
    assert all(state.global_model[k] is state.prev_global[k] for k in state.global_model)
    kept = {k: v.clone() for k, v in state.global_model.items()}
    merged = state.global_model
    state.replicas["w1"][2] = float("nan")
    state, info = tr.run_megabatch(state)
    assert info["guard_repaired"] == [2]
    tr.resize(state, 3)
    for k, v in merged.items():
        assert torch.equal(v, kept[k])


def test_resize_refusals_and_no_ops():
    tr, _ = E.port_trainer("elastic")
    state = tr.init_state()
    assert tr.resize(state, 4) is state
    with pytest.raises(ValueError):
        tr.resize(state, 0)
    single, _ = E.port_trainer("single")
    state = single.init_state()
    assert single.resize(state, 4) is state and single.cfg.n_replicas == 1


def test_sync_resize_rederives_equal_shares():
    tr, _ = E.port_trainer("sync")
    state, _ = tr.run_megabatch(tr.init_state())
    np.testing.assert_array_equal(state.b, np.full(4, E.B_MAX // 4))
    state = tr.resize(state, 2)
    np.testing.assert_array_equal(state.b, np.full(2, E.B_MAX // 2))
    np.testing.assert_allclose(state.lr, E.LR * state.b / E.B_MAX)


@pytest.mark.parametrize("bad", [{-1: 2}, {"3": 4, 3: 6}, {2: 0}, {1.5: 2}])
def test_resize_schedule_validation_matches_reference(bad):
    tr, _ = E.port_trainer("adaptive")
    jtr, _ = E.ref_trainer("adaptive")
    with pytest.raises(ValueError):
        jtr._validate_resize_schedule(bad)
    with pytest.raises(ValueError):
        tr._validate_resize_schedule(bad)
    good = {"0": 4, 3: 2.0, 7: 6}
    assert tr._validate_resize_schedule(good) == jtr._validate_resize_schedule(good)


# --------------------------------------------------------------------------
# a resize and the overlap pipeline's prefetch
# --------------------------------------------------------------------------


def test_resize_invalidates_pending_prefetch():
    """A resize at the boundary revokes the plan staged for the old
    population and rolls the cursors back, as the reference's does:
    continuing at the new width matches a run that never prefetched, and
    the reference's run after its own revocation."""
    def go(prefetch):
        tr, _ = E.port_trainer("adaptive")
        tr.overlap = prefetch
        state, _ = tr.run_megabatch(tr.init_state(), prefetch=prefetch)
        assert (tr._staged is not None) == prefetch
        state = tr.resize(state, 6)
        assert tr._staged is None
        state, info = tr.run_megabatch(state)
        return tr, state, info

    (tr_p, s_p, info_p), (tr_s, s_s, info_s) = go(True), go(False)
    assert info_p == info_s
    assert tr_p.provider.state_dict() == tr_s.provider.state_dict()
    np.testing.assert_array_equal(tr_p.scheduler.clock.t, tr_s.scheduler.clock.t)
    for k in s_p.global_model:
        assert torch.equal(s_p.global_model[k], s_s.global_model[k])
    jtr, _ = E.ref_trainer("adaptive")
    j_state, _ = jtr.run_megabatch(jtr.init_state(), prefetch=True)
    j_state, j_info = jtr.run_megabatch(jtr.resize(j_state, 6))
    for k in E.EXACT:
        assert info_p[k] == j_info[k], k
    assert tr_p.provider.state_dict() == jtr.provider.state_dict()
    np.testing.assert_array_equal(tr_p.scheduler.clock.t, jtr.scheduler.clock.t)


def test_constant_schedule_keeps_prefetch():
    """A resize to the current R is a no-op boundary: the staged plan
    survives it (the constant schedule's bit-identity is held above)."""
    tr, _ = E.port_trainer("adaptive")
    state, _ = tr.run_megabatch(tr.init_state(), prefetch=True)
    staged = tr._staged
    assert staged is not None
    assert tr.resize(state, tr.cfg.n_replicas) is state
    assert tr._staged is staged
