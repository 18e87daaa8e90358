"""Fault handling in the port: the fault injector, the fleet controller,
targeted eviction (``remove_replicas``) and the non-finite guard, held
against the reference's (``tests/torch_elastic_runs.py`` has the runs, the
scenario and the tolerance).

* the ``--faults`` parser and the injector's event stream equal the
  reference's;
* eviction moves every per-replica array with its replica, as the
  reference's does, and a crashed replica never reaches the merge;
* live runs against the reference, with host decisions, the fleet log,
  losses and model held as in ``test_torch_resize.py``: the scripted
  scenario on the sequential path (``overlap=False``), the timeout
  detector, a floor and ceiling on the population, and a seeded
  probabilistic fault stream, with the run's merges counted at the
  weighted-merge op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_elastic_runs import merge_counter  # noqa: F401 (a fixture)
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.core import fleet as jfleet
from repro_torch.core.fleet import FaultEvent, FaultInjector, parse_fault_spec

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

SPECS = [
    "seed=7,p_crash=0.25,3:crash:1,5:join,7:nan:0,9:stall:2:4",
    "1:nan:2,3:crash:1,3:stall:0,4:preempt:2:1,6:join",
    "seed=3,p_preempt=0.5,p_stall=0.1,p_nan=0.05,2:preempt::3",
    "",
]
RANDOM = "seed=3,p_crash=0.3,p_preempt=0.2,p_join=0.35,p_stall=0.25,p_nan=0.15"


def _events(inj, mbs=range(24), n_replicas=5):
    return [[(e.kind, e.replica, e.duration, e.severity) for e in inj.events_for(mb, n_replicas)]
            for mb in mbs]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_reference(spec):
    port, ref = parse_fault_spec(spec), jfleet.parse_fault_spec(spec)
    for k in ("seed", "p_crash", "p_preempt", "p_join", "p_stall", "p_nan"):
        assert getattr(port, k) == getattr(ref, k), k
    assert sorted(port.schedule) == sorted(ref.schedule)
    assert _events(port) == _events(ref)


@pytest.mark.parametrize("bad", [
    "p_bogus=1", "x:crash", "3:meteor", "-1:crash:0", "3", "3:crash:0:0",
])
def test_parse_fault_spec_rejects(bad):
    with pytest.raises(ValueError):
        jfleet.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        parse_fault_spec(bad)


def test_injector_is_history_free_and_matches_reference():
    kw = dict(seed=11, p_crash=0.4, p_preempt=0.2, p_join=0.5, p_stall=0.3, p_nan=0.1)
    port, ref = FaultInjector(**kw), jfleet.FaultInjector(**kw)
    seq = _events(port)
    assert seq == _events(ref) and any(seq)
    # queried out of order, or at another width, the draws do not move
    assert _events(port, reversed(range(24)))[::-1] == seq
    assert [[e[0] for e in mb] for mb in _events(port, n_replicas=2)] == [
        [e[0] for e in mb] for mb in seq]
    with pytest.raises(ValueError):
        FaultEvent("meteor")
    with pytest.raises(ValueError):
        FaultEvent("stall", 0, duration=0)


# --------------------------------------------------------------------------
# targeted eviction
# --------------------------------------------------------------------------


def _diverged(tr, rows):
    """The trainer's initial state with replica-distinct rows and host
    arrays (crossbow keeps them apart: ``preserve``)."""
    state = tr.init_state()
    g = torch.Generator().manual_seed(5)
    reps = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in state.replicas.items()}
    mom = {k: torch.randn(v.shape, generator=g) for k, v in state.momentum.items()}
    state = dataclasses.replace(state, replicas=reps, momentum=mom,
                                b=np.asarray(rows[0], np.float64),
                                lr=np.asarray(rows[1], np.float64))
    tr.speed.factors[:] = rows[2]
    tr.scheduler.clock.t[:] = rows[3]
    return state


@pytest.mark.parametrize("merge_leavers", [True, False], ids=["preempt", "crash"])
def test_remove_replicas_matches_reference(merge_leavers):
    """Every per-replica array moves with its replica (survivors first),
    then the population shrinks through ``resize``; the port's state and
    host arrays equal the reference's, fed the same rows."""
    rows = ([10.0, 20.0, 30.0, 40.0], [0.1, 0.2, 0.3, 0.4], [1.0, 1.1, 1.2, 1.3],
            [5.0, 6.0, 7.0, 8.0])
    tr, _ = E.port_trainer("crossbow", momentum=0.9)
    jtr, _ = E.ref_trainer("crossbow", momentum=0.9)
    state = _diverged(tr, rows)
    jstate = dataclasses.replace(
        jtr.init_state(),
        replicas={k: v.numpy() for k, v in state.replicas.items()},
        momentum={k: v.numpy() for k, v in state.momentum.items()},
        b=state.b.copy(), lr=state.lr.copy())
    jtr.speed.factors[:] = rows[2]
    jtr.scheduler.clock.t[:] = rows[3]
    jstate = jtr.remove_replicas(jstate, [1, 2] if merge_leavers else [1],
                                 merge_leavers=merge_leavers)
    state = tr.remove_replicas(state, [2, 1, 2] if merge_leavers else [1],
                               merge_leavers=merge_leavers)
    assert tr.cfg.n_replicas == jtr.cfg.n_replicas == (2 if merge_leavers else 3)
    np.testing.assert_array_equal(state.b, jstate.b)
    np.testing.assert_array_equal(state.lr, jstate.lr)
    np.testing.assert_array_equal(tr.speed.factors, jtr.speed.factors)
    np.testing.assert_array_equal(tr.scheduler.clock.t, jtr.scheduler.clock.t)
    for tree, jtree in ((state.replicas, jstate.replicas), (state.momentum, jstate.momentum)):
        for k, v in tree.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jtree[k]))
    # crossbow keeps no global before its first barrier
    assert state.global_model is None and jstate.global_model is None


def test_crashed_replica_never_reaches_the_merge():
    tr, _ = E.port_trainer("adaptive")
    state, _ = tr.run_megabatch(tr.init_state())
    state.replicas["w2"][2] = float("inf")
    state.replicas["b1"][2] = float("nan")
    state = tr.remove_replicas(state, [2], merge_leavers=False)
    assert tr.cfg.n_replicas == 3
    for tree in (state.replicas, state.global_model):
        assert all(torch.isfinite(v).all() for v in tree.values())
    with pytest.raises(ValueError, match="out of range"):
        tr.remove_replicas(state, [7])
    with pytest.raises(ValueError, match="all"):
        tr.remove_replicas(state, [0, 1, 2])
    assert tr.remove_replicas(state, []) is state


def test_guard_without_a_global_raises():
    """sync keeps no global model before its first barrier: a population
    that is wholly non-finite there cannot restart, as in the reference."""
    tr, _ = E.port_trainer("sync")
    state = tr.init_state()
    state.replicas["w1"][0] = float("nan")  # sync's mean spreads it to every replica
    with pytest.raises(FloatingPointError, match="global model"):
        tr.run_megabatch(state)


# --------------------------------------------------------------------------
# live runs against the reference
# --------------------------------------------------------------------------


def _check(port_run, ref_run, algo, calls, schedule, n_mb=E.N_MB):
    E.assert_runs_match(port_run, ref_run, n_mb)
    _, mlog, events = port_run
    assert len(calls) == len(E.init_np()) * E.merge_calls(mlog, events, schedule, algo)
    return mlog, events


@pytest.mark.parametrize("case", [("adaptive", True), ("sync", False)],
                         ids=["adaptive-sparse", "sync-dense"])
def test_sequential_path_matches_reference(case, merge_counter):
    algo, sparse = case
    _check(E.run_port(algo, trainer=E.port_trainer(algo, sparse, overlap=False)),
           E.run_ref(algo, trainer=E.ref_trainer(algo, sparse, overlap=False)),
           algo, merge_counter, E.SCHEDULE)


def test_timeout_eviction_matches_reference(merge_counter):
    """A stall of severity 4 blows the timeout factor 2: the straggler is
    evicted gracefully and readmitted after the backoff."""
    faults = "1:stall:1:3,4:stall:0"
    port_run = E.run_port("adaptive", schedule=None, faults=faults, timeout_factor=2.0)
    _, events = _check(port_run, E.run_ref("adaptive", schedule=None, faults=faults,
                                           timeout_factor=2.0),
                       "adaptive", merge_counter, None)
    assert [e["reason"] for e in events if e["action"] == "evict"] == ["timeout", "timeout"]


def test_population_floor_and_ceiling_match_reference(merge_counter):
    faults = "1:crash:0,2:crash:0,3:join,4:join,4:join,5:preempt:1:1"
    kw = dict(schedule=None, faults=faults, fleet_kw=dict(min_replicas=3, max_replicas=5))
    _, events = _check(E.run_port("elastic", **kw), E.run_ref("elastic", **kw), "elastic",
                       merge_counter, None)
    actions = [e["action"] for e in events]
    assert "crash_skipped" in actions and "join_skipped" in actions


def test_random_fault_stream_matches_reference(merge_counter):
    """A seeded probabilistic stream of every kind over 10 mega-batches
    (crashes, repeated joins and readmissions, the backoff)."""
    kw = dict(schedule={0: 4, 6: 3}, faults=RANDOM, n_mb=10)
    _, events = _check(E.run_port("adaptive", **kw), E.run_ref("adaptive", **kw), "adaptive",
                       merge_counter, kw["schedule"], n_mb=10)
    actions = {e["action"] for e in events}
    assert {"evict", "rejoin", "join", "stall", "nan"} <= actions, actions


def test_stall_start_and_end_revoke_the_prefetch():
    """A stall changes a speed factor that a staged plan was costed with:
    the controller revokes the prefetch at the stall's start and at its
    end, as the reference's does. The pipelined run equals the sequential
    one exactly and is held to the reference's."""
    faults = "1:stall:0:2"          # replica 0 stalls before mega-batch 1, recovers before 3
    revoked = []
    tr, test = E.port_trainer("adaptive")
    invalidate = tr.invalidate_prefetch

    def counted():
        revoked.append(tr._staged is not None)
        invalidate()

    tr.invalidate_prefetch = counted
    kw = dict(n_mb=4, schedule=None, faults=faults)
    port_run = E.run_port("adaptive", trainer=(tr, test), **kw)
    assert revoked == [True, True]
    assert [(e["mb"], e["action"]) for e in port_run[2]] == [(1, "stall"), (3, "stall_recovered")]
    off, off_test = E.port_trainer("adaptive")
    off.overlap = False
    off_run = E.run_port("adaptive", trainer=(off, off_test), **kw)
    wall = ("wall_clock", "wall_s")
    assert ([{k: v for k, v in r.items() if k not in wall} for r in port_run[1].records]
            == [{k: v for k, v in r.items() if k not in wall} for r in off_run[1].records])
    E.assert_runs_match(port_run, E.run_ref("adaptive", **kw), n_mb=4)
