"""The sharded placement through every path that holds state: resizes
that redraw the mesh, the fleet's faults, the non-finite guard,
checkpoints that cross placements and packages, and the overlap pipeline.

* Resize 4 -> 8 -> 2 (the reference's tests/test_resize.py schedule) over a
  pool of four CPU devices: 4 shards of one replica, 4 of two, then 2 of
  one, for ``adaptive``, ``crossbow`` (its survivors keep their own rows,
  copied across shards) and ``delayed_sync``, against a live reference vmap
  run with the same schedule; a resize back to a shard count seen before
  reuses that count's executor.
* The elastic scenario of tests/torch_elastic_runs.py (the schedule, a
  NaN, a crash, a stall, a preemption, readmissions, a join: R 4, 4, 6, 5,
  4, 5, 6) over two CPU devices (one shard at R = 5), against the
  reference.
* A checkpoint written under sharded restores under vmap and into the
  reference, and a reference checkpoint into the sharded placement; each
  continues as the writer did.
* The overlap pipeline on equals off bitwise under sharded, for every
  algorithm through a resize (the reference requires the same,
  tests/test_overlap.py).

Host decisions and fleet logs identical; losses, accuracies and the global
model within rtol 1e-5 / atol 1e-6 (tests/torch_elastic_runs.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store
from repro_torch.core import algorithms
from repro_torch.utils.tree import ShardedTree

pytestmark = pytest.mark.usefixtures("one_thread")

CPU4 = ["cpu"] * 4
RESIZE = {1: 8, 3: 2}


@pytest.mark.parametrize("algo", ["adaptive", "crossbow", "delayed_sync"])
def test_resize_4_8_2_matches_reference(algo):
    tr, test = E.port_trainer(algo, mesh=CPU4)
    shards = []
    resize = tr.resize

    def counted(state, new_R):
        state = resize(state, new_R)
        shards.append((new_R, len(tr.mesh), len(state.replicas.blocks)))
        return state

    tr.resize = counted
    port = E.run_port(algo, n_mb=4, schedule=RESIZE, faults=None, trainer=(tr, test))
    E.assert_runs_match(port, E.run_ref(algo, n_mb=4, schedule=RESIZE, faults=None), n_mb=4)
    assert shards == [(8, 4, 4), (2, 2, 2)]
    assert sorted(tr._executors) == [2, 4]
    executor4 = tr._executors[4]
    state = tr.resize(port[0], 4)
    assert tr._executor is executor4 and len(state.replicas.blocks) == 4
    tr.close()


def test_elastic_scenario_on_two_shards_matches_reference():
    tr, test = E.port_trainer("adaptive", mesh=["cpu"] * 2)
    widths = []
    step = tr.run_megabatch

    def recorded(state, prefetch=None):
        widths.append(len(state.replicas.blocks))
        return step(state, prefetch)

    tr.run_megabatch = recorded
    port = E.run_port("adaptive", trainer=(tr, test))
    E.assert_runs_match(port, E.run_ref("adaptive"))
    assert [r["n_replicas"] for r in port[1].records] == [4, 4, 6, 5, 4, 5, 6]
    assert widths == [2, 2, 2, 1, 2, 1, 2]   # 5 replicas: one shard
    assert any(r.get("guard_repaired") for r in port[1].records)
    assert {e["action"] for e in port[2]} >= {"nan", "evict", "rejoin", "join"}
    tr.close()


def test_sharded_checkpoint_restores_under_vmap_and_into_the_reference(tmp_path):
    """The sharded writer checkpoints every mega-batch of the resize
    schedule (no faults: a checkpoint holds no fleet state); the port under
    vmap and the reference each restore the one after mega-batch 5 (R = 6
    over three shards, gathered into the reference's layout) and continue
    as the writer did, through the resize to 3."""
    kw = dict(n_mb=9, faults=None)
    mgr = store.CheckpointManager(str(tmp_path), every=1, retain=9)
    tr, test = E.port_trainer("adaptive", mesh=CPU4)
    full = E.run_port("adaptive", checkpoint=mgr, trainer=(tr, test), **kw)
    tr.close()
    assert store.load_metadata(mgr.step_path(5))["n_replicas"] == 6
    for resumed in (E.run_port("adaptive", restore_from=mgr.step_path(5), **kw),
                    E.run_ref("adaptive", restore_from=mgr.step_path(5), **kw)):
        (_, w_log, w_events), (state, r_log, r_events) = full, resumed
        assert [r["megabatch"] for r in r_log.records] == [6, 7, 8, 9]
        assert r_events == [e for e in w_events if e["mb"] >= 5]
        for rec, wrec in zip(r_log.records, w_log.records[5:]):
            for k in E.EXACT + ("megabatch",):
                assert rec[k] == wrec[k], (rec["megabatch"], k)
            for k in E.METRICS:
                np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **E.TOL)
        for k, v in full[0].global_model.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(state.global_model[k]),
                                       err_msg=k, **E.TOL)


def test_reference_checkpoint_restores_under_sharded(tmp_path):
    mgr = jstore.CheckpointManager(str(tmp_path), every=1, retain=9)
    full = E.run_ref("adaptive", n_mb=9, checkpoint=mgr)
    tr, test = E.port_trainer("adaptive", n_replicas=2, mesh=["cpu"] * 2)
    resumed = E.run_port("adaptive", n_mb=9, restore_from=mgr.step_path(6), trainer=(tr, test))
    tr.close()
    (jstate, w_log, w_events), (state, r_log, r_events) = full, resumed
    assert isinstance(state.replicas, ShardedTree)
    assert r_events == [e for e in w_events if e["mb"] >= 6]
    for rec, wrec in zip(r_log.records, w_log.records[6:]):
        for k in E.EXACT + ("megabatch",):
            assert rec[k] == wrec[k], (rec["megabatch"], k)
        for k in E.METRICS:
            np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **E.TOL)
    E.assert_state_matches(state, jstate)


def _strip(rec):
    return {k: v for k, v in rec.items() if not k.startswith("wall")}


@pytest.mark.parametrize("algo", algorithms.available())
def test_overlap_on_equals_off_bitwise_under_sharded(algo):
    runs = []
    for overlap in (True, False):
        mesh = ["cpu"] if algo == "single" else CPU4
        tr, test = E.port_trainer(algo, mesh=mesh, momentum=0.9, overlap=overlap)
        state, mlog = tr.run(4, test_batches=test, resize_schedule={1: 8, 2: 2})
        assert tr._staged is None
        tr.close()
        runs.append((state, [_strip(r) for r in mlog.records]))
    (on, on_log), (off, off_log) = runs
    assert on_log == off_log
    for tree, other in ((on.replicas, off.replicas), (on.momentum, off.momentum)):
        whole, other = tree.gather("cpu"), other.gather("cpu")
        for k in whole:
            assert torch.equal(whole[k], other[k]), (algo, k)
    for k in on.global_model:
        assert torch.equal(on.global_model[k], off.global_model[k]), (algo, k)
