"""The sharded placement's trainer against the vmap placement and against
the reference, every registered algorithm.

* A one-shard mesh equals the port's own vmap run **bitwise** on the CPU:
  every record (host decisions, losses, accuracies), the global model and
  every replica, for all six algorithms through the pipeline and the
  sequential path (the reference requires the same of its own sharded
  placement, tests/test_algorithms.py).
* Four CPU shards (``("cpu",) * 4``: four worker threads, the collectives
  a rendezvous) against a live reference vmap run on the same data and
  initial weights, all six algorithms through the pipeline (``scan``) and
  ``adaptive`` and ``sync`` through the sequential path (``sequential``,
  ``overlap=False``, against the reference's): u, b, lr, alphas,
  n_rounds, virtual time and perturbation identical; losses, accuracies
  and the global model
  within rtol 1e-5 / atol 1e-6, the slice-1 tolerance
  (tests/torch_elastic_runs.py). The shards' partial sums are summed in
  another order than either framework's single-program sums; measured
  here: within 3e-7 of the port's own vmap run. ``single`` resolves to one
  replica, so its mesh has one shard.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro_torch.utils.tree import ShardedTree

pytestmark = pytest.mark.usefixtures("one_thread")

ALGOS = ("adaptive", "crossbow", "delayed_sync", "elastic", "single", "sync")
N_MB = 3


def _run(tr_test, n_mb=N_MB):
    tr, test = tr_test
    state, mlog = tr.run(n_mb, test_batches=test)
    tr.close()
    return tr, state, mlog


def _whole(tree):
    return tree.gather("cpu") if hasattr(tree, "gather") else tree


@pytest.mark.parametrize("path", ["scan", "sequential"])
@pytest.mark.parametrize("algo", ALGOS)
def test_one_shard_equals_vmap_bitwise(algo, path):
    kw = dict(momentum=0.9, overlap=path == "scan")
    _, vstate, vlog = _run(E.port_trainer(algo, **kw))
    tr, sstate, slog = _run(E.port_trainer(algo, mesh=["cpu"], **kw))
    assert len(tr.mesh) == 1
    for rec, srec in zip(vlog.records, slog.records):
        assert {k: v for k, v in rec.items() if not k.startswith("wall")} == {
            k: v for k, v in srec.items() if not k.startswith("wall")}
    for tree, stree in ((vstate.global_model, sstate.global_model),
                        (vstate.replicas, _whole(sstate.replicas)),
                        (vstate.momentum, _whole(sstate.momentum))):
        for k, v in tree.items():
            assert torch.equal(v, stree[k]), k


CASES = [(a, "scan") for a in ALGOS] + [("adaptive", "sequential"), ("sync", "sequential")]


@pytest.mark.parametrize("algo,path", CASES, ids=[f"{a}-{p}" for a, p in CASES])
def test_four_shards_match_reference(algo, path):
    # the mesh must split R: single's one replica takes a one-shard mesh
    n_shards = 1 if algo == "single" else 4
    overlap = path == "scan"
    tr, state, mlog = _run(E.port_trainer(algo, mesh=["cpu"] * n_shards, overlap=overlap))
    assert isinstance(state.replicas, ShardedTree) and len(state.replicas.blocks) == len(tr.mesh)
    jtr, jtest = E.ref_trainer(algo, overlap=overlap)
    jstate, jlog = jtr.run(N_MB, test_batches=jtest)
    assert len(mlog.records) == len(jlog.records) == N_MB
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in E.EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
    for k in E.METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **E.TOL)
    E.assert_state_matches(state, jstate)
