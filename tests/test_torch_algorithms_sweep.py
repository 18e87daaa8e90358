"""``crossbow`` and ``delayed_sync`` at 1, 2, 3, 5 and 8 replicas on both
gradient paths, in the port's trainer against a live reference trainer, as
``test_torch_algorithms.py::test_replica_count_matches_reference`` holds
``adaptive`` and ``elastic``: two mega-batches each, host decisions
identical, metrics and the global model within that file's tolerance."""
from __future__ import annotations

import pytest

from test_torch_algorithms import _assert_runs_match, _run_port, _run_ref, p0  # noqa: F401

SWEEP = [(a, R, sparse) for a in ("crossbow", "delayed_sync") for R in (1, 2, 3, 5, 8)
         for sparse in (True, False)]


@pytest.mark.parametrize(
    "case", SWEEP, ids=lambda c: f"{c[0]}-R{c[1]}-{'sparse' if c[2] else 'dense'}")
def test_replica_count_matches_reference(case, p0):  # noqa: F811 (p0: a fixture)
    """The replica dim at other sizes than 4, for the two algorithms with a
    post-round hook (crossbow's correction) or a delayed merge
    (delayed_sync)."""
    algo, R, sparse = case
    _assert_runs_match(_run_port(algo, sparse, p0, R, 2), _run_ref(algo, sparse, R, 2), 2)
