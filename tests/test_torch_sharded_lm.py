"""LM training under the sharded placement: reduced tinyllama-1.1b,
Adaptive SGD over two CPU shards (two replicas each), against the
reference's vmap run from the same initial weights and token stream
(``tests/torch_lm_runs.py``): host decisions identical, metrics and the
global model within its f32 tolerance (rtol 1e-5 / atol 1e-5); and in bf16,
where the shards' merge rounds each shard's partial to bf16 before the sum
(as the reference's sharded merge does), within its bf16 tolerance."""
from __future__ import annotations

import pytest

from torch_lm_runs import (  # noqa: F401 (one_thread: a fixture)
    BF16_TOL, F32_TOL, assert_runs_match, init_np, one_thread, run_port, run_ref,
)
from repro_torch.utils import tree as tu

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "tinyllama-1.1b"


def test_tinyllama_on_two_shards_matches_reference():
    us = assert_runs_match(run_port("adaptive", ARCH, mesh=["cpu"] * 2),
                           run_ref("adaptive", ARCH), F32_TOL)
    assert any(len(set(u)) > 1 for u in us), us   # Alg. 1 and the u-weighted merge act


def test_bf16_tinyllama_on_two_shards_matches_reference():
    assert_runs_match(run_port("adaptive", ARCH, dtype="bfloat16", mesh=["cpu"] * 2),
                      run_ref("adaptive", ARCH, dtype="bfloat16"), BF16_TOL,
                      init=tu.flatten(init_np(ARCH, "bfloat16")))
