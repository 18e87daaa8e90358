"""LM training, the port's trainer against a live reference trainer
(``tests/torch_lm_runs.py`` has the runs, the settings and the
tolerances): Adaptive SGD on four reduced decoder-only families in f32 —
dense GQA (llama3.2-1b), Mamba2 (mamba2-780m), MoE (moonshot-v1-16b-a3b)
and the attention/Mamba2/MoE hybrid (jamba-1.5-large-398b) — and in bf16
on reduced tinyllama-1.1b. The other five algorithms and the sequential
path are in ``test_torch_lm_algorithms_baselines.py``."""
from __future__ import annotations

import pytest

from torch_lm_runs import (  # noqa: F401 (one_thread: a fixture)
    BF16_TOL, F32_TOL, assert_runs_match, init_np, one_thread, run_port, run_ref,
)
from repro_torch.utils import tree as tu

ARCHS = ("llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b")

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", ARCHS)
def test_adaptive_matches_reference(arch):
    us = assert_runs_match(run_port("adaptive", arch), run_ref("adaptive", arch), F32_TOL)
    assert any(len(set(u)) > 1 for u in us), us   # Alg. 1 and the u-weighted merge act


def test_bf16_tinyllama_matches_reference():
    arch, dtype = "tinyllama-1.1b", "bfloat16"
    assert_runs_match(run_port("adaptive", arch, dtype=dtype),
                      run_ref("adaptive", arch, dtype=dtype), BF16_TOL,
                      init=tu.flatten(init_np(arch, dtype)))
