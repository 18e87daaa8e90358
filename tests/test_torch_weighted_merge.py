"""The port's weighted merge (plain version on the CPU) against the
reference's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances are the reference's kernel tolerances (tests/test_kernels.py):
f32 rtol 2e-4 / atol 2e-5 for the R-term f32 sums taken in different
orders, bf16 2e-2 for the bf16 rounding of the output."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.weighted_merge.ops import merge as jax_merge
from repro.kernels.weighted_merge.ops import merge_pytree as jax_merge_pytree
from repro_torch.kernels.weighted_merge.ops import merge, merge_cuda, merge_pytree

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("r,n", [(2, 100), (4, 2048), (8, 5001), (3, 100), (5, 2048)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("momentum", [False, True])
def test_merge_matches_pallas(r, n, dtype, momentum):
    rng = np.random.default_rng(r * 10_000 + n)
    jdt, tdt = DTYPES[dtype]
    reps = rng.normal(size=(r, n)).astype(np.float32)
    alphas = rng.random(r).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    gp = rng.normal(size=n).astype(np.float32)
    gamma = 0.9 if momentum else 0.0
    got = merge(
        torch.from_numpy(reps).to(tdt), torch.from_numpy(alphas),
        torch.from_numpy(g).to(tdt), torch.from_numpy(gp).to(tdt), gamma,
    )
    assert got.shape == (n,) and got.dtype == tdt
    want = jax_merge(
        jnp.asarray(reps, jdt), jnp.asarray(alphas),
        jnp.asarray(g, jdt), jnp.asarray(gp, jdt), gamma,
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype)
    )


@pytest.mark.parametrize("momentum", [False, True])
def test_merge_pytree_matches_pallas(momentum):
    rng = np.random.default_rng(3)
    R = 4
    shapes = {"w1": (37, 8), "b1": (8,), "w2": (8, 21), "b2": (21,)}
    reps = {k: rng.normal(size=(R,) + s).astype(np.float32) for k, s in shapes.items()}
    glob = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    prev = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    alphas = rng.random(R).astype(np.float32)
    gamma = 0.9 if momentum else 0.0
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    got = merge_pytree(t(reps), torch.from_numpy(alphas), t(glob), t(prev), gamma)
    want = jax_merge_pytree(j(reps), jnp.asarray(alphas), j(glob), j(prev), gamma)
    assert set(got) == set(shapes)
    for k, s in shapes.items():
        assert tuple(got[k].shape) == s
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-5)


def test_merge_cuda_path_rejects_cpu_tensors():
    """The launcher never falls back to the plain version: CPU tensors raise."""
    with pytest.raises(ValueError, match="CUDA"):
        merge_cuda(torch.ones(2, 16), torch.ones(2))
    assert merge_cuda.launches == 0
