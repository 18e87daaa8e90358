"""The port's SpMM (plain version on the CPU) against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs.

Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): f32 rtol 2e-4 / atol 2e-5 — the two sum the K
gathered rows in different orders — and bf16 2e-2, where each framework
rounds the bf16 output of an f32 accumulation."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm.ops import spmm as jax_spmm
from repro.kernels.spmm.ref import spmm_ref as jax_spmm_ref
from repro_torch.kernels.spmm.ops import spmm, spmm_cuda

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-5)


def _inputs(rng, lead, B, K, NF, H):
    idx = rng.integers(0, NF, size=lead + (B, K)).astype(np.int32)
    idx[..., 1] = idx[..., 0]                     # duplicate rows within a sample
    val = rng.gamma(2.0, 0.5, size=lead + (B, K)).astype(np.float32)
    mask = rng.random(lead + (B, K)) < 0.7        # masked slots
    mask[..., 0] = True
    w = rng.normal(size=lead + (NF, H)).astype(np.float32)
    return idx, val, mask, w


def _port(idx, val, mask, w, tdt):
    return spmm(
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(mask),
        torch.from_numpy(w).to(tdt),
    )


@pytest.mark.parametrize("B,K,NF,H", [(8, 13, 40, 100), (16, 8, 64, 128), (5, 3, 30, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spmm_matches_pallas_and_ref(B, K, NF, H, dtype):
    rng = np.random.default_rng(B * 1000 + K)
    jdt, tdt = DTYPES[dtype]
    idx, val, mask, w = _inputs(rng, (), B, K, NF, H)
    got = _port(idx, val, mask, w, tdt)
    assert got.shape == (B, H) and got.dtype == tdt
    got = got.float().numpy()
    args = (jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mask), jnp.asarray(w, jdt))
    want_kernel = np.asarray(jax_spmm(*args), np.float32)
    want_ref = np.asarray(jax_spmm_ref(*args), np.float32)
    np.testing.assert_allclose(got, want_kernel, **_tol(dtype))
    np.testing.assert_allclose(got, want_ref, **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spmm_replica_dim(dtype):
    """(R,B,K) x (R,NF,H) -> (R,B,H): replica r uses its own W."""
    rng = np.random.default_rng(7)
    jdt, tdt = DTYPES[dtype]
    R, B, K, NF, H = 3, 6, 11, 50, 100
    idx, val, mask, w = _inputs(rng, (R,), B, K, NF, H)
    got = _port(idx, val, mask, w, tdt)
    assert got.shape == (R, B, H)
    for r in range(R):
        want = jax_spmm(
            jnp.asarray(idx[r]), jnp.asarray(val[r]), jnp.asarray(mask[r]),
            jnp.asarray(w[r], jdt),
        )
        np.testing.assert_allclose(
            got[r].float().numpy(), np.asarray(want, np.float32), **_tol(dtype)
        )


def test_spmm_cuda_path_rejects_cpu_tensors():
    """The launcher never falls back to the plain version: CPU tensors raise."""
    rng = np.random.default_rng(0)
    idx, val, mask, w = (torch.from_numpy(a) for a in _inputs(rng, (), 4, 5, 10, 8))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_cuda(idx, val, mask, w)
    assert spmm_cuda.launches == 0
