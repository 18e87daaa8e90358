"""The port's SpMM (plain version on the CPU) against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs; and
the plain emulation of the counting sort that ``spmm_grad_w``'s kernel
walks, against ``torch.sort(stable=True)``.

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
from repro_torch.kernels.spmm.ref import sort_passes, sort_rows_ref

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


@pytest.mark.parametrize("nonfinite", ["w_row", "val"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "replica"])
def test_masked_slot_carries_nonfinite(lead, nonfinite):
    """Masked slots are multiplied in with a scale of exactly 0: a NaN in
    the W row that only masked slots name (``w_row``) reaches the output, in
    the reference's Pallas kernel as in the port; an infinite val of a
    masked slot (``val``) does not, as the reference's ``val * mask`` is a
    select. The CUDA kernel gathers a row once per run of zero-scale slots
    and must keep both."""
    rng = np.random.default_rng(11)
    # K a multiple of the reference kernel's block_k (8): a ragged K pads
    # every sample with zero-scale slots naming row 0, which would carry
    # the NaN of row 0 to every sample of the reference's kernel alone
    B, K, NF, H = 5, 16, 30, 16
    idx, val, mask, w = _inputs(rng, lead, B, K, NF, H)
    idx[idx == 0] = 1                  # no unmasked slot names row 0
    mask[..., 1, 4:] = False           # sample 1: a padding run naming row 0
    idx[..., 1, 4:] = 0
    mask[..., 3, :] = False            # sample 3: all padding
    idx[..., 3, :] = 0
    if nonfinite == "w_row":
        w[..., 0, 5] = np.nan
        hit = np.zeros(lead + (B, H), bool)
        hit[..., [1, 3], 5] = True
    else:
        val[..., 3, 2] = np.inf
        hit = np.zeros(lead + (B, H), bool)
    got = _port(idx, val, mask, w, torch.float32).numpy()
    want = np.stack([
        np.asarray(jax_spmm(*(jnp.asarray(a[r]) for a in (idx, val, mask, w))))
        for r in np.ndindex(lead)
    ]).reshape(got.shape)
    np.testing.assert_array_equal(np.isnan(want), hit)
    np.testing.assert_array_equal(np.isnan(got), hit)
    np.testing.assert_allclose(got[~hit], want[~hit], **_tol("float32"))


NF_670K = 135_909  # Amazon-670K's feature count: two 9-bit passes


def _sort_keys(case, rng):
    """(keys (R, S) int32, n_rows, tile) of one edge case of the sort."""
    if case == "one_slot":
        return np.zeros((1, 1), np.int32), 1, 2048
    if case == "one_row":                       # every slot on row 7, 3 tiles
        return np.full((2, 5000), 7, np.int32), 300, 2048
    if case == "all_masked":                    # padding only: every slot names row 0
        return np.zeros((3, 4100), np.int32), NF_670K, 2048
    if case == "near_nf":                       # the largest rows, ties across 11 tiles
        return rng.integers(NF_670K - 5, NF_670K, (2, 700)).astype(np.int32), NF_670K, 64
    if case == "padded_batch":                  # 2/3 padding on row 0, Zipf-like rows
        keys = (rng.zipf(1.3, (4, 6000)) % NF_670K).astype(np.int32)
        keys[rng.random(keys.shape) < 0.67] = 0
        return keys, NF_670K, 2048
    # three 7-bit passes, a ragged last tile
    return rng.integers(0, 300_000, (2, 3001)).astype(np.int32), 300_000, 256


@pytest.mark.parametrize(
    "case", ["one_slot", "one_row", "all_masked", "near_nf", "padded_batch", "three_passes"])
def test_counting_sort_matches_stable_sort(case):
    """The plain emulation of the kernel's counting sort gives exactly the
    rows and the order of torch's stable sort: spmm_grad_w then sums each
    row's slots in the order of a stable sort."""
    keys, n_rows, tile = _sort_keys(case, np.random.default_rng(3))
    passes, bits = sort_passes(n_rows)
    assert passes * bits >= (n_rows - 1).bit_length() and 2 <= bits <= 9
    rows, order = sort_rows_ref(torch.from_numpy(keys), n_rows, tile)
    want_rows, want_order = torch.sort(torch.from_numpy(keys), dim=-1, stable=True)
    assert rows.dtype == order.dtype == torch.int32
    torch.testing.assert_close(rows, want_rows, rtol=0, atol=0)
    torch.testing.assert_close(order.long(), want_order, rtol=0, atol=0)
