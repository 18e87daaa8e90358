"""The LM kernels of the port (plain versions on the CPU) against the
reference's Pallas kernels (interpret mode) and jnp oracles, on the same
numpy inputs, over the reference's sweep shapes (tests/test_kernels.py):
ragged Sq/Skv, sliding windows, non-causal Sq != Skv, ragged C and F, zero
capacity rows, bf16, chunk invariance.

Tolerances are the reference's own: f32 2e-4 for attention and the expert
FFN (f32 reassociation), 1e-4 for the SSD scan; bf16 3e-2 for attention
and the scan, 2e-2 for the FFN, where each framework rounds the bf16
output of an f32 computation.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.moe_gmm.ops import moe_ffn_gmm as jax_gmm
from repro.kernels.moe_gmm.ref import moe_ffn_gmm_ref as jax_gmm_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_cuda
from repro_torch.kernels.moe_gmm.ops import moe_ffn_gmm, moe_ffn_gmm_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,hd,causal,window",
    [
        (2, 128, 128, 4, 2, 64, True, 0),     # GQA causal
        (1, 256, 256, 8, 2, 32, True, 64),    # sliding window
        (2, 96, 160, 4, 4, 64, False, 0),     # cross (non-causal, Sq != Skv)
        (1, 200, 200, 2, 1, 64, True, 0),     # ragged (not a tile multiple)
        (1, 192, 192, 8, 1, 112, True, 0),    # kimi-k2-like GQA, head dim 112
        (1, 256, 256, 4, 2, 128, True, 96),   # sliding window, head dim 128
    ],
)
def test_flash_attention_matches_pallas_and_ref(b, sq, skv, hq, hkv, hd, causal, window):
    rng = np.random.default_rng(sq * 7 + skv)
    q = rng.normal(size=(b, sq, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.shape == (b, sq, hq, hd) and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_kernel = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64)
    want_ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **F32)
    np.testing.assert_allclose(_np(got), _np(want_ref), **F32)


def test_flash_attention_bf16():
    rng = np.random.default_rng(11)
    b, s, hq, hkv, hd = 1, 128, 4, 2, 64
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for h in (hq, hkv, hkv))
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    np.testing.assert_allclose(_np(got), _np(jax_flash(*jargs, block_q=64, block_k=64)), **BF16)
    np.testing.assert_allclose(_np(got), _np(jax_attention_ref(*jargs)), **BF16)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_matches_blockwise(window):
    """The kernel's plain version agrees with the model's own online-softmax
    path, and that path with the reference's, chunked at 64."""
    rng = np.random.default_rng(5)
    b, s, hq, hkv, hd = 2, 128, 8, 4, 32
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for h in (hq, hkv, hkv))
    got = flash_attention(_t(q), _t(k), _t(v), window=window)
    block = TL.blockwise_attention(_t(q), _t(k), _t(v), window=window, q_chunk=64, kv_chunk=64)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(_np(got), _np(block), **F32)
    np.testing.assert_allclose(_np(block), _np(want), **F32)


def test_blockwise_attention_key_mask_and_empty_rows():
    """kv_seq_mask, including a batch row with every key masked (output 0,
    not NaN), against the reference's blockwise path."""
    rng = np.random.default_rng(6)
    b, s, hq, hkv, hd = 2, 96, 4, 2, 32
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for h in (hq, hkv, hkv))
    mask = rng.random((b, s)) > 0.3
    mask[1] = False
    got = TL.blockwise_attention(_t(q), _t(k), _t(v), causal=False, q_chunk=32, kv_chunk=32,
                                 kv_seq_mask=torch.from_numpy(mask))
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                  q_chunk=32, kv_chunk=32, kv_seq_mask=jnp.asarray(mask))
    assert np.all(np.isfinite(_np(got))) and not _np(got)[1].any()
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_flash_attention_output_is_a_convex_combination():
    """Scale stability (the reference's property test): every output is a
    convex combination of V rows, so max|out| <= max|V|."""
    for seed in range(5):
        rng = np.random.default_rng(seed)
        q = _t(rng.normal(size=(1, 64, 2, 32)) + rng.uniform(-3, 3))
        k, v = (_t(rng.normal(size=(1, 64, 2, 32))) for _ in range(2))
        assert flash_attention(q, k, v).abs().max() <= v.abs().max() + 1e-4


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _round_p(p, how):
    """P (f64) as the bf16 path of a kernel would feed it to P.V: in f32,
    then rounded once to bf16 (``"bf16"``) or as the pair hi = bf16(p),
    lo = bf16(p - hi) (``"hi_lo"``)."""
    p32 = p.float()
    hi = p32.to(torch.bfloat16)
    if how == "bf16":
        return hi.double()
    return hi.double() + (p32 - hi.float()).to(torch.bfloat16).double()


def _causal_attention_f64(q, k, v, drop_tile=None, p_round=None):
    """Causal attention in f64, head by head, rounded once to q's dtype.
    ``drop_tile`` = (first row, first key, width) hides those keys from the
    rows from the first row on, as a kernel that skipped a KV tile would.
    ``p_round`` ("bf16" or "hi_lo") rounds the unnormalised P = exp(s - max)
    before P.V as ``_round_p`` says; the row sums stay unrounded."""
    s, hq, hd = q.shape[1:]
    rep = hq // k.shape[2]
    rows, keys = torch.arange(s)[:, None], torch.arange(s)[None, :]
    allow = keys <= rows
    if drop_tile is not None:
        r0, k0, width = drop_tile
        allow &= ~((rows >= r0) & (keys >= k0) & (keys < k0 + width))
    out = torch.empty(q.shape, dtype=torch.float64)
    for h in range(hq):
        scores = q[:, :, h].double() @ k[:, :, h // rep].double().transpose(1, 2) * hd ** -0.5
        scores = scores.masked_fill(~allow, float("-inf"))
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        pv = p if p_round is None else _round_p(p, p_round)
        out[:, :, h] = (pv @ v[:, :, h // rep].double()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


@pytest.mark.parametrize("hq,hkv,hd", [(2, 1, 64), (1, 1, 128)])
def test_long_row_bf16_tolerance_rejects_a_dropped_kv_tile(hq, hkv, hd):
    """chip_smoke.py holds flash_attention at S = 4096 in bf16 to one bf16
    ulp per element and a relative L2 error of 1e-2. An f64 computation
    rounded once passes; one that hides a 64-key tile from the last 512
    rows fails, though the reference's 128-row bf16 tolerance (3e-2) lets
    it through."""
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(hd)
    q, k, v = (_t(rng.normal(size=(1, 4096, h, hd)), torch.bfloat16) for h in (hq, hkv, hkv))
    want = flash_attention(q, k, v)  # the plain version the kernel is held to
    smoke.check_close("f64, rounded once", _causal_attention_f64(q, k, v), want,
                      smoke.BF16_LONG_ATTN_TOL)
    dropped = _causal_attention_f64(q, k, v, drop_tile=(3584, 64, 64))
    assert torch.allclose(dropped.float(), want.float(), **smoke.BF16_ATTN_TOL)
    with pytest.raises(RuntimeError, match="disagrees"):
        smoke.check_close("dropped tile", dropped, want, smoke.BF16_LONG_ATTN_TOL)


@pytest.mark.parametrize("hq,hkv,hd", [(2, 1, 64), (1, 1, 128)])
def test_long_row_bf16_tolerance_needs_p_as_a_hi_lo_pair(hq, hkv, hd):
    """The rounding design of flash_attention's bf16 path, pinned to
    chip_smoke.py's unchanged S = 4096 tolerance: P rounded once to bf16
    before P.V fails it; P as a bf16 hi/lo pair (two products) passes."""
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(hd)
    q, k, v = (_t(rng.normal(size=(1, 4096, h, hd)), torch.bfloat16) for h in (hq, hkv, hkv))
    want = flash_attention(q, k, v)  # the plain version the kernel is held to
    with pytest.raises(RuntimeError, match="disagrees"):
        smoke.check_close("P rounded once", _causal_attention_f64(q, k, v, p_round="bf16"),
                          want, smoke.BF16_LONG_ATTN_TOL)
    smoke.check_close("P as hi + lo", _causal_attention_f64(q, k, v, p_round="hi_lo"), want,
                      smoke.BF16_LONG_ATTN_TOL)


# --------------------------------------------------------------------------
# moe_ffn_gmm
# --------------------------------------------------------------------------


def _gmm_inputs(rng, e, c, d, f):
    return (
        (rng.normal(size=(e, c, d)) * 0.5).astype(np.float32),
        (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
        (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
        (rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32),
    )


@pytest.mark.parametrize("e,c,d,f", [(4, 64, 128, 256), (2, 100, 64, 300), (8, 32, 256, 512)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_gmm_matches_pallas_and_ref(e, c, d, f, dtype):
    jdt, tdt = DTYPES[dtype]
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32
    arrays = _gmm_inputs(np.random.default_rng(e * c + f), e, c, d, f)
    got = moe_ffn_gmm(*(_t(a, tdt) for a in arrays))
    assert got.shape == (e, c, d) and got.dtype == tdt
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    np.testing.assert_allclose(_np(got), _np(jax_gmm(*jargs, block_c=32, block_f=128)), **tol)
    np.testing.assert_allclose(_np(got), _np(jax_gmm_ref(*jargs)), **tol)


def test_moe_gmm_argument_order():
    """silu goes on buf @ wg: swapping wi and wg changes the result."""
    buf, wi, wg, wo = (_t(a) for a in _gmm_inputs(np.random.default_rng(2), 2, 16, 32, 64))
    ref = _np(jax_gmm_ref(*(jnp.asarray(_np(a)) for a in (buf, wi, wg, wo))))
    np.testing.assert_allclose(_np(moe_ffn_gmm(buf, wi, wg, wo)), ref, **F32)
    assert not np.allclose(_np(moe_ffn_gmm(buf, wg, wi, wo)), ref, **F32)


def test_moe_gmm_bf16_intermediate_meets_the_bf16_tolerance():
    """The rounding design of moe_ffn_gmm's bf16 path: the SwiGLU
    intermediate H rounded once to bf16 between the two passes stays within
    chip_smoke.py's BF16_TOL of the plain version, at the moonshot expert
    widths (one expert of capacity 960) and chip_smoke's input scales."""
    smoke = _load_chip_smoke()
    gen = torch.Generator().manual_seed(0)
    e, c, d, f = 1, 960, 2048, 1408

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16)

    buf = randn(e, c, d, scale=0.5)
    buf[torch.rand((e, c), generator=gen) > 0.8] = 0  # capacity padding
    wi, wg = randn(e, d, f, scale=d ** -0.5), randn(e, d, f, scale=d ** -0.5)
    wo = randn(e, f, d, scale=f ** -0.5)
    x = buf.float()
    h = torch.nn.functional.silu(x @ wg.float()) * (x @ wi.float())
    got = (h.to(torch.bfloat16).float() @ wo.float()).to(torch.bfloat16)
    smoke.check_close("H rounded once", got, moe_ffn_gmm(buf, wi, wg, wo), smoke.BF16_TOL)


def test_moe_gmm_zero_rows_give_zero():
    """Capacity-padding rows (zero inputs) must produce zero outputs."""
    _, wi, wg, wo = _gmm_inputs(np.random.default_rng(3), 2, 16, 32, 64)
    buf = np.zeros((2, 16, 32), np.float32)
    got = moe_ffn_gmm(_t(buf), _t(wi), _t(wg), _t(wo))
    assert not _np(got).any()
    assert not _np(jax_gmm(*(jnp.asarray(a) for a in (buf, wi, wg, wo)),
                           block_c=16, block_f=32)).any()


# --------------------------------------------------------------------------
# ssd_scan
# --------------------------------------------------------------------------


def _ssd_inputs(rng, b, l, h, p, n):
    return (
        (rng.normal(size=(b, l, h, p)) * 0.5).astype(np.float32),
        -(rng.random((b, l, h)) * 0.5).astype(np.float32),
        (rng.normal(size=(b, l, h, n)) * 0.5).astype(np.float32),
        (rng.normal(size=(b, l, h, n)) * 0.5).astype(np.float32),
    )


@pytest.mark.parametrize(
    "b,l,h,p,n,c", [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64), (2, 64, 8, 16, 8, 16)]
)
def test_ssd_scan_matches_pallas_and_ref(b, l, h, p, n, c):
    arrays = _ssd_inputs(np.random.default_rng(l + p), b, l, h, p, n)
    y, fin = ssd_scan(*(_t(a) for a in arrays), chunk=c)
    assert y.shape == (b, l, h, p) and fin.shape == (b, h, p, n)
    assert y.dtype == fin.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in arrays]
    for want_y, want_fin in (jax_ssd(*jargs, chunk=c), jax_ssd_ref(*jargs, c)):
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(fin), _np(want_fin), rtol=1e-4, atol=1e-4)


def test_ssd_scan_bf16_inputs():
    x, dA, bm, cm = _ssd_inputs(np.random.default_rng(9), 1, 64, 2, 32, 16)
    y, _ = ssd_scan(_t(x, torch.bfloat16), _t(dA), _t(bm, torch.bfloat16),
                    _t(cm, torch.bfloat16), chunk=32)
    jy, _ = jax_ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dA), jnp.asarray(bm, jnp.bfloat16),
                    jnp.asarray(cm, jnp.bfloat16), chunk=32)
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)


def test_ssd_scan_chunk_invariance_and_initial_state():
    """Chunks of 32 and 64 agree; a scan split in two halves, the second
    started from the first's final state, equals the whole scan, in the port
    and against the reference's ssd_chunked with the same initial state."""
    x, dA, bm, cm = (_t(a) for a in _ssd_inputs(np.random.default_rng(4), 1, 128, 2, 16, 8))
    y32, f32_ = ssd_scan(x, dA, bm, cm, chunk=32)
    y64, f64_ = ssd_scan(x, dA, bm, cm, chunk=64)
    np.testing.assert_allclose(_np(y32), _np(y64), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(f32_), _np(f64_), rtol=1e-4, atol=1e-4)
    half = [t[:, :64] for t in (x, dA, bm, cm)], [t[:, 64:] for t in (x, dA, bm, cm)]
    _, mid = TM.ssd_chunked(*half[0], 32)
    y2, fin2 = TM.ssd_chunked(*half[1], 32, initial_state=mid)
    np.testing.assert_allclose(_np(y2), _np(y32[:, 64:]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fin2), _np(f32_), rtol=1e-4, atol=1e-4)
    jy2, jfin2 = JM.ssd_chunked(*(jnp.asarray(_np(t)) for t in half[1]), 32,
                                initial_state=jnp.asarray(_np(mid)))
    np.testing.assert_allclose(_np(y2), _np(jy2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fin2), _np(jfin2), rtol=1e-4, atol=1e-4)


def test_ssd_scan_matches_recurrence():
    """Position t equals the per-token recurrence through t (the prefill /
    decode consistency that makes the cache-free SSM serving path valid)."""
    x, dA, bm, cm = _ssd_inputs(np.random.default_rng(3), 1, 32, 2, 8, 4)
    y, _ = ssd_scan(_t(x), _t(dA), _t(bm), _t(cm), chunk=8)
    state = np.zeros((1, 2, 8, 4), np.float64)
    for t in range(32):
        state = state * np.exp(dA[:, t])[..., None, None] + np.einsum(
            "bhp,bhn->bhpn", x[:, t], bm[:, t])
        np.testing.assert_allclose(_np(y[:, t]), np.einsum("bhpn,bhn->bhp", state, cm[:, t]),
                                   rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# the CUDA entry points never take CPU tensors
# --------------------------------------------------------------------------


def test_kernel_paths_by_dtype():
    """Each of the two redesigned kernels states its path per dtype: bf16 on
    the tensor cores, f32 on the CUDA cores; flash_attention takes every
    multiple of 16 from 16 to 128 as its head dim, on both."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    for ops in (flash_ops, gmm_ops):
        assert ops.PATHS == {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
    assert flash_ops.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)


def test_cuda_entry_points_reject_cpu_tensors():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    buf, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        moe_ffn_gmm_cuda(buf, w, w, w)
    x, da = torch.zeros((1, 8, 2, 4)), torch.zeros((1, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, da, x, x, chunk=4)
    assert flash_attention_cuda.launches == moe_ffn_gmm_cuda.launches == 0
    assert flash_attention_cuda.tensor_core_launches == moe_ffn_gmm_cuda.tensor_core_launches == 0
    assert ssd_scan_cuda.launches == 0
