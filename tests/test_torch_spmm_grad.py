"""The port's SpMM backward against the reference's.

* ``spmm_grad_w`` (the plain version on the CPU) against the reference's
  Pallas ``spmm_grad_w`` (interpret mode) and its ``spmm_grad_w_ref``, on
  the reference's sweep shapes (tests/test_spmm_grad.py): duplicated rows
  within a sample, an all-masked sample, ragged H, with and without the
  leading replica dim;
* the ``spmm`` autograd Function's d``w`` and d``feat_val`` against
  ``jax.vjp`` of the reference's ``ops.spmm`` (custom VJP, Pallas both
  ways), for f32 and bf16 W;
* a NaN in ``dh`` of a sample whose masked slot names row 0 poisons row 0
  in both packages: masked slots are multiplied in, not dropped;
* a masked slot's scale is exactly 0 whatever its val holds (the
  reference's ``val * mask`` is a select), in dW and in d feat_val.

Tolerances are the reference's kernel tolerances (tests/test_kernels.py):
f32 rtol 2e-4 / atol 2e-5, the two sum each row's slots in different
orders; bf16 2e-2, where each framework rounds the f32 sums to bf16."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm.ops import spmm as jax_spmm
from repro.kernels.spmm.ops import spmm_grad_w as jax_grad_w
from repro.kernels.spmm.ref import spmm_grad_w_ref as jax_grad_w_ref
from repro_torch.kernels.spmm.ops import sort_rows_cuda, spmm, spmm_grad_w, spmm_grad_w_cuda
from repro_torch.kernels.spmm.ref import spmm_grad_w_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(4, 16, 512, 128), (8, 7, 300, 512), (2, 33, 1024, 200)]
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else F32_TOL


def _inputs(rng, lead, B, K, NF, H):
    """Padded-COO slots with a duplicated row in sample 0 and sample 1 fully
    masked, plus a cotangent dh."""
    idx = rng.integers(0, NF, size=lead + (B, K)).astype(np.int32)
    if K >= 2:
        idx[..., 0, 1] = idx[..., 0, 0]
    val = rng.normal(size=lead + (B, K)).astype(np.float32)
    mask = rng.random(lead + (B, K)) > 0.3
    mask[..., min(1, B - 1), :] = False
    dh = rng.normal(size=lead + (B, H)).astype(np.float32)
    return idx, val, mask, dh


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,K,NF,H", SHAPES)
def test_grad_w_matches_pallas_and_ref(B, K, NF, H):
    rng = np.random.default_rng(NF + H)
    idx, val, mask, dh = _inputs(rng, (), B, K, NF, H)
    got = spmm_grad_w(*_t(idx, val, mask, dh), NF)
    assert got.shape == (NF, H) and got.dtype == torch.float32
    want_kernel = np.asarray(jax_grad_w(*_j(idx, val, mask, dh), NF))
    want_ref = np.asarray(jax_grad_w_ref(*_j(idx, val, mask, dh), NF))
    np.testing.assert_allclose(got.numpy(), want_kernel, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **F32_TOL)
    untouched = np.setdiff1d(np.arange(NF), idx.reshape(-1))
    assert not got.numpy()[untouched].any()        # rows no slot names stay 0


@pytest.mark.parametrize("B,K,NF,H", SHAPES)
def test_grad_w_replica_dim(B, K, NF, H):
    """(R,B,K) slots and (R,B,H) dh -> (R,NF,H): replica r scatters into its
    own W gradient."""
    rng = np.random.default_rng(3 * NF + H)
    R = 3
    idx, val, mask, dh = _inputs(rng, (R,), B, K, NF, H)
    got = spmm_grad_w(*_t(idx, val, mask, dh), NF)
    assert got.shape == (R, NF, H)
    torch.testing.assert_close(got, spmm_grad_w_ref(*_t(idx, val, mask, dh), NF),
                               rtol=0, atol=0)
    for r in range(R):
        want = jax_grad_w(*_j(idx[r], val[r], mask[r], dh[r]), NF)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "replica"])
def test_grad_w_all_masked_is_zero(lead):
    B, K, NF, H = 3, 5, 64, 128
    idx = np.zeros(lead + (B, K), np.int32)
    val = np.ones(lead + (B, K), np.float32)
    mask = np.zeros(lead + (B, K), bool)
    dh = np.random.default_rng(0).normal(size=lead + (B, H)).astype(np.float32)
    got = spmm_grad_w(*_t(idx, val, mask, dh), NF)
    assert got.shape == lead + (NF, H) and not got.any()


def test_grad_w_heavily_duplicated_rows():
    """All slots of all samples name the same two rows: one long run each."""
    rng = np.random.default_rng(4)
    B, K, NF, H = 4, 12, 50, 256
    idx = rng.integers(0, 2, (B, K)).astype(np.int32)
    val = rng.normal(size=(B, K)).astype(np.float32)
    mask = np.ones((B, K), bool)
    dh = rng.normal(size=(B, H)).astype(np.float32)
    got = spmm_grad_w(*_t(idx, val, mask, dh), NF).numpy()
    want = np.asarray(jax_grad_w(*_j(idx, val, mask, dh), NF))
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert not got[2:].any()


@pytest.mark.parametrize("B,K,NF,H", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "replica"])
def test_autograd_matches_custom_vjp(B, K, NF, H, dtype, lead):
    """dW and d feat_val of the port's Function against jax.vjp through the
    reference's custom VJP, on the same cotangent."""
    rng = np.random.default_rng(B * K + H)
    jdt, tdt = DTYPES[dtype]
    idx, val, mask, _ = _inputs(rng, lead, B, K, NF, H)
    w = rng.normal(size=lead + (NF, H)).astype(np.float32)
    ct = rng.normal(size=lead + (B, H)).astype(np.float32)

    tval = torch.from_numpy(val).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    out = spmm(torch.from_numpy(idx), tval, torch.from_numpy(mask), tw)
    out.backward(torch.from_numpy(ct).to(tdt))
    assert tw.grad.dtype == tdt and tval.grad.dtype == torch.float32

    def jvjp(i, v, m, ww, c):
        o, pull = jax.vjp(lambda v, ww: jax_spmm(i, v, m, ww), v, ww)
        return pull(c.astype(o.dtype))

    fn = jvjp
    for _ in lead:
        fn = jax.vmap(fn)
    jdval, jdw = fn(*_j(idx, val, mask), jnp.asarray(w, jdt), jnp.asarray(ct))
    np.testing.assert_allclose(tw.grad.float().numpy(), np.asarray(jdw, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(tval.grad.numpy(), np.asarray(jdval, np.float32),
                               **_tol(dtype))


def test_autograd_skips_what_is_not_asked():
    """Only the gradients asked for are computed: w alone, or feat_val alone."""
    rng = np.random.default_rng(9)
    idx, val, mask, _ = _inputs(rng, (), 4, 6, 40, 8)
    w = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    tval = torch.from_numpy(val).requires_grad_(True)
    spmm(torch.from_numpy(idx), tval, torch.from_numpy(mask), w).sum().backward()
    assert tval.grad is not None and w.grad is None
    w.requires_grad_(True)
    spmm(*_t(idx, val, mask), w).sum().backward()
    assert w.grad.shape == (40, 8)
    with torch.no_grad():
        assert not spmm(*_t(idx, val, mask), w).requires_grad


def test_nan_in_dh_reaches_row_of_masked_slot():
    """Sample 1's slots are all masked and name row 0; a NaN in its dh row
    poisons row 0 (scale 0 times NaN), in the port as in the reference."""
    rng = np.random.default_rng(5)
    B, K, NF, H = 3, 4, 20, 16
    idx, val, mask, dh = _inputs(rng, (), B, K, NF, H)
    idx[idx == 0] = 1
    idx[1, :] = 0
    mask[1, :] = False
    dh[1, 3] = np.nan
    got = spmm_grad_w(*_t(idx, val, mask, dh), NF).numpy()
    want = np.asarray(jax_grad_w(*_j(idx, val, mask, dh), NF))
    assert np.isnan(got[0, 3]) and np.isnan(want[0, 3])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[1:]).all()
    np.testing.assert_allclose(got[1:], want[1:], **F32_TOL)


def test_grad_w_cuda_path_rejects_cpu_tensors():
    """The launcher never falls back to the plain version: CPU tensors raise."""
    idx, val, mask, dh = _t(*_inputs(np.random.default_rng(0), (), 4, 5, 10, 8))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_grad_w_cuda(idx, val, mask, dh, 10)
    assert spmm_grad_w_cuda.launches == 0


@pytest.mark.parametrize("grad", ["w", "val"])
def test_masked_slot_scale_is_exactly_zero(grad):
    """The reference computes ``val * mask`` as a select (XLA rewrites a
    product with a converted bool): a masked slot with an infinite val adds
    nothing to dW, and a masked slot whose W row holds NaN gets a d feat_val
    of exactly 0. The port matches both."""
    rng = np.random.default_rng(12)
    B, K, NF, H = 4, 8, 20, 16
    idx, val, mask, dh = _inputs(rng, (), B, K, NF, H)
    idx[idx == 0] = 1
    mask[2, 5:] = False
    idx[2, 5:] = 0
    if grad == "w":
        val[2, 6] = np.inf
        got = spmm_grad_w(*_t(idx, val, mask, dh), NF).numpy()
        want = np.asarray(jax_grad_w(*_j(idx, val, mask, dh), NF))
    else:
        w = rng.normal(size=(NF, H)).astype(np.float32)
        w[0, 3] = np.nan
        tval = torch.from_numpy(val).requires_grad_(True)
        spmm(torch.from_numpy(idx), tval, torch.from_numpy(mask),
             torch.from_numpy(w)).backward(torch.from_numpy(dh))
        got = tval.grad.numpy()
        _, pull = jax.vjp(lambda v: jax_spmm(jnp.asarray(idx), v, jnp.asarray(mask),
                                             jnp.asarray(w)), jnp.asarray(val))
        want = np.asarray(pull(jnp.asarray(dh))[0])
        assert (got[2, 5:] == 0).all()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_sort_rows_cuda_rejects_cpu_tensors():
    """The counting sort's launcher never falls back either."""
    with pytest.raises(ValueError, match="CUDA"):
        sort_rows_cuda(torch.zeros((2, 5), dtype=torch.int32), 10)
    assert sort_rows_cuda.launches == 0
