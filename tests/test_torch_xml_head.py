"""The XML head's product ``head_matmul`` (``kernels/xml_head``): its value
and both gradients against autograd through ``torch.matmul``, the model's
gradients with it in place of ``torch.matmul``, the split rule of the
``dh`` kernel, and (on a card) the kernel against its plain version.

On the CPU the forward, ``dW2`` and ``dh`` are the same ``torch.matmul``
calls autograd makes (``mm``/``bmm`` of the same operands), so the CPU
cases hold them to the bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.xml_head import ops
from repro_torch.kernels.xml_head.ops import head_matmul, split_count, xml_dh_gemm_cuda
from repro_torch.kernels.xml_head.ref import dh_ref
from repro_torch.models import xml_mlp

# (R or None for 2-D, B, H, NC): odd NC, and B and H off every tile multiple
SHAPES = [(None, 5, 7, 131), (3, 37, 45, 1001), (1, 130, 129, 17), (4, 1, 3, 5),
          (None, 257, 130, 2049)]


def _inputs(shape, seed=0, device="cpu"):
    r, b, h, nc = shape
    lead = () if r is None else (r,)
    gen = torch.Generator(device=device).manual_seed(seed)
    hid = torch.randn(lead + (b, h), generator=gen, device=device)
    w2 = torch.randn(lead + (h, nc), generator=gen, device=device) / h ** 0.5
    g = torch.randn(lead + (b, nc), generator=gen, device=device)
    return hid, w2, g


@pytest.fixture
def no_library(monkeypatch):
    """Fail on any call that would build or load the kernels."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel library")
    monkeypatch.setattr(_build, "library", refuse)
    xml_dh_gemm_cuda.launches = 0
    yield
    assert xml_dh_gemm_cuda.launches == 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_head_matmul_value_and_grads_match_autograd(shape, no_library):
    hid, w2, g = _inputs(shape)
    a_h, a_w = hid.clone().requires_grad_(), w2.clone().requires_grad_()
    out = head_matmul(a_h, a_w)
    out.backward(g)
    b_h, b_w = hid.clone().requires_grad_(), w2.clone().requires_grad_()
    want = torch.matmul(b_h, b_w)
    want.backward(g)
    assert torch.equal(out, want)
    assert torch.equal(a_h.grad, b_h.grad)
    assert torch.equal(a_w.grad, b_w.grad)
    # one input needing a gradient computes that one alone
    c_w = w2.clone().requires_grad_()
    head_matmul(hid, c_w).backward(g)
    assert torch.equal(c_w.grad, b_w.grad)


def test_head_matmul_refuses_mismatched_shapes():
    hid, w2, _ = _inputs((3, 4, 5, 6))
    with pytest.raises(ValueError):
        head_matmul(hid, w2[0])          # no broadcast over the replica dim
    with pytest.raises(ValueError):
        head_matmul(hid[..., :4], w2)    # H differs


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_head_loss_grads_unchanged_on_cpu(sparse, monkeypatch, no_library):
    """The model's loss and every gradient equal those of the same model
    with ``torch.matmul`` in ``head_matmul``'s place, bit for bit."""
    nf, nc, hd, r, b, k = 64, 33, 12, 2, 9, 5
    cfg = xml_mlp.XMLMLPConfig(n_features=nf, n_classes=nc, hidden=hd)
    gen = torch.Generator().manual_seed(3)
    params = {n: torch.stack([p[n] for p in (xml_mlp.init_params(cfg, gen) for _ in range(r))])
              for n in ("w1", "b1", "w2", "b2")}
    rng = np.random.default_rng(4)
    batch = {
        "feat_idx": torch.from_numpy(rng.integers(0, nf, (r, b, k), dtype=np.int32)),
        "feat_val": torch.from_numpy(rng.random((r, b, k), dtype=np.float32)),
        "feat_mask": torch.from_numpy(rng.random((r, b, k)) < 0.8),
        "label_idx": torch.from_numpy(rng.integers(0, nc, (r, b, 3), dtype=np.int32)),
        "label_mask": torch.from_numpy(rng.random((r, b, 3)) < 0.7),
        "sample_mask": torch.from_numpy(np.arange(b) < b - 2).expand(r, b).contiguous(),
    }

    def grads():
        if sparse:
            (loss, _), g = xml_mlp.loss_and_sparse_grad(cfg, params, batch)
            g = dict(g, w1=g["w1"].vals)
        else:
            p = {n: v.clone().requires_grad_() for n, v in params.items()}
            loss, _ = xml_mlp.loss_fn(cfg, p, batch)
            loss.sum().backward()
            g = {n: v.grad for n, v in p.items()}
        return loss, g

    loss, got = grads()
    monkeypatch.setattr(xml_mlp, "head_matmul", torch.matmul)
    want_loss, want = grads()
    assert torch.equal(loss, want_loss)
    assert got.keys() == want.keys()
    for n in got:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("shape", [(4, 256, 128, 670_091), (1, 256, 128, 670_091),
                                   (4, 32, 32, 128), (1, 7, 3, 5), (2, 300, 130, 70_001),
                                   (64, 256, 128, 1000), (1, 4096, 512, 670_091), (1, 1, 1, 0)],
                         ids=str)
def test_split_count_covers_k_once_within_the_workspace(shape):
    """Every split is a nonempty multiple of the K-step (the last may be
    shorter), together they cover K once, the partials fit the workspace,
    and the blocks fill at most one wave of the card's 132 SMs."""
    r, b, h, nc = shape
    splits, kchunk = split_count(r, b, h, nc, 132)
    assert splits >= 1 and kchunk % ops.BK == 0
    if nc:
        assert (splits - 1) * kchunk < nc <= splits * kchunk
    if splits > 1:
        assert 4 * splits * r * b * h <= ops.WORKSPACE_BYTES
        tiles = r * -(-b // ops.BM) * -(-h // ops.BN)
        assert tiles * splits <= 132 * ops.BLOCKS_PER_SM


def test_split_count_at_the_main_shapes():
    """The cell's R = 4 call fills the card's 132 SMs with 4 tiles x 33
    splits; the sharded placement's 2-D call (R = 1) gets four times the
    splits."""
    assert split_count(4, 256, 128, 670_091, 132) == (33, 2539 * 8)
    assert split_count(1, 256, 128, 670_091, 132) == (132, 635 * 8)


# ---- on the card (skipped without one) -------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    return torch.device("cuda")


def _check_against_exact(g, w2, got):
    """The kernel's f32 sums against the f64 product: each element within
    1e-6 of sum_k |g_k * w_k|. Sums of f32 products in any order stay inside
    that (their rounding grows with the partial sums; on an H100 at
    K = 670,091 the kernel read at most 2.4e-8 of it, cuBLAS's bmm 2.4e-7);
    one term of K left out or added twice does not, where a term is over
    1e-6 of the sum of magnitudes."""
    exact = torch.matmul(g.double(), w2.double().transpose(-1, -2))
    scale = torch.matmul(g.abs().double(), w2.abs().double().transpose(-1, -2))
    err = (got.double() - exact).abs()
    assert bool((err <= 1e-6 * scale).all()), float((err / scale.clamp_min(1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 128, 670_091), (1, 256, 128, 670_091),
                                   (4, 32, 32, 128), (None, 256, 32, 128)] + SHAPES, ids=str)
def test_kernel_matches_the_plain_version(shape, cuda):
    _, w2, g = _inputs(shape, seed=1, device=cuda)
    got = xml_dh_gemm_cuda(g, w2)
    torch.cuda.synchronize()
    plain = dh_ref(g, w2)
    assert got.shape == plain.shape
    _check_against_exact(g, w2, plain)   # cuBLAS's f32 sums meet the tolerance too
    _check_against_exact(g, w2, got)
    again = xml_dh_gemm_cuda(g, w2)
    assert torch.equal(got, again), "two calls differ"


@pytest.mark.cuda
def test_head_matmul_backward_runs_the_kernel_once(cuda):
    hid, w2, g = _inputs((4, 64, 128, 1001), device=cuda)
    hid.requires_grad_()
    w2.requires_grad_()
    xml_dh_gemm_cuda.launches = 0
    head_matmul(hid, w2).backward(g)
    assert xml_dh_gemm_cuda.launches == 1
    _check_against_exact(g, w2.detach(), hid.grad)
    with torch.no_grad():
        head_matmul(hid, w2)
    assert xml_dh_gemm_cuda.launches == 1


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    _, w2, g = _inputs((2, 16, 8, 33), device=cuda)
    with pytest.raises(TypeError):
        xml_dh_gemm_cuda(g.bfloat16(), w2.bfloat16())
    with pytest.raises(ValueError):
        xml_dh_gemm_cuda(g[..., :32], w2[..., :32])       # non-contiguous
    with pytest.raises(ValueError):
        xml_dh_gemm_cuda(g, w2[..., :32].contiguous())    # NC differs
    with pytest.raises(ValueError):
        xml_dh_gemm_cuda(g, w2[:1].contiguous())          # R differs
    with pytest.raises(ValueError):
        xml_dh_gemm_cuda(g.cpu(), w2)
