"""The LM head (``models/layers.py`` ``head_logits``, called by
``models/model.py`` ``_logits`` and ``layers.unembed``).

On bf16 inputs on a card the head runs as bf16 GEMMs with f32 outputs, the
backward on the f32 dlogits split into bf16 hi + lo; everything else keeps
``x.float() @ w.float().T``. On the CPU the split path runs with the product
emulated (``emulated_mm``: on bf16 inputs, the tensor core's exact
products with f32 sums), reached by naming the CPU a split device. On a
card (marker ``cuda``) the real products against f64 products and the f32
expression."""
from __future__ import annotations

import types

import pytest
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.utils import trace

B, S, D, V = 2, 24, 64, 200          # V on no tile multiple


def emulated_mm(a, b):
    return a.float() @ b.float()


def rel(a, b) -> float:
    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double()).clamp_min(1e-30)).item()


def steps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps lie between a and b, element by element (the
    bits as integers in the order of the values; ±0 one value)."""
    def order(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def agree_as_bf16(a: torch.Tensor, b: torch.Tensor) -> None:
    """Two bf16 gradients of one f32 sum taken two ways: equal on 99% of the
    elements, the rest one bf16 step apart, or, where the sum nearly
    cancels, within 2⁻¹⁴ of the largest element (the f32 error the split
    may reach, which near zero spans many steps)."""
    assert a.dtype == b.dtype == torch.bfloat16
    steps = steps_apart(a, b)
    assert (steps == 0).float().mean() >= 0.99
    gap = (a.float() - b.float()).abs()
    assert ((steps <= 1) | (gap <= 2 ** -14 * b.float().abs().max())).all()


def head_spans() -> list:
    return [s for s in trace.spans() if s.name == "lm.head"]


def _inputs(seed=0, dtype=torch.bfloat16, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, S, D, generator=gen, device=device).to(dtype)
    w = (torch.randn(V, D, generator=gen, device=device) * D ** -0.5).to(dtype)
    gain = (0.1 * torch.randn(D, generator=gen, device=device)).to(dtype)
    return x, w, gain


def _logits(tied: bool, cap: float, x, w, gain):
    """``_logits`` of a model whose head is ``w``: its ``lm_head``, or tied,
    its embedding table through ``unembed``."""
    cfg = types.SimpleNamespace(tie_embeddings=tied, logits_softcap=cap, norm_eps=1e-5)
    params = {"final_norm": gain, **({"embed": {"table": w}} if tied else {"lm_head": w})}
    return MDL._logits(cfg, params, x)


def _run(tied, cap, x, w, gain, seed=1):
    """(logits, the head's bf16 gradients: of its input, the normed x, and of
    its weight) under a fixed f32 cotangent."""
    leaves = [t.clone().requires_grad_() for t in (x, w, gain)]
    seen = {}
    head = L.head_logits

    def recording(xn, wt):
        xn.register_hook(lambda g: seen.setdefault("dx", g))
        return head(xn, wt)

    L.head_logits = recording
    try:
        logits = _logits(tied, cap, *leaves)
    finally:
        L.head_logits = head
    cot = torch.randn(logits.shape, generator=torch.Generator().manual_seed(seed))
    _, dw, _ = torch.autograd.grad(logits, leaves, cot.to(logits.device))
    return logits.detach(), (seen["dx"], dw)


@pytest.fixture
def split_on_cpu(monkeypatch):
    """The CPU as a split device, with the emulated product."""
    monkeypatch.setattr(L, "SPLIT_DEVICES", ("cpu",))
    monkeypatch.setattr(L, "mm_f32", emulated_mm)
    trace.clear()
    yield monkeypatch
    trace.clear()


def test_the_split_reconstructs_f32_within_2_pow_minus_16():
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(67, 301, generator=gen) * torch.exp(8 * torch.randn(67, 301, generator=gen))
    hl = L.split_bf16(g)
    hi, lo = hl[:, 0], hl[:, 1]
    assert hl.dtype == torch.bfloat16 and hl.shape == (67, 2, 301)
    assert torch.equal(hi, g.bfloat16())
    assert torch.equal(lo, (g - hi.float()).bfloat16())
    assert (((hi.float() + lo.float()) - g).abs() <= 2 ** -16 * g.abs()).all()


CHUNKS = [(B * S, 2 * V), (16, 64), (7, 150), (1, 2 * V)]   # (rows, depth)


@pytest.mark.parametrize("rows,depth", CHUNKS, ids=[f"rows{r}-depth{d}" for r, d in CHUNKS])
def test_split_grads_match_f32_products_and_each_other(rows, depth):
    """The f32 dx and dW before rounding, through the emulated product,
    against the f32 products of the unsplit dlogits; every chunking of rows
    and of dx's depth gives the unchunked result."""
    x, w, _ = _inputs()
    x = x.reshape(B * S, D)
    g = torch.randn(B * S, V, generator=torch.Generator().manual_seed(2))
    dx, dw = L.split_grads(g, x, w, emulated_mm, rows, depth)
    assert dx.dtype == dw.dtype == torch.float32
    assert rel(dx, g @ w.float()) <= 2 ** -14
    assert rel(dw, g.T @ x.float()) <= 2 ** -14
    dx1, dw1 = L.split_grads(g, x, w, emulated_mm, B * S, 2 * V)
    assert rel(dx, dx1) <= 1e-6 and rel(dw, dw1) <= 1e-6


CASES = [(tied, cap, chunks) for tied in (False, True) for cap in (0.0, 30.0)
         for chunks in (None, (16, 64), (7, 150))]


@pytest.mark.parametrize("tied,cap,chunks", CASES,
                         ids=[f"{'tied' if t else 'untied'}-cap{c:g}-"
                              + ("whole" if k is None else "rows{}-depth{}".format(*k))
                              for t, c, k in CASES])
def test_the_split_head_matches_the_f32_expression(tied, cap, chunks, split_on_cpu):
    """``_logits`` (untied) and ``unembed`` (tied), softcap on and off, one
    GEMM a gradient or several, against the f32 expression under autograd:
    logits to 1e-6, the bf16 gradients as ``agree_as_bf16`` says."""
    if chunks is not None:
        rows, depth = chunks
        split_on_cpu.setattr(L, "SPLIT_BYTES", rows * 4 * V)
        split_on_cpu.setattr(L, "SPLIT_DEPTH", depth)
    else:
        split_on_cpu.setattr(L, "SPLIT_DEPTH", 2 * V)
    x, w, gain = _inputs()
    got, got_grads = _run(tied, cap, x, w, gain)
    assert [s.counters["path"] for s in head_spans()] == ["bf16_split"]
    split_on_cpu.setattr(L, "SPLIT_DEVICES", ())
    want, want_grads = _run(tied, cap, x, w, gain)
    assert head_spans()[-1].counters["path"] == "f32"
    assert got.dtype == torch.float32 and rel(got, want) <= 1e-6
    for a, b in zip(got_grads, want_grads):
        agree_as_bf16(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_other_inputs_keep_the_f32_expression_to_the_bit(dtype):
    """f32 and fp16 inputs, and bf16 CPU tensors: ``x.float() @ w.float().T``
    and its autograd, bit for bit, in an ``lm.head`` span of path f32."""
    x, w, _ = _inputs(dtype=dtype)
    trace.clear()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = L.head_logits(xa, wa)
    assert [s.counters["path"] for s in head_spans()] == ["f32"]
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = xb.float() @ wb.float().T
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    got.backward(cot)
    want.backward(cot)
    assert torch.equal(got, want)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad)


def test_the_split_takes_bf16_on_both_sides(split_on_cpu):
    x, w, _ = _inputs()
    assert L.takes_split(x, w)
    assert not L.takes_split(x, w.float())
    assert not L.takes_split(x.half(), w.half())
    split_on_cpu.setattr(L, "SPLIT_DEVICES", ("cuda",))
    assert not L.takes_split(x, w)


def test_the_split_rows_keep_within_the_byte_budget_and_the_depth():
    assert L.split_rows(20480) == L.SPLIT_DEPTH // 2 == 4096      # the Moonlight cell's head
    assert L.split_rows(163840) * 4 * 163840 <= L.SPLIT_BYTES
    assert 2 * L.split_rows(256) <= L.SPLIT_DEPTH
    assert L.split_rows(L.SPLIT_BYTES) == 1


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_on_a_card_the_split_head_matches_its_emulation(tied, cuda):
    """Real bf16 GEMMs: logits against the f32 expression on the card to
    1e-6, the f32 gradients against f64 products to 2⁻¹⁴, and the bf16
    gradients against the f32 expression as on the CPU; two chunks."""
    x, w, gain = _inputs(device=cuda)
    trace.clear()
    old = L.SPLIT_BYTES, L.SPLIT_DEPTH
    L.SPLIT_BYTES, L.SPLIT_DEPTH = (B * S // 2) * 4 * V, 128
    try:
        got, got_grads = _run(tied, 0.0, x, w, gain)
    finally:
        L.SPLIT_BYTES, L.SPLIT_DEPTH = old
    assert [s.counters["path"] for s in head_spans()] == ["bf16_split"]
    xf = x.reshape(B * S, D)
    g = torch.randn(B * S, V, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    dx, dw = L.split_grads(g, xf, w, L.mm_f32, 16, 128)
    assert rel(dx, g.double() @ w.double()) <= 2 ** -14
    assert rel(dw, g.double().T @ xf.double()) <= 2 ** -14
    devices = L.SPLIT_DEVICES
    L.SPLIT_DEVICES = ()
    try:
        want, want_grads = _run(tied, 0.0, x, w, gain)
    finally:
        L.SPLIT_DEVICES = devices
    assert rel(got, want) <= 1e-6
    for a, b in zip(got_grads, want_grads):
        agree_as_bf16(a, b)


@pytest.mark.cuda
def test_on_a_card_the_cells_head_keeps_its_gradients_within_2_pow_minus_14(cuda):
    """At the Moonlight cell's widths (4,096 of its 16,384 rows), the split's
    f32 gradients against f64 products of a softmax's dlogits: the tensor
    cores' truncating accumulators stay within 2⁻¹⁴ at ``SPLIT_DEPTH`` terms
    a GEMM (one GEMM over dx's 40,960 read 6.4e-5, just above)."""
    t, d, v = 4096, 2048, 20480
    gen = torch.Generator(cuda).manual_seed(7)
    x = torch.randn(t, d, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(v, d, device=cuda, generator=gen) * 0.02).bfloat16()
    tgt = torch.randint(0, v, (t,), device=cuda, generator=gen)
    g = torch.softmax(L.mm_f32(x, w.T), -1)
    g[torch.arange(t, device=cuda), tgt] -= 1
    g /= 4 * t
    dx, dw = L.split_grads(g, x, w, L.mm_f32, L.split_rows(v), L.SPLIT_DEPTH)
    assert rel(dx, g.double() @ w.double()) <= 2 ** -14
    assert rel(dw, g.double().T @ x.double()) <= 2 ** -14
