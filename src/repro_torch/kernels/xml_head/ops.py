"""Public entry for the XML head's product ``h @ w2`` (``models/xml_mlp.py``).

``head_matmul`` is a ``torch.autograd.Function``: its forward and the
gradient for ``w2`` are ``torch.matmul``; the gradient for ``h``,
``dh = dlogits · w2ᵀ`` with K = NC (670,091 at Amazon-670K), is the
split-K kernel ``csrc/xml_dh_gemm.cu`` on CUDA tensors and the plain
``ref.dh_ref`` on CPU tensors. There is no switch that sends a CUDA tensor
to the plain version. The reference has no kernel here (XLA runs the
product); the port has one because cuBLAS's batched kernel for this shape
reached about a tenth of the card's f32 rate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .ref import dh_ref

BM, BN, BK = 256, 128, 8        # csrc/xml_dh_gemm.cu's output tile and K-step
BLOCKS_PER_SM = 1               # its launch bounds (229 registers a thread): one block an SM
WORKSPACE_BYTES = 32 << 20      # the most the split partials may take


def head_matmul(h, w2):
    """h (…, B, H) @ w2 (…, H, NC), the same optional leading replica dim on
    both. Differentiable with respect to both; saves only ``h`` and ``w2``."""
    if h.shape[:-2] != w2.shape[:-2] or h.shape[-1] != w2.shape[-2]:
        raise ValueError(f"head_matmul needs h (…, B, H) and w2 (…, H, NC) with the same "
                         f"leading dims; got {tuple(h.shape)} and {tuple(w2.shape)}")
    return _HeadMatmul.apply(h, w2)


class _HeadMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w2):
        ctx.save_for_backward(h, w2)
        return torch.matmul(h, w2)

    @staticmethod
    def backward(ctx, grad_out):
        h, w2 = ctx.saved_tensors
        grad_h = grad_w2 = None
        if ctx.needs_input_grad[0]:
            if grad_out.device.type == "cpu" and w2.device.type == "cpu":
                grad_h = dh_ref(grad_out, w2)
            else:
                grad_h = xml_dh_gemm_cuda(grad_out.contiguous(), w2.contiguous())
        if ctx.needs_input_grad[1]:
            grad_w2 = torch.matmul(h.transpose(-1, -2), grad_out)
        return grad_h, grad_w2


def split_count(R: int, B: int, H: int, NC: int, n_sms: int) -> tuple[int, int]:
    """(splits, kchunk): K cut into ``splits`` chunks of ``kchunk`` columns
    (a multiple of BK; the last may be shorter, none is empty) so that the
    R·⌈B/BM⌉·⌈H/BN⌉ output tiles times the splits fill ``n_sms`` SMs in
    about one wave, within WORKSPACE_BYTES of partials."""
    steps = -(-NC // BK)
    tiles = R * -(-B // BM) * -(-H // BN)
    splits = min((n_sms * BLOCKS_PER_SM) // max(tiles, 1), steps,
                 WORKSPACE_BYTES // max(4 * R * B * H, 1))
    if splits <= 1:
        return 1, steps * BK
    per = -(-steps // splits)
    return -(-steps // per), per * BK


def xml_dh_gemm_cuda(g, w2):
    """Launch the kernel: g (…, B, NC) · w2 (…, H, NC)ᵀ -> (…, B, H), f32,
    contiguous, on one CUDA device. Raises on anything it does not take."""
    if g.device.type != "cuda" or w2.device != g.device:
        raise ValueError("xml_dh_gemm_cuda needs both tensors on one CUDA device")
    if g.dtype != torch.float32 or w2.dtype != torch.float32:
        raise TypeError(f"xml_dh_gemm_cuda needs float32 tensors; got {g.dtype}, {w2.dtype}")
    if g.ndim not in (2, 3) or w2.ndim != g.ndim or g.shape[:-2] != w2.shape[:-2] \
            or g.shape[-1] != w2.shape[-1]:
        raise ValueError(f"xml_dh_gemm_cuda needs g (R, B, NC) and w2 (R, H, NC), or both 2-D; "
                         f"got {tuple(g.shape)} and {tuple(w2.shape)}")
    if not (g.is_contiguous() and w2.is_contiguous()):
        raise ValueError("xml_dh_gemm_cuda needs contiguous tensors")
    (B, NC), H = g.shape[-2:], w2.shape[-2]
    R = g.shape[0] if g.ndim == 3 else 1
    n_sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    splits, kchunk = split_count(R, B, H, NC, n_sms)
    out = torch.empty(g.shape[:-1] + (H,), dtype=torch.float32, device=g.device)
    part = (torch.empty(splits * R * B * H, dtype=torch.float32, device=g.device)
            if splits > 1 else None)
    with torch.cuda.device(g.device):
        err = _build.library().xml_dh_gemm(
            g.data_ptr(), w2.data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), R, B, H, NC, splits, kchunk,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    _build.check(err, "xml_dh_gemm")
    _build.count_launch(xml_dh_gemm_cuda)
    return out


xml_dh_gemm_cuda.launches = 0  # calls that launched the kernel since the last reset
