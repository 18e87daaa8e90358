"""Public entry for the grouped MoE FFN kernel.

Port of ``repro/kernels/moe_gmm/ops.py``. CPU tensors run the plain version
(``ref.moe_ffn_gmm_ref``), CUDA tensors the kernel (``csrc/moe_gmm.cu``);
nothing sends a CUDA tensor to the plain version. The reference's
``block_c``/``block_f`` are TPU tile sizes with no meaning for the CUDA
kernel (its tiles are fixed at 64 x 64) and are dropped from the signature.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .ref import moe_ffn_gmm_ref


def moe_ffn_gmm(buf, wi, wg, wo):
    """Fused SwiGLU grouped matmul. buf (E,C,D) -> (E,C,D)."""
    if all(t.device.type == "cpu" for t in (buf, wi, wg, wo)):
        return moe_ffn_gmm_ref(buf, wi, wg, wo)
    return moe_ffn_gmm_cuda(buf, wi, wg, wo)


def moe_ffn_gmm_cuda(buf, wi, wg, wo):
    """Launch the CUDA kernel; raises on anything it does not take.

    The (E, C, F) f32 intermediate goes through a scratch the wrapper
    allocates (csrc/moe_gmm.cu says why)."""
    tensors = (buf, wi, wg, wo)
    if buf.device.type != "cuda" or any(t.device != buf.device for t in tensors):
        raise ValueError("moe_ffn_gmm_cuda needs buf, wi, wg and wo on one CUDA device")
    if buf.dtype not in _build.DTYPE_CODES or any(t.dtype != buf.dtype for t in tensors):
        raise TypeError("moe_ffn_gmm_cuda needs buf, wi, wg and wo all float32 or all bfloat16")
    if any(t.ndim != 3 for t in tensors):
        raise ValueError("moe_ffn_gmm_cuda needs 3-D buf, wi, wg and wo")
    e, c, d = buf.shape
    f = wi.shape[-1]
    if wi.shape != (e, d, f) or wg.shape != (e, d, f) or wo.shape != (e, f, d) or f == 0:
        raise ValueError(f"shapes buf {tuple(buf.shape)}, wi {tuple(wi.shape)}, "
                         f"wg {tuple(wg.shape)}, wo {tuple(wo.shape)} do not match")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_ffn_gmm_cuda needs contiguous tensors")
    out = torch.empty_like(buf)
    scratch = torch.empty((e, c, f), dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        err = _build.library().moe_ffn_gmm(
            buf.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), e, c, d, f, _build.DTYPE_CODES[buf.dtype],
            torch.cuda.current_stream(buf.device).cuda_stream,
        )
    _build.check(err, "moe_ffn_gmm")
    moe_ffn_gmm_cuda.launches += 1
    return out


moe_ffn_gmm_cuda.launches = 0  # kernel launches since the last reset
