"""Public entry for the grouped MoE FFN kernel.

Port of ``repro/kernels/moe_gmm/ops.py``. CPU tensors run the plain version
(``ref.moe_ffn_gmm_ref``), CUDA tensors the kernel (``csrc/moe_gmm.cu``);
nothing sends a CUDA tensor to the plain version. The reference's
``block_c``/``block_f`` are TPU tile sizes with no meaning for the CUDA
kernel and are dropped from the signature.

The kernel has two paths, chosen by dtype (``PATHS``): bf16 runs on the
tensor cores (``wgmma`` fed by TMA), f32 keeps the reference's f32 math on
the CUDA cores, since bf16 or TF32 products cannot meet its f32 tolerance.
Neither is a fallback for the other: each raises on what it does not take.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, refuse_grad

from .ref import moe_ffn_gmm_ref

# the kernel's path for each dtype
PATHS = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}


def moe_ffn_gmm(buf, wi, wg, wo):
    """Fused SwiGLU grouped matmul. buf (E,C,D) -> (E,C,D).
    Forward only: raises where autograd would record it (``refuse_grad``)."""
    refuse_grad("moe_ffn_gmm", buf, wi, wg, wo)
    if all(t.device.type == "cpu" for t in (buf, wi, wg, wo)):
        return moe_ffn_gmm_ref(buf, wi, wg, wo)
    return moe_ffn_gmm_cuda(buf, wi, wg, wo)


def _pad_to_8(t, dims):
    """``t`` zero-padded at the end of each of ``dims`` to a multiple of 8."""
    pad = [0] * (2 * t.ndim)
    for d in dims:
        pad[2 * (t.ndim - 1 - d) + 1] = -t.shape[d] % 8
    return F.pad(t, pad) if any(pad) else t


def moe_ffn_gmm_cuda(buf, wi, wg, wo):
    """Launch the CUDA kernel; raises on anything it does not take.

    The (E, C, F) intermediate goes through a scratch the wrapper allocates,
    in the path's dtype (csrc/moe_gmm.cu says why). On the bf16 path the
    tensor maps need 16-byte row strides: D and F are zero-padded to
    multiples of 8, as the reference pads to its blocks. Padded F columns
    add silu(0) * 0 = 0; padded D columns are cut from the output."""
    refuse_grad("moe_ffn_gmm", buf, wi, wg, wo)
    tensors = (buf, wi, wg, wo)
    if buf.device.type != "cuda" or any(t.device != buf.device for t in tensors):
        raise ValueError("moe_ffn_gmm_cuda needs buf, wi, wg and wo on one CUDA device")
    if buf.dtype not in PATHS or any(t.dtype != buf.dtype for t in tensors):
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
    tensor_core = PATHS[buf.dtype] == "tensor_core"
    if tensor_core:
        buf, wi, wg, wo = (_pad_to_8(buf, (2,)), _pad_to_8(wi, (1, 2)), _pad_to_8(wg, (1, 2)),
                           _pad_to_8(wo, (1, 2)))
    dp, fp = buf.shape[2], wi.shape[2]
    out = torch.empty_like(buf)
    scratch = torch.empty((e, c, fp), dtype=buf.dtype, device=buf.device)
    with torch.cuda.device(buf.device):
        err = _build.library().moe_ffn_gmm(
            buf.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), e, c, dp, fp, _build.DTYPE_CODES[buf.dtype],
            torch.cuda.current_stream(buf.device).cuda_stream,
        )
    _build.check(err, "moe_ffn_gmm")
    _build.count_launch(moe_ffn_gmm_cuda, tensor_core_launches=tensor_core)
    return out[..., :d] if dp != d else out


moe_ffn_gmm_cuda.launches = 0  # kernel launches since the last reset
moe_ffn_gmm_cuda.tensor_core_launches = 0  # of them, on the bf16 path
