"""Public entry for the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ops.py``. CPU tensors run the plain
version (``ref.attention_ref``), CUDA tensors the kernel
(``csrc/flash_attention.cu``); nothing sends a CUDA tensor to the plain
version. The reference's ``block_q``/``block_k`` are TPU tile sizes with no
meaning for the CUDA kernel (it picks its own tiles) and are dropped from
the signature.

The kernel has two paths, chosen by dtype (``PATHS``): bf16 runs both
products on the tensor cores (``mma.sync``, P as a bf16 hi/lo pair), f32
keeps the reference's f32 math on the CUDA cores, since bf16 or TF32
products cannot meet its f32 tolerance. Neither is a fallback for the
other: each raises on what it does not take.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, refuse_grad

from .ref import attention_ref

# head dims the kernel is compiled for, on both paths (csrc/flash_attention.cu)
HEAD_DIMS = tuple(range(16, 129, 16))
# the kernel's path for each dtype
PATHS = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}


def flash_attention(q, k, v, *, causal=True, window=0):
    """GQA-native attention. q (B,Sq,Hq,hd); k/v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd).
    Forward only: raises where autograd would record it (``refuse_grad``)."""
    refuse_grad("flash_attention", q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """Launch the CUDA kernel; raises on anything it does not take."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA device")
    if q.dtype not in PATHS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda needs q, k and v all float32 or all bfloat16")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,Hq,hd) and k/v (B,Skv,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, not {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k and v")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, hd, int(causal), int(window), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention_cuda,
                        tensor_core_launches=PATHS[q.dtype] == "tensor_core")
    return out


flash_attention_cuda.launches = 0  # kernel launches since the last reset
flash_attention_cuda.tensor_core_launches = 0  # of them, on the bf16 path
