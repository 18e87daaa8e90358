"""Public entry for the SSD chunked-scan kernel.

Port of ``repro/kernels/ssd_scan/ops.py``. CPU tensors run the plain
version (``ref.ssd_scan_ref``), CUDA tensors the kernel
(``csrc/ssd_scan.cu``); nothing sends a CUDA tensor to the plain version.
``chunk`` changes the result's rounding and stays an argument.

The kernel has one path for every dtype (``PATHS``): chunks in parallel in
three passes, every product on the tensor cores (``mma.sync``): products
of two bf16 operands exact, those with an f32 operand in a 3xTF32 split,
the carry-in against the states as three bf16 pieces; all keep f32
accuracy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .ref import ssd_scan_ref

# the kernel's path for each dtype of x (and of Bm/Cm): the tensor cores for
# both, so ``tensor_core_launches`` equals ``launches``. Both are kept as
# flash_attention and moe_gmm have them, so that one check (every launch on
# the tensor cores) covers the three kernels alike.
PATHS = {torch.float32: "tensor_core", torch.bfloat16: "tensor_core"}


def ssd_scan(x, dA, Bm, Cm, chunk: int = 256):
    """Chunked SSD scan. Returns (y (B,L,H,P) f32, final (B,H,P,N) f32)."""
    if all(t.device.type == "cpu" for t in (x, dA, Bm, Cm)):
        return ssd_scan_ref(x, dA, Bm, Cm, chunk)
    return ssd_scan_cuda(x, dA, Bm, Cm, chunk)


def ssd_scan_cuda(x, dA, Bm, Cm, chunk: int = 256):
    """Launch the CUDA kernel; raises on anything it does not take.

    ``x`` must be contiguous; ``dA`` is taken in f32. ``Bm`` and ``Cm`` may
    be any strided (B,L,H,N) views with a contiguous last dim and equal
    strides, such as the per-head broadcast of a (B,L,N) tensor (head
    stride 0): the kernel reads them in place, with no copy. One call
    launches three kernels (chunk states, state passing, chunk outputs),
    which pass a (B,H,L) f32, the chunk states (B,H,L/chunk,P,N) f32 and
    the states entering each chunk (B,H,L/chunk,3,P,N) bf16 through
    scratch allocated here."""
    tensors = (x, dA, Bm, Cm)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan_cuda needs x, dA, Bm and Cm on one CUDA device")
    codes = _build.DTYPE_CODES
    if x.dtype not in PATHS or Bm.dtype not in PATHS or Cm.dtype != Bm.dtype:
        raise TypeError("ssd_scan_cuda needs float32/bfloat16 x and Bm/Cm of one such dtype")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError("ssd_scan_cuda needs x (B,L,H,P) and Bm/Cm (B,L,H,N)")
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if dA.shape != (b, l, h) or Bm.shape[:3] != (b, l, h):
        raise ValueError(f"shapes x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"Bm {tuple(Bm.shape)} do not match")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"L={l} must be a multiple of chunk={chunk}")
    if not x.is_contiguous() or Bm.stride() != Cm.stride() or Bm.stride(-1) != 1:
        raise ValueError("ssd_scan_cuda needs contiguous x and Bm/Cm with equal strides "
                         "and a contiguous last dim")
    dA = dA.float().contiguous()
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = l // chunk
    a_cs = torch.empty((b, h, l), dtype=torch.float32, device=x.device)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=x.device)
    states_in = torch.empty((b, h, nc, 3, p, n), dtype=torch.bfloat16, device=x.device)
    sb, sl, sh, _ = Bm.stride()
    with torch.cuda.device(x.device):
        err = _build.library().ssd_scan(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            final.data_ptr(), a_cs.data_ptr(), states.data_ptr(), states_in.data_ptr(),
            b, l, h, p, n, chunk, sb, sl, sh, codes[x.dtype], codes[Bm.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "ssd_scan")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.tensor_core_launches += PATHS[x.dtype] == "tensor_core"
    return y, final


ssd_scan_cuda.launches = 0  # wrapper calls that launched the kernels, since the last reset
ssd_scan_cuda.tensor_core_launches = 0  # of them, on the tensor cores
