"""Where the port runs: the one place that turns a device name into a
``torch.device``."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` or a CUDA device name -> that CUDA device, raising if there is
    no card: nothing falls back to the CPU unless the caller asks for it.
    On the card, f32 matrix products and convolutions run in full f32: TF32
    keeps about three decimal digits and the reference computes in f32."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
