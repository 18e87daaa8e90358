"""Plain PyTorch version of the grouped expert FFN (SwiGLU) kernel.

Port of ``repro/kernels/moe_gmm/ref.py``:
buf (E, C, D) x wi/wg (E, D, F) x wo (E, F, D) -> (E, C, D),
out[e] = (silu(buf[e] @ wg[e]) * (buf[e] @ wi[e])) @ wo[e], f32 math,
output in buf's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_ffn_gmm_ref(buf, wi, wg, wo):
    x = buf.float()
    g = F.silu(torch.bmm(x, wg.float()))
    u = torch.bmm(x, wi.float())
    return torch.bmm(g * u, wo.float()).to(buf.dtype)
