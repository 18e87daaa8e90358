"""Plain PyTorch version of the gradient the XML head's product passes to
its hidden layer.

``dh_ref(g, w2)`` is ``g @ w2ᵀ`` for g (…, B, NC) and w2 (…, H, NC) with the
same optional leading replica dim: the gradient of ``h @ w2`` with respect
to h. The CPU path of ``ops.head_matmul``'s backward and the oracle the
CUDA kernel (``csrc/xml_dh_gemm.cu``) is held against.
"""
from __future__ import annotations

import torch


def dh_ref(g, w2):
    return torch.matmul(g, w2.transpose(-1, -2))
