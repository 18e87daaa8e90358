"""Plain PyTorch version of the SSD chunked-scan kernel.

Port of ``repro/kernels/ssd_scan/ref.py``: it delegates to the model's own
chunked path (``models/mamba2.py::ssd_chunked``), as the reference does.
"""
from __future__ import annotations

from repro_torch.models import mamba2


def ssd_scan_ref(x, dA, Bm, Cm, chunk, initial_state=None):
    """x (B,L,H,P); dA (B,L,H); Bm/Cm (B,L,H,N). Returns (y, final_state)."""
    return mamba2.ssd_chunked(x, dA, Bm, Cm, chunk, initial_state=initial_state)
