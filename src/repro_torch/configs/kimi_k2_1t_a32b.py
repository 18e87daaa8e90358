"""--arch kimi-k2-1t-a32b (see archs.py for the cited spec).

Copied from ``repro/configs/kimi_k2_1t_a32b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["kimi-k2-1t-a32b"]
