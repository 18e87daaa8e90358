"""--arch stablelm-1.6b (see archs.py for the cited spec).

Copied from ``repro/configs/stablelm_1_6b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["stablelm-1.6b"]
