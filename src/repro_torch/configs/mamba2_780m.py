"""--arch mamba2-780m (see archs.py for the cited spec).

Copied from ``repro/configs/mamba2_780m.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["mamba2-780m"]
