"""--arch internvl2-2b (see archs.py for the cited spec).

Copied from ``repro/configs/internvl2_2b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["internvl2-2b"]
