"""--arch tinyllama-1.1b (see archs.py for the cited spec).

Copied from ``repro/configs/tinyllama_1_1b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["tinyllama-1.1b"]
