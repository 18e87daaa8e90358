"""--arch arctic-480b (see archs.py for the cited spec).

Copied from ``repro/configs/arctic_480b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["arctic-480b"]
