"""--arch llama3.2-1b (see archs.py for the cited spec).

Copied from ``repro/configs/llama3_2_1b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["llama3.2-1b"]
