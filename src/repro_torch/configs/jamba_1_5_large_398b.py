"""--arch jamba-1.5-large-398b (see archs.py for the cited spec).

Copied from ``repro/configs/jamba_1_5_large_398b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["jamba-1.5-large-398b"]
