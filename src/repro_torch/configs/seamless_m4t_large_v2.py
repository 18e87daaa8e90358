"""--arch seamless-m4t-large-v2 (see archs.py for the cited spec).

Copied from ``repro/configs/seamless_m4t_large_v2.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["seamless-m4t-large-v2"]
