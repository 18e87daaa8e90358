"""--arch moonshot-v1-16b-a3b (see archs.py for the cited spec).

Copied from ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from .archs import ARCHS

CONFIG = ARCHS["moonshot-v1-16b-a3b"]
