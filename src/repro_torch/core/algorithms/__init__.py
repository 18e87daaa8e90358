"""Pluggable training-algorithm strategies.

Port of ``repro/core/algorithms``: the ``Algorithm`` base class, the
registry (``register``/``get``/``available``) and the hook result types.
Importing this package registers the ported algorithms — so far the
paper's ``adaptive``.
"""
from .base import (  # noqa: F401
    Algorithm,
    MergeOutcome,
    RoundTransforms,
    StateExtras,
    available,
    get,
    register,
    replica_axis_name,
)

# built-ins self-register on import
from . import adaptive  # noqa: F401, E402
