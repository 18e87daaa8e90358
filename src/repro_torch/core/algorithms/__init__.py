"""Pluggable training-algorithm strategies.

Port of ``repro/core/algorithms``: the ``Algorithm`` base class, the
registry (``register``/``get``/``available``) and the hook result types.
Importing this package registers the reference's six algorithms: the
paper's ``adaptive``, its baselines ``elastic``, ``sync``, ``crossbow``
and ``single``, and ``delayed_sync``.
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
from . import adaptive, crossbow, delayed_sync, elastic, single, sync  # noqa: F401, E402
