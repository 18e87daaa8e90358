"""The model protocol consumed by the training engine.

Port of ``repro/models/protocol.py`` (``TrainableModel``).

* ``init(generator) -> params`` — build a dict of parameter tensors from a
  ``torch.Generator``.
* ``loss_fn(params, batch) -> (loss, aux)`` — aux holds ``accuracy`` and
  ``n_valid``.
* ``sparse_grad_fn(params, batch) -> ((loss, aux), grads)`` — fused
  loss+gradient over replica-stacked params and batches; grad leaves may be
  ``RowSparseGrad``.
* ``config`` — the model's own config object (opaque to the trainer).

The reference's dict interface (``model["loss_fn"]``, ``"init" in model``,
``model.get("sparse_grad_fn")``) reads the same fields; a field that is
None reads as missing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass(frozen=True)
class TrainableModel:
    init: Callable[[Any], dict]
    loss_fn: Callable[[dict, dict], tuple]
    sparse_grad_fn: Optional[Callable[[dict, dict], tuple]] = None
    config: Any = None

    # ---- the reference's dict-style access ----
    def __getitem__(self, key):
        val = getattr(self, key, None) if isinstance(key, str) else None
        if val is None:
            raise KeyError(key)
        return val

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and getattr(self, key, None) is not None

    def get(self, key: str, default=None):
        val = getattr(self, key, None) if isinstance(key, str) else None
        return default if val is None else val
