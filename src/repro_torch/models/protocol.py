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
