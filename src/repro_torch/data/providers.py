"""Data providers: the trainer's uniform batch interface.

Copied from ``repro/data/providers.py`` (``plan_update_mask`` and
``SparseProvider`` without the staged-prefetch half).

A provider fetches variable-size batches into fixed-slot payloads, reports
their work units (nnz — feeds the virtual clock), and stacks per-replica
payloads into the (R, ...) arrays of a lockstep round.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .batcher import SparseBatcher, stack_plan_batches, stack_replica_batches
from .sparse import SparseBatch, SparseDataset, pack_batch


def plan_update_mask(grid: list[list]) -> np.ndarray:
    """(n_rounds, R) float32 mask: 1 where a payload was dispatched."""
    return np.asarray(
        [[0.0 if p is None else 1.0 for p in row] for row in grid], np.float32
    )


@dataclass
class SparseProvider:
    batcher: SparseBatcher

    @staticmethod
    def make(ds: SparseDataset, seed: int = 0) -> "SparseProvider":
        return SparseProvider(SparseBatcher(ds, seed=seed))

    def fetch(self, take: int, b_slots: int) -> SparseBatch:
        return self.batcher.next_batch(take, b_slots)

    def empty(self, b_slots: int) -> SparseBatch:
        return self.batcher.empty(b_slots)

    def work_units(self, payload: SparseBatch) -> int:
        return payload.total_nnz

    def stack(self, payloads: list[SparseBatch]) -> dict:
        return stack_replica_batches(payloads)

    def stack_plan(self, grid: list[list], b_slots: int) -> tuple[dict, np.ndarray]:
        """Whole-plan stack: (n_rounds, R, ...) arrays + (n_rounds, R) mask."""
        return stack_plan_batches(grid, self.empty(b_slots)), plan_update_mask(grid)

    def test_batches(self, ds: SparseDataset, b_slots: int, max_samples: int = 0):
        """Pack a test dataset into full-size batches for evaluation."""
        n = ds.n_samples if not max_samples else min(ds.n_samples, max_samples)
        out = []
        for s in range(0, n, b_slots):
            ids = np.arange(s, min(s + b_slots, n))
            out.append(
                pack_batch(ds, ids, b_slots, self.batcher.max_nnz, self.batcher.max_labels)
            )
        return out
