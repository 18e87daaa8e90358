"""Batch stream + mega-batch accounting.

Copied from ``repro/data/batcher.py`` (``SampleStream`` and
``SparseBatcher`` with their ``state_dict``/``load_state_dict``,
``stack_replica_batches``, ``stack_plan_grid``, ``stack_plan_batches``).

The dynamic scheduler (core/scheduler.py) pulls variable-size batches from a
``SampleStream``; a *mega-batch* is a fixed budget of samples between two
model-merging stages (paper §3.1). The stream is an infinite shuffled cursor
over the dataset (reshuffled every epoch), so batch boundaries never depend on
the number of replicas.
"""
from __future__ import annotations

import numpy as np

from .sparse import SparseBatch, SparseDataset, pack_batch


class SampleStream:
    """Infinite shuffled cursor over sample ids."""

    def __init__(self, n_samples: int, seed: int = 0):
        self.n = n_samples
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(self.n)
        self.pos = 0
        self.epoch = 0

    def take(self, k: int) -> np.ndarray:
        out = []
        while k > 0:
            avail = self.n - self.pos
            step = min(k, avail)
            out.append(self.order[self.pos : self.pos + step])
            self.pos += step
            k -= step
            if self.pos == self.n:
                self.epoch += 1
                self.order = self.rng.permutation(self.n)
                self.pos = 0
        return np.concatenate(out)

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """Cursor position + RNG state, JSON-serializable: a restored run
        replays the exact sample sequence the killed run would have."""
        return {
            "rng": self.rng.bit_generator.state,
            "order": np.asarray(self.order).tolist(),
            "pos": int(self.pos),
            "epoch": int(self.epoch),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.rng.bit_generator.state = sd["rng"]
        self.order = np.asarray(sd["order"], np.int64)
        self.pos = int(sd["pos"])
        self.epoch = int(sd["epoch"])


class SparseBatcher:
    """Packs scheduler-chosen sample ids into padded COO batches."""

    def __init__(self, ds: SparseDataset, max_nnz: int = 0, max_labels: int = 0, seed: int = 0):
        self.ds = ds
        self.max_nnz = max_nnz or _pad_pow2(int(np.quantile(np.diff(ds.indptr), 0.98)) + 1)
        self.max_labels = max_labels or max(1, int(np.quantile(np.diff(ds.label_ptr), 0.98)) + 1)
        self.stream = SampleStream(ds.n_samples, seed)

    def next_batch(self, b_valid: int, b_slots: int) -> SparseBatch:
        ids = self.stream.take(min(b_valid, b_slots))
        return self.pack(ids, b_slots)

    def pack(self, ids: np.ndarray, b_slots: int) -> SparseBatch:
        return pack_batch(self.ds, ids, b_slots, self.max_nnz, self.max_labels)

    def empty(self, b_slots: int) -> SparseBatch:
        return pack_batch(self.ds, np.zeros((0,), np.int64), b_slots, self.max_nnz, self.max_labels)

    def state_dict(self) -> dict:
        return {"stream": self.stream.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.stream.load_state_dict(sd["stream"])


def _pad_pow2(x: int) -> int:
    p = 8
    while p < x:
        p *= 2
    return p


_SPARSE_FIELDS = (
    "feat_idx", "feat_val", "feat_mask", "label_idx", "label_mask", "sample_mask",
)


def stack_replica_batches(batches: list[SparseBatch]) -> dict:
    """Stack R per-replica SparseBatches into (R, ...) arrays."""
    return {f: np.stack([getattr(b, f) for b in batches]) for f in _SPARSE_FIELDS}


def stack_plan_grid(grid: list[list], template: dict) -> dict:
    """Stack a whole mega-batch plan of dict payloads into (n_rounds, R, ...)
    arrays.

    ``grid`` is the scheduler's dense payload grid (None = masked slot);
    ``template`` fixes the per-slot shapes/dtypes. Masked slots stay
    all-zero, which is exactly an empty payload (every mask False), so the
    engine's update mask is the only thing that distinguishes them.
    """
    n_rounds, n_replicas = len(grid), len(grid[0])
    out = {
        k: np.zeros((n_rounds, n_replicas) + v.shape, v.dtype)
        for k, v in template.items()
    }
    for r, row in enumerate(grid):
        for i, p in enumerate(row):
            if p is not None:
                for k in out:
                    out[k][r, i] = p[k]
    return out


def stack_plan_batches(grid: list[list], template: SparseBatch) -> dict:
    """SparseBatch view of :func:`stack_plan_grid`."""
    def as_dict(p):
        return {f: getattr(p, f) for f in _SPARSE_FIELDS}

    return stack_plan_grid(
        [[None if p is None else as_dict(p) for p in row] for row in grid],
        as_dict(template),
    )
