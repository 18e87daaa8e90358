"""Data providers: the trainer's uniform batch interface.

Copied from ``repro/data/providers.py`` (``plan_update_mask``,
``SparseProvider`` and ``TokenProvider``, each with the overlap
pipeline's staging half: ``fetch_staged``, ``staging_spec`` and
``stack_plan``'s ``out``); the port adds ``cursor``, the stream state
the trainer's prefetch snapshots (``ElasticTrainer._cursor_snapshot``).

A provider fetches variable-size batches into fixed-slot payloads, reports
their work units (nnz / tokens — feeds the virtual clock), and stacks
per-replica payloads into the (R, ...) arrays of a lockstep round.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from .batcher import (
    SparseBatcher,
    stack_lazy_plan,
    stack_plan_batches,
    stack_replica_batches,
)
from .sparse import LazySparseBatch, SparseBatch, SparseDataset, pack_batch
from .tokens import TokenStream, stack_plan_token_batches, stack_token_batches


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

    def fetch_staged(self, take: int, b_slots: int) -> tuple[LazySparseBatch, int]:
        """Prefetch-path fetch: the same stream draw as :meth:`fetch`, but
        packing is deferred to :meth:`stack_plan`'s fused gather."""
        p = self.batcher.next_batch_lazy(take, b_slots)
        return p, p.work

    def empty(self, b_slots: int) -> SparseBatch:
        return self.batcher.empty(b_slots)

    def work_units(self, payload: SparseBatch) -> int:
        return payload.total_nnz

    def stack(self, payloads: list[SparseBatch]) -> dict:
        return stack_replica_batches(payloads)

    def state_dict(self) -> dict:
        return self.batcher.state_dict()

    def cursor(self) -> dict:
        """The stream cursor for the trainer's prefetch snapshot:
        :meth:`state_dict` with the sample order as an array copy."""
        return self.batcher.cursor()

    def load_state_dict(self, sd: dict) -> None:
        self.batcher.load_state_dict(sd)

    def staging_spec(self, n_rounds: int, n_replicas: int, b_slots: int) -> dict:
        """{field: (shape, dtype)} of the stacked plan grid, for StagingBuffers."""
        nnz, lab = self.batcher.max_nnz, self.batcher.max_labels
        g = (n_rounds, n_replicas, b_slots)
        return {
            "feat_idx": (g + (nnz,), np.int32),
            "feat_val": (g + (nnz,), np.float32),
            "feat_mask": (g + (nnz,), bool),
            "label_idx": (g + (lab,), np.int32),
            "label_mask": (g + (lab,), bool),
            "sample_mask": (g, bool),
        }

    def stack_plan(
        self, grid: list[list], b_slots: int, out: dict | None = None
    ) -> tuple[dict, np.ndarray]:
        """Whole-plan stack: (n_rounds, R, ...) arrays + (n_rounds, R) mask.

        Lazy payload grids (from :meth:`fetch_staged`) take the fused
        vectorized gather; eager grids keep the per-payload path. ``out``
        is an optional pre-zeroed staging slot to pack into.
        """
        first = next((p for row in grid for p in row if p is not None), None)
        if isinstance(first, LazySparseBatch):
            b = self.batcher
            stacked = stack_lazy_plan(b.ds, grid, b_slots, b.max_nnz, b.max_labels, out=out)
        else:
            stacked = stack_plan_batches(grid, self.empty(b_slots), out=out)
        return stacked, plan_update_mask(grid)

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


@dataclass
class TokenProvider:
    stream: TokenStream
    seq_len: int

    @staticmethod
    def make(vocab_size: int, seq_len: int, seed: int = 0) -> "TokenProvider":
        return TokenProvider(TokenStream(vocab_size, seed=seed), seq_len)

    def fetch(self, take: int, b_slots: int) -> dict:
        return self.stream.batch(take, b_slots, self.seq_len)

    def fetch_staged(self, take: int, b_slots: int) -> tuple[dict, int]:
        """Token batches consume stream RNG at fetch time, so there is no
        lazy form: the staged path packs eagerly and still gains the
        buffered stacking and the single batched upload."""
        p = self.fetch(take, b_slots)
        return p, self.work_units(p)

    def empty(self, b_slots: int) -> dict:
        return self.stream.batch(0, b_slots, self.seq_len)

    def work_units(self, payload: dict) -> int:
        return int(payload["sample_mask"].sum()) * self.seq_len

    def stack(self, payloads: list[dict]) -> dict:
        return stack_token_batches(payloads)

    def state_dict(self) -> dict:
        return self.stream.state_dict()

    def cursor(self) -> dict:
        """The prefetch snapshot's cursor: a copy of the stream's small
        state (``TokenStream``: its RNG state)."""
        return copy.deepcopy(self.stream.state_dict())

    def load_state_dict(self, sd: dict) -> None:
        self.stream.load_state_dict(sd)

    def staging_spec(self, n_rounds: int, n_replicas: int, b_slots: int) -> dict:
        g = (n_rounds, n_replicas, b_slots)
        return {
            "tokens": (g + (self.seq_len,), np.int32),
            "targets": (g + (self.seq_len,), np.int32),
            "sample_mask": (g, bool),
        }

    def stack_plan(
        self, grid: list[list], b_slots: int, out: dict | None = None
    ) -> tuple[dict, np.ndarray]:
        """Whole-plan stack: (n_rounds, R, ...) arrays + (n_rounds, R) mask."""
        return (
            stack_plan_token_batches(grid, self.empty(b_slots), out=out),
            plan_update_mask(grid),
        )

    def test_batches(self, n_batches: int, b_slots: int):
        return [self.fetch(b_slots, b_slots) for _ in range(n_batches)]
