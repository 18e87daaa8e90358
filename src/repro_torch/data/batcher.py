"""Batch stream + mega-batch accounting.

Copied from ``repro/data/batcher.py`` (``SampleStream`` and
``SparseBatcher`` with their ``state_dict``/``load_state_dict`` and
``next_batch_lazy``, ``stack_replica_batches``, ``stack_plan_grid``,
``stack_plan_batches``, ``stack_lazy_plan``); the port adds ``cursor``,
the state dict with the sample order as an array, for the trainer's
prefetch snapshot. ``StagingBuffers`` is the reference's, with slots of
host ``torch`` tensors (pinned for a CUDA trainer) whose leading dim
grows in powers of two.

The dynamic scheduler (core/scheduler.py) pulls variable-size batches from a
``SampleStream``; a *mega-batch* is a fixed budget of samples between two
model-merging stages (paper §3.1). The stream is an infinite shuffled cursor
over the dataset (reshuffled every epoch), so batch boundaries never depend on
the number of replicas.
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse import LazySparseBatch, SparseBatch, SparseDataset, pack_batch


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

    def cursor(self) -> dict:
        """:meth:`state_dict` with ``order`` an int64 array copy instead of
        a list: a snapshot independent of the live stream, which costs one
        array copy where the list form builds a Python int a sample.
        :meth:`load_state_dict` takes either form."""
        return {
            "rng": self.rng.bit_generator.state,
            "order": np.array(self.order, np.int64),
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

    def next_batch_lazy(self, b_valid: int, b_slots: int) -> LazySparseBatch:
        """Draw the same ids as :meth:`next_batch` but defer packing.

        Work units come from the CSR indptr (clipped per row to ``max_nnz``)
        so they match the eager batch's ``total_nnz`` bit for bit.
        """
        ids = self.stream.take(min(b_valid, b_slots))
        nnz = np.minimum(self.ds.indptr[ids + 1] - self.ds.indptr[ids], self.max_nnz)
        return LazySparseBatch(ids=np.asarray(ids, np.int64), work=int(nnz.sum()))

    def pack(self, ids: np.ndarray, b_slots: int) -> SparseBatch:
        return pack_batch(self.ds, ids, b_slots, self.max_nnz, self.max_labels)

    def empty(self, b_slots: int) -> SparseBatch:
        return pack_batch(self.ds, np.zeros((0,), np.int64), b_slots, self.max_nnz, self.max_labels)

    def state_dict(self) -> dict:
        return {"stream": self.stream.state_dict()}

    def cursor(self) -> dict:
        return {"stream": self.stream.cursor()}

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


def stack_plan_grid(grid: list[list], template: dict, out: dict | None = None) -> dict:
    """Stack a whole mega-batch plan of dict payloads into (n_rounds, R, ...)
    arrays.

    ``grid`` is the scheduler's dense payload grid (None = masked slot);
    ``template`` fixes the per-slot shapes/dtypes. Masked slots stay
    all-zero, which is exactly an empty payload (every mask False), so the
    engine's update mask is the only thing that distinguishes them.

    ``out`` lets the overlap staging path pack into a pre-zeroed
    :class:`StagingBuffers` slot instead of allocating fresh arrays.
    """
    n_rounds, n_replicas = len(grid), len(grid[0])
    if out is None:
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


def stack_plan_batches(
    grid: list[list], template: SparseBatch, out: dict | None = None
) -> dict:
    """SparseBatch view of :func:`stack_plan_grid`."""
    def as_dict(p):
        return {f: getattr(p, f) for f in _SPARSE_FIELDS}

    return stack_plan_grid(
        [[None if p is None else as_dict(p) for p in row] for row in grid],
        as_dict(template),
        out=out,
    )


def stack_lazy_plan(
    ds: SparseDataset,
    grid: list[list],
    b_slots: int,
    max_nnz: int,
    max_labels: int,
    out: dict | None = None,
) -> dict:
    """Pack a grid of :class:`LazySparseBatch` payloads in one vectorized
    gather: the fused equivalent of per-payload ``pack_batch`` followed by
    :func:`stack_plan_grid`, byte-identical to that composition.

    All (dispatch, row) destinations across the mega-batch are gathered from
    the CSR arrays at once with a padded-position index, then scattered into
    the (n_rounds, R, b_slots, ...) grid by fancy indexing. ``out`` must be
    all-zero and C-contiguous on entry (masked slots and padding rely on
    it); :meth:`StagingBuffers.acquire` guarantees both.
    """
    n_rounds, n_replicas = len(grid), len(grid[0])
    if out is None:
        out = {
            "feat_idx": np.zeros((n_rounds, n_replicas, b_slots, max_nnz), np.int32),
            "feat_val": np.zeros((n_rounds, n_replicas, b_slots, max_nnz), np.float32),
            "feat_mask": np.zeros((n_rounds, n_replicas, b_slots, max_nnz), bool),
            "label_idx": np.zeros((n_rounds, n_replicas, b_slots, max_labels), np.int32),
            "label_mask": np.zeros((n_rounds, n_replicas, b_slots, max_labels), bool),
            "sample_mask": np.zeros((n_rounds, n_replicas, b_slots), bool),
        }
    dest_batch, dest_row, id_parts = [], [], []
    for r, row in enumerate(grid):
        for i, p in enumerate(row):
            if p is None or len(p.ids) == 0:
                continue
            n = len(p.ids)
            dest_batch.append(np.full(n, r * n_replicas + i, np.int64))
            dest_row.append(np.arange(n, dtype=np.int64))
            id_parts.append(np.asarray(p.ids, np.int64))
    if not id_parts:
        return out
    db = np.concatenate(dest_batch)
    dr = np.concatenate(dest_row)
    ids = np.concatenate(id_parts)
    # contiguous staging arrays -> reshape yields writable views of `out`
    flat = {k: v.reshape((n_rounds * n_replicas,) + v.shape[2:]) for k, v in out.items()}

    starts = ds.indptr[ids]
    counts = np.minimum(ds.indptr[ids + 1] - starts, max_nnz)
    ar = np.arange(max_nnz)
    m = ar[None, :] < counts[:, None]
    if len(ds.indices):
        pos = np.minimum(starts[:, None] + ar[None, :], len(ds.indices) - 1)
        fi = ds.indices[pos]
        fv = ds.values[pos].copy()
        fi = np.where(m, fi, np.int32(0))
        fv[~m] = np.float32(0)
        flat["feat_idx"][db, dr] = fi
        flat["feat_val"][db, dr] = fv
    flat["feat_mask"][db, dr] = m

    lstarts = ds.label_ptr[ids]
    lcounts = np.minimum(ds.label_ptr[ids + 1] - lstarts, max_labels)
    lar = np.arange(max_labels)
    lmask = lar[None, :] < lcounts[:, None]
    if len(ds.labels):
        lpos = np.minimum(lstarts[:, None] + lar[None, :], len(ds.labels) - 1)
        flat["label_idx"][db, dr] = np.where(lmask, ds.labels[lpos], np.int32(0))
    flat["label_mask"][db, dr] = lmask
    flat["sample_mask"][db, dr] = True
    return out


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _capacity(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class StagingBuffers:
    """Two alternating host staging slots for plan grids.

    The overlap pipeline writes mega-batch N+1's grid into one slot while
    the device may still be reading N's, which was uploaded from the other
    (asynchronously from pinned memory on a card; on the CPU the "upload"
    is the slot itself). Alternating slots plus the in-use latch guarantee
    a slot is rewritten only after the mega-batch that consumed it has been
    collected.

    A slot is a dict of host ``torch`` tensors, pinned when ``pin_memory``
    (page-locked allocation is slow, so slots are kept and reused). The
    leading dim of each array (the plan's rounds, which the scheduler does
    not fix) is allocated at a power-of-two capacity; ``acquire`` hands out
    zeroed views of the first ``shape[0]`` rows and reallocates a slot only
    when a name, a trailing shape or a dtype changes, or the rows outgrow
    the capacity. ``allocations`` counts the slot allocations.
    """

    def __init__(self, pin_memory: bool = False):
        self.pin_memory = pin_memory
        self._slots: list[dict | None] = [None, None]
        self._busy = [False, False]
        self._next = 0
        self.allocations = 0

    def _fits(self, slot: dict | None, spec: dict) -> bool:
        if slot is None or set(slot) != set(spec):
            return False
        return all(
            slot[n].shape[1:] == tuple(shape[1:])
            and slot[n].shape[0] >= shape[0]
            and slot[n].dtype == _torch_dtype(dt)
            for n, (shape, dt) in spec.items()
        )

    def acquire(self, spec: dict) -> tuple[int, dict]:
        """Return ``(slot_id, tensors)`` matching ``spec`` ({name: (shape,
        dtype)}), zero-filled views. Raises if the slot is still marked
        in flight: that would mean staging is running ahead of collection."""
        k = self._next
        if self._busy[k]:
            raise RuntimeError(
                "staging buffer slot still in flight — a prefetched "
                "mega-batch was never collected or released"
            )
        slot = self._slots[k]
        if not self._fits(slot, spec):
            old = slot if slot is not None and set(slot) == set(spec) else {}
            slot = {}
            for n, (shape, dt) in spec.items():
                cap = _capacity(shape[0])
                if n in old and old[n].shape[1:] == tuple(shape[1:]):
                    cap = max(cap, old[n].shape[0])
                slot[n] = torch.empty((cap,) + tuple(shape[1:]), dtype=_torch_dtype(dt),
                                      pin_memory=self.pin_memory)
            self._slots[k] = slot
            self.allocations += 1
        views = {n: slot[n][: shape[0]] for n, (shape, _) in spec.items()}
        for v in views.values():
            v.zero_()
        self._busy[k] = True
        self._next = 1 - k
        return k, views

    def release(self, slot_id: int) -> None:
        self._busy[slot_id] = False
