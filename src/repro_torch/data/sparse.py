"""Sparse sample containers.

Copied from ``repro/data/sparse.py`` (``SparseDataset``, ``SparseBatch``,
``LazySparseBatch``, ``subset``, ``train_test_split``, ``pack_batch``).

The paper trains on libSVM-style sparse data (XML classification): each
sample is a high-dimensional sparse feature vector plus a sparse label set.
Batches are *padded COO*: fixed ``max_nnz`` feature slots and
``max_labels`` label slots per sample, with masks. The per-sample non-zero
count varies (one of the paper's two sources of heterogeneity) and drives
the virtual-clock cost model.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SparseDataset:
    """CSR-style storage of a sparse multi-label dataset (host memory)."""

    n_features: int
    n_classes: int
    indptr: np.ndarray     # (N+1,) int64
    indices: np.ndarray    # (nnz,) int32
    values: np.ndarray     # (nnz,) float32
    label_ptr: np.ndarray  # (N+1,) int64
    labels: np.ndarray     # (total_labels,) int32

    @property
    def n_samples(self) -> int:
        return len(self.indptr) - 1

    def nnz_of(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    def sample(self, i: int):
        s, e = self.indptr[i], self.indptr[i + 1]
        ls, le = self.label_ptr[i], self.label_ptr[i + 1]
        return self.indices[s:e], self.values[s:e], self.labels[ls:le]

    def avg_nnz(self) -> float:
        return float(len(self.indices)) / max(1, self.n_samples)

    def avg_labels(self) -> float:
        return float(len(self.labels)) / max(1, self.n_samples)


@dataclass
class SparseBatch:
    """Padded COO batch with masks; every array is statically shaped.

    ``sample_mask`` implements the paper's *adaptive batch size*: a batch
    always has ``b_max`` slots, of which only the first ``b_i`` are valid.
    """

    feat_idx: np.ndarray     # (B, max_nnz) int32
    feat_val: np.ndarray     # (B, max_nnz) float32
    feat_mask: np.ndarray    # (B, max_nnz) bool
    label_idx: np.ndarray    # (B, max_labels) int32
    label_mask: np.ndarray   # (B, max_labels) bool
    sample_mask: np.ndarray  # (B,) bool

    @property
    def batch_slots(self) -> int:
        return self.feat_idx.shape[0]

    @property
    def n_valid(self) -> int:
        return int(self.sample_mask.sum())

    @property
    def total_nnz(self) -> int:
        return int((self.feat_mask & self.sample_mask[:, None]).sum())


@dataclass
class LazySparseBatch:
    """Deferred batch: sample ids + work units, no packed arrays yet.

    The overlap pipeline's staging path fetches these while planning:
    ``work`` comes straight from the CSR ``indptr``, so the discrete-event
    scheduler costs the dispatch without ``pack_batch``'s per-row loop. The
    whole mega-batch is then packed in one vectorized gather by
    :func:`repro_torch.data.batcher.stack_lazy_plan`. ``work`` equals the
    packed batch's ``total_nnz`` exactly (per-row nnz clipped to
    ``max_nnz``), so virtual-clock trajectories match the eager path bit for
    bit.
    """

    ids: np.ndarray   # (n,) int64 sample ids, n <= b_slots
    work: int         # sum(min(nnz_i, max_nnz)) == packed total_nnz


def subset(ds: SparseDataset, ids: np.ndarray) -> SparseDataset:
    """Row subset of a dataset (rebuilds CSR)."""
    indptr = [0]
    idx_parts, val_parts, lab_parts = [], [], []
    label_ptr = [0]
    for i in ids:
        fidx, fval, lab = ds.sample(int(i))
        idx_parts.append(fidx)
        val_parts.append(fval)
        lab_parts.append(lab)
        indptr.append(indptr[-1] + len(fidx))
        label_ptr.append(label_ptr[-1] + len(lab))
    return SparseDataset(
        n_features=ds.n_features,
        n_classes=ds.n_classes,
        indptr=np.asarray(indptr, np.int64),
        indices=np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int32),
        values=np.concatenate(val_parts) if val_parts else np.zeros(0, np.float32),
        label_ptr=np.asarray(label_ptr, np.int64),
        labels=np.concatenate(lab_parts) if lab_parts else np.zeros(0, np.int32),
    )


def train_test_split(
    ds: SparseDataset, test_frac: float = 0.2, seed: int = 0
) -> tuple[SparseDataset, SparseDataset]:
    """Split one dataset (same generative structure) into train/test."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n_samples)
    n_test = int(ds.n_samples * test_frac)
    return subset(ds, perm[n_test:]), subset(ds, perm[:n_test])


def pack_batch(
    ds: SparseDataset,
    sample_ids: np.ndarray,
    b_slots: int,
    max_nnz: int,
    max_labels: int,
) -> SparseBatch:
    """Pack ``sample_ids`` (may be fewer than b_slots) into a padded batch."""
    n = len(sample_ids)
    if n > b_slots:
        raise ValueError(f"{n} samples do not fit {b_slots} batch slots")
    fi = np.zeros((b_slots, max_nnz), np.int32)
    fv = np.zeros((b_slots, max_nnz), np.float32)
    fm = np.zeros((b_slots, max_nnz), bool)
    li = np.zeros((b_slots, max_labels), np.int32)
    lm = np.zeros((b_slots, max_labels), bool)
    sm = np.zeros((b_slots,), bool)
    for row, sid in enumerate(sample_ids):
        idx, val, lab = ds.sample(int(sid))
        k = min(len(idx), max_nnz)
        fi[row, :k] = idx[:k]
        fv[row, :k] = val[:k]
        fm[row, :k] = True
        j = min(len(lab), max_labels)
        li[row, :j] = lab[:j]
        lm[row, :j] = True
        sm[row] = True
    return SparseBatch(fi, fv, fm, li, lm, sm)
