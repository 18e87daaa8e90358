"""libSVM multi-label format reader/writer.

Copied from ``repro/data/libsvm.py`` (``read_libsvm``, ``write_libsvm``), over
the port's ``SparseDataset``; the bytes written are the reference's.

The paper stores training data "in the sparse libSVM format"; the XML
repository uses the multi-label variant::

    l1,l2,...  f1:v1 f2:v2 ...

First line may be a header ``N n_features n_classes`` (XMLRepo convention).
"""
from __future__ import annotations

import numpy as np

from .sparse import SparseDataset


def read_libsvm(path: str, n_features: int = 0, n_classes: int = 0) -> SparseDataset:
    indptr = [0]
    indices: list[int] = []
    values: list[float] = []
    label_ptr = [0]
    labels: list[int] = []
    with open(path) as f:
        first = f.readline().strip()
        toks = first.split()
        header = len(toks) == 3 and all(t.isdigit() for t in toks)
        if header:
            _, n_features, n_classes = (int(t) for t in toks)
        else:
            _parse_line(first, indices, values, labels)
            indptr.append(len(indices))
            label_ptr.append(len(labels))
        for line in f:
            line = line.strip()
            if not line:
                continue
            _parse_line(line, indices, values, labels)
            indptr.append(len(indices))
            label_ptr.append(len(labels))
    idx = np.asarray(indices, np.int32)
    lab = np.asarray(labels, np.int32)
    if not n_features:
        n_features = int(idx.max()) + 1 if len(idx) else 1
    if not n_classes:
        n_classes = int(lab.max()) + 1 if len(lab) else 1
    return SparseDataset(
        n_features=n_features,
        n_classes=n_classes,
        indptr=np.asarray(indptr, np.int64),
        indices=idx,
        values=np.asarray(values, np.float32),
        label_ptr=np.asarray(label_ptr, np.int64),
        labels=lab,
    )


def _parse_line(line: str, indices, values, labels) -> None:
    parts = line.split()
    start = 0
    if parts and ":" not in parts[0]:
        for l in parts[0].split(","):
            if l:
                labels.append(int(l))
        start = 1
    for tok in parts[start:]:
        k, v = tok.split(":")
        indices.append(int(k))
        values.append(float(v))


def write_libsvm(ds: SparseDataset, path: str, header: bool = True) -> None:
    with open(path, "w") as f:
        if header:
            f.write(f"{ds.n_samples} {ds.n_features} {ds.n_classes}\n")
        for i in range(ds.n_samples):
            idx, val, lab = ds.sample(i)
            lab_s = ",".join(str(int(l)) for l in lab)
            feat_s = " ".join(f"{int(k)}:{float(v):.6g}" for k, v in zip(idx, val))
            f.write(f"{lab_s} {feat_s}\n")
