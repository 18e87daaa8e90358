"""Synthetic extreme multi-label (XML) dataset generator.

Copied from ``repro/data/xml_synth.py`` (``make_xml_dataset`` and the
paper-scale descriptors); it draws the same numpy random stream, so a seed
gives the reference's dataset array for array.

Generation model:
  * each class c has a prototype of ``proto_sz`` feature ids drawn Zipf-like
    from the feature space;
  * a sample picks a primary class, takes a noisy subset of its prototype,
    adds background-noise features, and tags ``~avg_labels`` correlated
    classes as its label set (primary class first).

The per-sample nnz is drawn from a log-normal, the paper's second source of
heterogeneity.
"""
from __future__ import annotations

import numpy as np

from .sparse import SparseDataset


def make_xml_dataset(
    n_samples: int = 2048,
    n_features: int = 4096,
    n_classes: int = 512,
    avg_nnz: int = 64,
    nnz_sigma: float = 0.5,
    avg_labels: int = 3,
    proto_sz: int = 96,
    noise_frac: float = 0.2,
    seed: int = 0,
) -> SparseDataset:
    rng = np.random.default_rng(seed)

    # class prototypes: Zipf-biased feature ids
    zipf_p = 1.0 / (np.arange(1, n_features + 1) ** 0.8)
    zipf_p /= zipf_p.sum()
    protos = [
        rng.choice(n_features, size=proto_sz, replace=False, p=zipf_p)
        for _ in range(n_classes)
    ]
    # label co-occurrence: each class has a fixed set of companion classes
    companions = rng.integers(0, n_classes, size=(n_classes, max(1, avg_labels)))

    indptr = [0]
    indices: list[np.ndarray] = []
    values: list[np.ndarray] = []
    label_ptr = [0]
    labels: list[np.ndarray] = []

    for _ in range(n_samples):
        c = int(rng.integers(n_classes))
        nnz = int(np.clip(rng.lognormal(np.log(avg_nnz), nnz_sigma), 4, 4 * avg_nnz))
        n_noise = int(nnz * noise_frac)
        n_proto = nnz - n_noise
        proto_feats = rng.choice(protos[c], size=min(n_proto, proto_sz), replace=False)
        noise_feats = rng.choice(n_features, size=n_noise, p=zipf_p)
        feats = np.unique(np.concatenate([proto_feats, noise_feats])).astype(np.int32)
        vals = rng.gamma(2.0, 0.5, size=len(feats)).astype(np.float32)

        n_lab = max(1, int(rng.poisson(avg_labels)))
        lab = np.concatenate(([c], companions[c][: n_lab - 1]))
        lab = np.unique(lab).astype(np.int32)
        # keep the primary class first (used for top-1 bookkeeping)
        lab = np.concatenate(([np.int32(c)], lab[lab != c]))

        indices.append(feats)
        values.append(vals)
        indptr.append(indptr[-1] + len(feats))
        labels.append(lab)
        label_ptr.append(label_ptr[-1] + len(lab))

    return SparseDataset(
        n_features=n_features,
        n_classes=n_classes,
        indptr=np.asarray(indptr, np.int64),
        indices=np.concatenate(indices),
        values=np.concatenate(values),
        label_ptr=np.asarray(label_ptr, np.int64),
        labels=np.concatenate(labels),
    )


# Paper-scale dataset descriptors (Table 1).
AMAZON_670K = dict(n_features=135_909, n_classes=670_091, avg_nnz=76, avg_labels=5)
DELICIOUS_200K = dict(n_features=782_585, n_classes=205_443, avg_nnz=302, avg_labels=75)
