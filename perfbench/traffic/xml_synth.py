"""Synthetic XML data at a dataset's published widths, drawn in bulk on the
card.

The distribution of ``chip_smoke.py`` ``amazon_like_dataset``, parametrised
by a configuration's ``data`` group: per-sample nnz lognormal(log
``nnz_median``, ``nnz_sigma``) clipped to ``nnz_clip``, Zipf(``zipf``)
feature ids (deduplicated within a sample), gamma(2, 0.5) values, and a
primary class followed by Poisson(``extra_labels``) further labels. It is
drawn by a ``torch.Generator`` on the first card in a few large calls
(numpy took 18-43 s of set-up for these pools on the card's host);
``repro_torch.data.xml_synth.make_xml_dataset`` has a per-class loop that
takes tens of minutes at 670,091 classes.

The pools come back as numpy CSR arrays: the program gets them as its
``SparseDataset``, the reference reads the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def draw(data: dict, n_features: int, n_classes: int, n_samples: int,
         gen: torch.Generator) -> dict:
    """CSR arrays of ``n_samples`` samples: ``indptr``, ``indices``,
    ``values``, ``label_ptr``, ``labels``."""
    dev = gen.device
    lo, hi = data["nnz_clip"]
    nnz = torch.empty(n_samples, dtype=torch.float64, device=dev).log_normal_(
        float(np.log(data["nnz_median"])), data["nnz_sigma"], generator=gen)
    nnz = nnz.clamp_(lo, hi).long()
    zipf = torch.arange(1, n_features + 1, dtype=torch.float64, device=dev).pow_(-data["zipf"])
    cdf = zipf.cumsum_(0).div_(zipf[-1].item())
    u = torch.rand(int(nnz.sum()), dtype=torch.float64, device=dev, generator=gen)
    feats = torch.searchsorted(cdf, u).clamp_(max=n_features - 1)
    rows = torch.repeat_interleave(torch.arange(n_samples, device=dev), nnz)
    keys = torch.unique(rows * n_features + feats)                   # sorted, deduplicated
    sample = keys // n_features
    indptr = torch.zeros(n_samples + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.bincount(sample, minlength=n_samples).cumsum(0)
    # gamma(2, 0.5): the sum of two exponentials of mean 0.5
    values = torch.empty((2, len(keys)), dtype=torch.float32, device=dev).exponential_(
        2.0, generator=gen).sum(0)
    rates = torch.full((n_samples,), float(data["extra_labels"]), dtype=torch.float64, device=dev)
    n_lab = 1 + torch.poisson(rates, generator=gen).long()
    label_ptr = torch.zeros(n_samples + 1, dtype=torch.int64, device=dev)
    label_ptr[1:] = n_lab.cumsum(0)
    labels = torch.randint(0, n_classes, (int(label_ptr[-1]),), device=dev, generator=gen,
                           dtype=torch.int32)
    labels[label_ptr[:-1]] = torch.randint(0, n_classes, (n_samples,), device=dev,
                                           generator=gen, dtype=torch.int32)
    return dict(
        indptr=indptr.cpu().numpy(), indices=(keys % n_features).int().cpu().numpy(),
        values=values.cpu().numpy(), label_ptr=label_ptr.cpu().numpy(),
        labels=labels.cpu().numpy(),
    )


def pools(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(train, test) arrays of a configuration from ``seed``, drawn on
    ``device``: the train pool of ``train_samples``, then the held-out
    ``test_samples``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nf, nc = config["n_features"], config["n_classes"]
    return tuple(draw(config["data"], nf, nc, config[n], gen)
                 for n in ("train_samples", "test_samples"))
