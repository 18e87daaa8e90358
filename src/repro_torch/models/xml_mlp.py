"""The paper's workload: a 3-layer MLP over sparse XML data.

Port of ``repro/models/xml_mlp.py``. Sparse input layer -> hidden ReLU
layer -> softmax output over the (huge) label space, with cross-entropy
loss. The input layer is the ``spmm`` op: the CUDA kernel on the card, its
plain version on the CPU. The head's product is ``head_matmul``, whose
gradient for the hidden layer (K = n_classes) is the split-K kernel
``xml_dh_gemm`` on the card.

Every function takes parameters with or without a leading replica dim R
(``w1`` (R, NF, H) with batches (R, B, ...), or ``w1`` (NF, H) with
(B, ...)): the reference's ``jax.vmap`` over replicas becomes that explicit
dim. Parameters keep the reference's layout (``w2`` is (H, NC), not
``nn.Linear``'s (NC, H)), so both packages compute the same function.

Two gradient paths, as in the reference. The sparse one (the default,
``sparse_grads=True``): ``loss_and_sparse_grad`` runs autograd over the
dense head only and emits d``w1`` as a RowSparseGrad —
``vals[b,k] = val[b,k]*mask[b,k] * dh[b]`` on rows ``idx[b,k]`` — so no
dense (NF, H) gradient exists. The dense one (``sparse_grads=False``, the
reference's oracle): autograd through ``loss_fn``, whose ``spmm`` carries
its own backward (the ``spmm_grad_w`` kernel on the card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.spmm.ops import spmm
from repro_torch.kernels.xml_head.ops import head_matmul
from repro_torch.models.protocol import TrainableModel
from repro_torch.optim.row_sparse import RowSparseGrad


@dataclass(frozen=True)
class XMLMLPConfig:
    n_features: int
    n_classes: int
    hidden: int = 128
    dtype: torch.dtype = torch.float32
    sparse_grads: bool = True  # row-sparse d w1 (False: dense autograd)


def init_params(cfg: XMLMLPConfig, generator: torch.Generator) -> dict:
    """Paper: weights ~ Normal with std scaled by layer width. Drawn from
    ``generator`` on its device; torch cannot reproduce the reference's
    ``jax.random`` stream, so parity runs carry weights with
    :func:`params_from_jax` instead."""
    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=cfg.dtype, device=generator.device)
        return w * (1.0 / math.sqrt(fan_in))

    return {
        "w1": normal((cfg.n_features, cfg.hidden), cfg.n_features),
        "b1": torch.zeros((cfg.hidden,), dtype=cfg.dtype, device=generator.device),
        "w2": normal((cfg.hidden, cfg.n_classes), cfg.hidden),
        "b2": torch.zeros((cfg.n_classes,), dtype=cfg.dtype, device=generator.device),
    }


def params_from_jax(np_params: dict, device, dtype=None) -> dict:
    """The reference's ``init_params`` output, as numpy arrays (``w1``
    (NF,H), ``b1`` (H,), ``w2`` (H,NC), ``b2`` (NC,)), to the port's dict of
    tensors in the same layout. ``dtype`` defaults to the arrays' own
    (bfloat16 arrives as ml_dtypes and goes through f32, which is exact)."""
    out = {}
    for k, v in np_params.items():
        arr = np.asarray(v)
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, np.float32 if bf16 else arr.dtype))
        out[k] = t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16 else t.dtype))
    return out


def _input_layer(w1: torch.Tensor, batch: dict) -> torch.Tensor:
    """The sparse input layer: h_lin (…, B, hidden)."""
    return spmm(batch["feat_idx"], batch["feat_val"], batch["feat_mask"], w1)


def _head_loss(h_lin: torch.Tensor, rest: dict, batch: dict):
    """From the input layer's output to (loss, aux).

    Masked multi-label softmax cross-entropy + top-1 accuracy. Loss per
    sample = mean over its true labels of -log p(label); batch loss is
    averaged over *valid* samples only (adaptive batch size). With a
    replica dim every output is (R,).
    """
    h = torch.relu(h_lin + rest["b1"][..., None, :])
    logits = (head_matmul(h, rest["w2"]) + rest["b2"][..., None, :]).float()
    logp = torch.log_softmax(logits, dim=-1)
    lab_logp = torch.gather(logp, -1, batch["label_idx"].long())
    lmask = batch["label_mask"].float()
    per_sample = -(lab_logp * lmask).sum(-1) / lmask.sum(-1).clamp_min(1.0)
    smask = batch["sample_mask"].float()
    n_valid = smask.sum(-1)
    loss = (per_sample * smask).sum(-1) / n_valid.clamp_min(1.0)

    pred = logits.detach().argmax(-1)
    hit = ((batch["label_idx"] == pred[..., None]) & batch["label_mask"]).any(-1).float()
    acc = (hit * smask).sum(-1) / n_valid.clamp_min(1.0)
    return loss, {"accuracy": acc, "n_valid": n_valid}


def forward(cfg: XMLMLPConfig, params: dict, batch: dict) -> torch.Tensor:
    """Return logits (…, B, n_classes)."""
    h = torch.relu(_input_layer(params["w1"], batch) + params["b1"][..., None, :])
    return torch.matmul(h, params["w2"]) + params["b2"][..., None, :]


def loss_fn(cfg: XMLMLPConfig, params: dict, batch: dict):
    """Returns (loss, aux) with aux = dict(accuracy, n_valid). Autograd
    reaches every parameter, ``w1`` through ``spmm``'s backward."""
    rest = {k: v for k, v in params.items() if k != "w1"}
    return _head_loss(_input_layer(params["w1"], batch), rest, batch)


def loss_and_sparse_grad(cfg: XMLMLPConfig, params: dict, batch: dict):
    """Sparse-gradient step math: ((loss, aux), grads) with d w1 row-sparse.

    d w1 flows only through the input layer, whose gradient w.r.t. w1 is
    ``dW[idx[b,k]] += scale[b,k] * dh[b]`` — exactly the RowSparseGrad
    layout — so autograd runs over the head only (``h_lin`` and the head
    parameters), from the sum of the per-replica losses: replica r's loss
    depends on replica r's parameters alone, so each gets its own gradient.
    Masked nnz slots get the out-of-bounds sentinel row NF.
    """
    with torch.no_grad():
        h_lin = _input_layer(params["w1"], batch)
    keys = [k for k in params if k != "w1"]
    with torch.enable_grad():
        h_lin.requires_grad_(True)
        rest = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss, aux = _head_loss(h_lin, rest, batch)
        dh, *drest = torch.autograd.grad(loss.sum(), [h_lin] + [rest[k] for k in keys])

    scale = (batch["feat_val"] * batch["feat_mask"]).float()
    *lead, b, k = scale.shape
    vals = scale[..., None] * dh.float()[..., None, :]                  # (…, B, K, H)
    rows = torch.where(batch["feat_mask"], batch["feat_idx"], cfg.n_features).int()
    grads = dict(zip(keys, drest))
    grads["w1"] = RowSparseGrad(
        rows.reshape(*lead, b * k), vals.reshape(*lead, b * k, -1), cfg.n_features
    )
    aux = {name: v.detach() for name, v in aux.items()}
    return (loss.detach(), aux), grads


def make_model(cfg: XMLMLPConfig) -> TrainableModel:
    """Bundle (init, loss[, sparse_grad]) as the trainer's TrainableModel."""
    return TrainableModel(
        init=lambda generator: init_params(cfg, generator),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch),
        sparse_grad_fn=(
            (lambda params, batch: loss_and_sparse_grad(cfg, params, batch))
            if cfg.sparse_grads else None
        ),
        config=cfg,
    )
