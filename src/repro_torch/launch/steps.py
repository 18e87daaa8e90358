"""Step functions for the launchers.

Port of ``repro/launch/steps.py``:

  * ``train_round``  — one lockstep elastic round: per-replica forward/
    backward + masked SGD update (the paper's local updates; plain SGD —
    the momentum of Algorithm 2 lives at the global-model level in
    merge_step).
  * ``merge_step``   — Algorithm 2's weighted merge across the replica dim
    (the paper's all-reduce model merging) + replica reset broadcast.
  * ``prefill_step`` / ``decode_step`` — serving paths (no replica dim).

PyTorch runs eagerly, so a step is a plain function over the model's flat
replica trees (``models.model.make_model``: leaves (R, ...)). The round
and the merge are the trainer's own (``core.trainer.train_round`` and
``merge_replicas``), so ``train_round`` updates the replicas in place as
the trainer's rounds do.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trainer import dense_value_and_grad, merge_replicas
from repro_torch.core.trainer import train_round as _train_round
from repro_torch.models import model as MDL
from repro_torch.optim.sgd import SGDConfig


def make_train_round(cfg: ModelConfig, sgd_cfg: SGDConfig = SGDConfig()):
    loss_fn = MDL.make_model(cfg).loss_fn

    def grads_fn(replicas, batch):
        return dense_value_and_grad(loss_fn, replicas, batch)

    def train_round(replicas, batch, lr_vec, update_mask):
        replicas, _, loss, aux = _train_round(grads_fn, replicas, None, batch, lr_vec,
                                              update_mask, sgd_cfg)
        return replicas, {"loss": loss, "accuracy": aux["accuracy"]}

    return train_round


def make_merge_step(cfg: ModelConfig, gamma: float = 0.9, keep_global: bool = True):
    """Algorithm 2 merge. keep_global=False = paper §4 memory-lean mode
    (no w̄/w̄_p copies; required for the ≥398B archs)."""
    if keep_global:
        def merge_step(replicas, alphas, global_model, prev_global):
            return merge_replicas(replicas, alphas, global_model, prev_global, gamma)
    else:
        def merge_step(replicas, alphas):
            return merge_replicas(replicas, alphas, None, None, 0.0)[1]

    return merge_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return MDL.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params, cache, tokens):
        return MDL.decode_step(cfg, params, cache, tokens, window=window)

    return decode_step
