"""Step functions for the serving launcher.

Port of the serving half of ``repro/launch/steps.py``: ``make_prefill_step``
and ``make_decode_step``. ``train_round`` and ``merge_step`` come with LM
training. PyTorch runs eagerly, so a step is the model call itself.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MDL


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return MDL.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params, cache, tokens):
        return MDL.decode_step(cfg, params, cache, tokens, window=window)

    return decode_step
