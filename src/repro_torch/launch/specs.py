"""Input specs: the shape and dtype of every model input, and real random
batches for smoke runs — one source of truth for every model input.

Port of ``repro/launch/specs.py``. Where the reference returns
``jax.ShapeDtypeStruct`` stand-ins, a spec here is a ``(shape, torch
dtype)`` pair; ``decode_specs`` builds ``init_cache`` on the ``meta``
device (no memory) and returns its tensors' pairs in the cache's tree.

Batch layouts per mode (leading replica dim R added by the caller/launcher):
  train   : tokens/targets (B, S) int32, sample_mask (B,) bool
            [+ patch_embeds (B, P, Fd) for vlm; frames (B, F, Fd) for audio]
  prefill : tokens (B, S) int32 [+ frontend embeds]
  decode  : tokens (B, 1) int32 + KV/SSM cache of seq_len context
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as MDL
from repro_torch.utils.device import resolve_device

_FRONTEND_FIELDS = {"vision": "patch_embeds", "audio": "frames"}


def _frontend_shape(cfg: ModelConfig, b: int) -> dict:
    """{field: (B, frontend_len, frontend_dim)} for the config's frontend."""
    if cfg.frontend not in _FRONTEND_FIELDS:
        return {}
    return {_FRONTEND_FIELDS[cfg.frontend]: (b, cfg.frontend_len, cfg.frontend_dim)}


def train_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    return {
        "tokens": ((b, s), torch.int32),
        "targets": ((b, s), torch.int32),
        "sample_mask": ((b,), torch.bool),
        **{k: (shape, torch.float32) for k, shape in _frontend_shape(cfg, b).items()},
    }


def prefill_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    return {
        "tokens": ((b, s), torch.int32),
        **{k: (shape, torch.float32) for k, shape in _frontend_shape(cfg, b).items()},
    }


def _spec_tree(tree):
    """Each tensor of a cache tree -> (shape, dtype); other leaves
    (``cur_len``, a Python int) stay as they are."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return tree


def decode_specs(cfg: ModelConfig, b: int, s: int, window: int = 0) -> dict:
    """Decode inputs: one new token + cache covering s context slots."""
    return {
        "tokens": ((b, 1), torch.int32),
        "cache": _spec_tree(MDL.init_cache(cfg, b, s, window, device="meta")),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of ``models.model.init`` as ``(shape, dtype)``
    pairs, built under ``FakeTensorMode`` (no memory, any size)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _spec_tree(MDL.init(cfg, torch.Generator()))


def decode_window(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k on full-attention archs uses the sliding-window carve-in."""
    if shape.name != "long_500k":
        return 0
    if cfg.arch_type in ("ssm",):
        return 0  # attention-free: native O(1) state
    return cfg.long_context_window


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return train_specs(cfg, b, s)
    if shape.mode == "prefill":
        return prefill_specs(cfg, b, s)
    return decode_specs(cfg, b, s, decode_window(cfg, shape))


# --------------------------------------------------------------------------
# real batches (smoke runs / examples)
# --------------------------------------------------------------------------


def make_train_batch(cfg: ModelConfig, b: int, s: int, seed: int = 0, device=None) -> dict:
    """Tokens, targets and an all-ones sample mask from the reference's
    numpy stream (equal to its batch bit for bit), on ``device`` (default
    the card; raises without one). The frontend's ``frames`` or
    ``patch_embeds`` are standard normals from a ``torch.Generator``
    seeded with ``seed``: ``jax.random.normal``'s stream cannot be
    reproduced, so they differ from the reference's. Feed both packages
    the same numpy arrays where the two must agree."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + 1), dtype=np.int32))
    batch = {
        "tokens": toks[:, :-1].contiguous().to(device),
        "targets": toks[:, 1:].contiguous().to(device),
        "sample_mask": torch.ones((b,), dtype=torch.bool, device=device),
    }
    generator = torch.Generator(device=device).manual_seed(seed)
    for k, shape in _frontend_shape(cfg, b).items():
        batch[k] = torch.randn(shape, generator=generator, device=device)
    return batch


def make_decode_inputs(cfg: ModelConfig, b: int, context: int, window: int = 0,
                       seed: int = 0, device=None):
    """One token a row (the reference's numpy draw) and a cache of
    ``context`` slots holding ``context - 1`` tokens, on ``device``
    (default the card; raises without one)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, 1), dtype=np.int32))
    cache = MDL.init_cache(cfg, b, context, window, device=device)
    cache["cur_len"] = context - 1
    return tokens.to(device), cache
