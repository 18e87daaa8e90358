"""The initial weights, which the benchmark makes from ``--seed`` and hands
to both sides (the data pools come from ``traffic.xml_synth``)."""
from __future__ import annotations

import math

import torch


def weights(config: dict, seed: int, device) -> dict:
    """The MLP's initial weights on ``device``: normal with std
    1/sqrt(fan_in), biases 0, in the configuration's dtype, drawn by a
    generator on that device in one call a matrix. The same seed and device
    give the same weights bit for bit."""
    nf, nc, h = config["n_features"], config["n_classes"], config["hidden"]
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    return {
        "w1": normal((nf, h), nf),
        "b1": torch.zeros((h,), dtype=dtype, device=device),
        "w2": normal((h, nc), h),
        "b2": torch.zeros((nc,), dtype=dtype, device=device),
    }


