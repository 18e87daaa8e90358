"""The operations and bytes of the Moonlight family's device work the
rooflines read (``roofline_pct.mla_attention``, ``roofline_pct.moe_experts``),
from the shapes each recorded call gives; ``roofline.bound_s`` turns them
into a bound at the configuration's peak. Counted as ``roofline.py`` counts:
each input byte read once, each output byte written once."""
from __future__ import annotations


def mla_attention(q_shape: tuple, dv: int, backward: bool):
    """(bytes, flops) of one causal attention call with q (B, S, H, dqk)
    against keys of dqk and values of ``dv``: q k^T and p v over the
    S (S + 1) / 2 pairs a causal mask keeps, 2 (dqk + dv) flops a pair and
    head; the backward twice that (dq, dk, dv, dp); q, k, v, the output and
    the log-sum-exp read or written once, in bf16."""
    b, s, h, dqk = q_shape
    flops = 2.0 * b * h * s * (s + 1) / 2 * (dqk + dv)
    n_bytes = 2 * b * s * h * (2 * dqk + 2 * dv) + 4 * b * h * s
    return (3 * n_bytes, 3 * flops) if backward else (n_bytes, flops)


def expert_gemms(rows: int, d: int, f: int, experts: int, elt: int, backward: bool):
    """(bytes, flops) of the held experts' SwiGLU over ``rows`` grouped
    rows: three products of 2 rows d f flops (gate, up, down); each
    expert's three weights and the rows' inputs and outputs moved once; the
    backward twice the flops (each product's two gradients) and bytes."""
    flops = 3 * 2.0 * rows * d * f
    n_bytes = elt * (3 * experts * d * f + 2 * rows * d + 3 * rows * f)
    return (3 * n_bytes, 3 * flops) if backward else (n_bytes, flops)
