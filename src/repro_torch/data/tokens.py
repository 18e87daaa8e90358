"""Synthetic token-LM data pipeline for the LM architectures.

Copied from ``repro/data/tokens.py`` (``TokenStream``,
``stack_token_batches``, ``stack_plan_token_batches``).

Produces (tokens, targets, sample_mask) batches. Token streams are Zipf-
distributed with a learnable bigram structure so small models show loss
movement in smoke tests / examples. The same padded-slot + mask mechanism
used for sparse batches carries the adaptive batch size for LM training.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Markov (bigram) synthetic corpus over a vocab."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        # sparse bigram table: every token has `branch` likely successors
        self.next_tok = self.rng.integers(0, vocab_size, size=(vocab_size, branch))

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        branch = self.next_tok.shape[1]
        for t in range(1, seq_len + 1):
            # 80% follow the bigram table, 20% jump uniformly
            follow = self.rng.random(batch) < 0.8
            choice = self.next_tok[cur, self.rng.integers(0, branch, size=batch)]
            jump = self.rng.integers(0, self.vocab, size=batch)
            cur = np.where(follow, choice, jump).astype(np.int32)
            out[:, t] = cur
        return out

    def batch(self, b_valid: int, b_slots: int, seq_len: int) -> dict:
        toks = np.zeros((b_slots, seq_len + 1), np.int32)
        if b_valid:
            toks[:b_valid] = self.sample(b_valid, seq_len)
        mask = np.zeros((b_slots,), bool)
        mask[:b_valid] = True
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "sample_mask": mask,
        }

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """RNG state only: the bigram table is deterministic in the seed and
        rebuilt by construction, so a restored stream continues the exact
        token sequence of the killed run."""
        return {"rng": self.rng.bit_generator.state}

    def load_state_dict(self, sd: dict) -> None:
        self.rng.bit_generator.state = sd["rng"]


def stack_token_batches(batches: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def stack_plan_token_batches(
    grid: list[list], template: dict, out: dict | None = None
) -> dict:
    """Stack a scheduler payload grid into (n_rounds, R, ...) token arrays.

    Masked (None) slots stay all-zero — identical to an empty token batch
    (sample_mask all False)."""
    from .batcher import stack_plan_grid

    return stack_plan_grid(grid, template, out=out)
