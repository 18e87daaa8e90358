"""Token sequences for an LM cell, drawn from the seed: the benchmark's own
data, handed to the program (through ``repro_torch``'s ``TokenProvider``)
and to the plain reference alike. Imports nothing of the program.

Sequence ``j`` of stream ``stream`` is ``seq_len + 1`` token ids uniform
over ``[0, vocab)``, from ``numpy.random.default_rng([seed, stream, j])``:
it depends on nothing but its index, so the reference draws the j-th
sequence the program fetched without replaying the fetches' sizes.
Stream 0 is the training data, stream 1 the held-out batches.
"""
from __future__ import annotations

import numpy as np


def sequence(vocab: int, seq_len: int, seed: int, stream: int, j: int) -> np.ndarray:
    """The ``j``-th sequence of a stream: (seq_len + 1,) int32."""
    return np.random.default_rng([seed, stream, j]).integers(0, vocab, seq_len + 1,
                                                               dtype=np.int32)


class UniformTokens:
    """A ``TokenStream`` of the program (``data/tokens.py``: ``batch``,
    ``state_dict``, ``load_state_dict``) whose samples are the stream's
    sequences in order."""

    def __init__(self, vocab: int, seed: int, stream: int = 0):
        self.vocab, self.seed, self.stream = vocab, seed, stream
        self.drawn = 0

    def batch(self, b_valid: int, b_slots: int, seq_len: int) -> dict:
        toks = np.zeros((b_slots, seq_len + 1), np.int32)
        for i in range(b_valid):
            toks[i] = sequence(self.vocab, seq_len, self.seed, self.stream, self.drawn + i)
        self.drawn += b_valid
        mask = np.zeros((b_slots,), bool)
        mask[:b_valid] = True
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "sample_mask": mask}

    def state_dict(self) -> dict:
        return {"drawn": self.drawn}

    def load_state_dict(self, sd: dict) -> None:
        self.drawn = int(sd["drawn"])
