"""The port's copy of the token pipeline gives the reference's arrays
exactly: ``TokenStream`` batches, ``TokenProvider`` (fetch, empty, work
units, stack, plan stack, test batches), the two stacking functions, and a
``state_dict`` round trip that continues the same token sequence."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import tokens as jtokens
from repro.data.providers import TokenProvider as JProvider
from repro_torch.data import tokens
from repro_torch.data.providers import TokenProvider

CASES = [(seed, vocab) for seed in (0, 1, 7) for vocab in (2, 50, 512, 32000)]


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,vocab", CASES)
def test_token_stream_matches_reference(seed, vocab):
    s, js = tokens.TokenStream(vocab, seed=seed), jtokens.TokenStream(vocab, seed=seed)
    np.testing.assert_array_equal(s.next_tok, js.next_tok)
    np.testing.assert_array_equal(s.sample(3, 17), js.sample(3, 17))
    for b_valid, b_slots in ((5, 5), (2, 6), (0, 4)):   # full, b_valid < b_slots, empty
        _assert_same(s.batch(b_valid, b_slots, 9), js.batch(b_valid, b_slots, 9))


@pytest.mark.parametrize("seed,vocab", CASES)
def test_provider_matches_reference(seed, vocab):
    p, jp = TokenProvider.make(vocab, 12, seed=seed), JProvider.make(vocab, 12, seed=seed)
    for a, b in zip(p.test_batches(2, 4), jp.test_batches(2, 4)):
        _assert_same(a, b)
    _assert_same(p.empty(5), jp.empty(5))
    payloads, jpayloads = [p.fetch(t, 5) for t in (5, 3, 0)], [jp.fetch(t, 5) for t in (5, 3, 0)]
    assert ([p.work_units(x) for x in payloads] == [jp.work_units(x) for x in jpayloads]
            == [60, 36, 0])
    _assert_same(p.stack(payloads), jp.stack(jpayloads))
    _assert_same(tokens.stack_token_batches(payloads),
                 jtokens.stack_token_batches(jpayloads))
    # a plan grid with masked (None) slots, as the scheduler hands it over
    grid = [[payloads[0], None, payloads[1]], [None, payloads[2], None]]
    jgrid = [[jpayloads[0], None, jpayloads[1]], [None, jpayloads[2], None]]
    (stacked, mask), (jstacked, jmask) = p.stack_plan(grid, 5), jp.stack_plan(jgrid, 5)
    _assert_same(stacked, jstacked)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.dtype == jmask.dtype and mask.tolist() == [[1, 0, 1], [0, 1, 0]]
    assert not stacked["sample_mask"][0, 1].any() and not stacked["tokens"][1, 0].any()
    _assert_same(tokens.stack_plan_token_batches(grid, p.empty(5)),
                 jtokens.stack_plan_token_batches(jgrid, jp.empty(5)))


@pytest.mark.parametrize("seed", [0, 5])
def test_state_dict_round_trip_continues_the_sequence(seed):
    """A provider restored from another's ``state_dict`` draws what the
    original draws next, and the reference agrees on the saved state."""
    p, jp = TokenProvider.make(64, 8, seed=seed), JProvider.make(64, 8, seed=seed)
    p.fetch(3, 4)
    jp.fetch(3, 4)
    sd = p.state_dict()
    assert sd == jp.state_dict()
    restored = TokenProvider.make(64, 8, seed=seed)   # the table is the seed's; the
    restored.load_state_dict(sd)                      # rng is the saved one
    nxt = p.fetch(4, 4)
    assert not np.array_equal(TokenProvider.make(64, 8, seed=seed).fetch(4, 4)["tokens"],
                              nxt["tokens"])          # a fresh stream would restart
    _assert_same(restored.fetch(4, 4), nxt)
    _assert_same(nxt, jp.fetch(4, 4))
