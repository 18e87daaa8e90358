"""The learning-rate schedules (``optim.schedules``, copied from the
reference's) against the reference's, on scalars and arrays: exact, in
float64."""
from __future__ import annotations

import numpy as np
import pytest

from repro.optim import schedules as jsched
from repro_torch.optim import schedules as sched

BATCHES = [16, np.array([8.0, 16.0, 31.5, 64.0]), np.arange(1, 9, dtype=np.int64)]


@pytest.mark.parametrize("batch", BATCHES, ids=["scalar", "float_array", "int_array"])
def test_linear_scaled_lr_and_rescale_lr_match_reference(batch):
    for base_lr, base_batch in ((0.05, 64), (0.1, 32), (1.0, 1)):
        got = sched.linear_scaled_lr(base_lr, base_batch, batch)
        want = jsched.linear_scaled_lr(base_lr, base_batch, batch)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    lr = np.full(np.shape(batch), 0.05) if np.ndim(batch) else 0.05
    # old batches below 1 are clamped to 1 in both
    for old in (batch, np.zeros(np.shape(batch)), np.asarray(batch, np.float64) * 0.5):
        new = np.asarray(batch, np.float64) + 3.0
        np.testing.assert_array_equal(sched.rescale_lr(lr, old, new),
                                      jsched.rescale_lr(lr, old, new))


def test_warmup_and_cosine_match_reference():
    for warmup in (-1, 0, 1, 5, 100):
        for step in range(0, 110, 7):
            assert sched.warmup_factor(step, warmup) == jsched.warmup_factor(step, warmup)
    for total in (-3, 0, 1, 10, 1000):
        for floor in (0.0, 0.1, 0.5):
            for step in (0, 1, 5, 10, 999, 1000, 2000):
                got = sched.cosine_decay(step, total, floor)
                want = jsched.cosine_decay(step, total, floor)
                assert got == want and type(got) is type(want), (step, total, floor)
