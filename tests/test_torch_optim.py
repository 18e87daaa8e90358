"""The port's SGD (in-place, replica-stacked) against the reference's
``sgd_update(replica_dim=True)`` on the same numpy inputs, with row-sparse
and dense leaves.

Tolerance rtol 1e-5 / atol 1e-6: both run the same f32 arithmetic; only the
order in which duplicate rows are scatter-added may differ."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.row_sparse import RowSparseGrad as JRowSparseGrad
from repro.optim.row_sparse import first_occurrence as jax_first_occurrence
from repro.optim.sgd import SGDConfig as JSGDConfig
from repro.optim.sgd import init_momentum as jax_init_momentum
from repro.optim.sgd import sgd_update as jax_sgd_update
from repro_torch.optim.row_sparse import RowSparseGrad, first_occurrence
from repro_torch.optim.sgd import SGDConfig, init_momentum, sgd_update

TOL = dict(rtol=1e-5, atol=1e-6)
R, NF, H, S = 3, 20, 6, 14

CONFIGS = {
    "plain": {},
    "momentum": dict(momentum=0.9),
    "weight_decay": dict(weight_decay=0.05),
    "momentum_wd": dict(momentum=0.8, weight_decay=0.02),
}


def _case(seed):
    rng = np.random.default_rng(seed)
    params = {
        "w1": rng.normal(size=(R, NF, H)).astype(np.float32),
        "b": rng.normal(size=(R, H)).astype(np.float32),
    }
    rows = rng.integers(0, NF, size=(R, S)).astype(np.int32)
    rows[:, 1] = rows[:, 0]                  # duplicates
    rows[:, 2] = rows[:, 0]
    rows[:, -3:] = NF                        # sentinel (masked) slots
    vals = rng.normal(size=(R, S, H)).astype(np.float32)
    db = rng.normal(size=(R, H)).astype(np.float32)
    lr = np.array([0.1, 0.05, 0.2], np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)   # replica 1 frozen
    return params, rows, vals, db, lr, mask


@pytest.mark.parametrize("name", list(CONFIGS) + [f"{c}_scalar_lr" for c in CONFIGS])
def test_sgd_update_matches_reference(name):
    """Per-replica lr and a frozen replica, as in a masked lockstep round;
    the ``_scalar_lr`` cases take one scalar lr and no update mask."""
    params, rows, vals, db, lr, mask = _case(seed=len(name))
    masked = not name.endswith("_scalar_lr")
    if not masked:
        lr, mask = np.float32(0.1), None
    kw = CONFIGS[name.removesuffix("_scalar_lr")]
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tm = init_momentum(tp, SGDConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = jax_init_momentum(jp, JSGDConfig(**kw))
    if tm is not None:  # start from nonzero momentum so the lazy rule shows
        seed_m = np.random.default_rng(1).normal(size=(R, NF, H)).astype(np.float32)
        tm["w1"] = torch.from_numpy(seed_m.copy())
        jm = dict(jm, w1=jnp.asarray(seed_m))
    for _ in range(2):  # second step runs on the first step's output
        tg = {"w1": RowSparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), NF),
              "b": torch.from_numpy(db)}
        tp, tm = sgd_update(tp, tg, torch.tensor(lr), SGDConfig(**kw), momentum_state=tm,
                            update_mask=None if mask is None else torch.from_numpy(mask))
        jg = {"w1": JRowSparseGrad(jnp.asarray(rows), jnp.asarray(vals), NF),
              "b": jnp.asarray(db)}
        jp, jm = jax_sgd_update(jp, jg, jnp.asarray(lr), JSGDConfig(**kw),
                                momentum_state=jm,
                                update_mask=None if mask is None else jnp.asarray(mask),
                                replica_dim=True)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
    if masked:
        np.testing.assert_array_equal(tp["w1"][1].numpy(), params["w1"][1])  # frozen
    if tm is not None:
        for k in params:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL)


def test_sparse_update_nan_in_sentinel_slot_stays_out():
    """A sentinel slot's payload is selected away, not multiplied by 0, so
    a non-finite value there never reaches the parameters."""
    params, rows, vals, db, lr, mask = _case(seed=9)
    vals[:, -1] = np.nan                     # the last slot is a sentinel
    tp = {"w1": torch.from_numpy(params["w1"].copy())}
    g = {"w1": RowSparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), NF)}
    sgd_update(tp, g, torch.from_numpy(lr), SGDConfig(momentum=0.0))
    assert torch.isfinite(tp["w1"]).all()


def test_first_occurrence_and_densify_match_reference():
    params, rows, vals, *_ = _case(seed=4)
    got = first_occurrence(torch.from_numpy(rows), NF).numpy()
    for r in range(R):
        want = np.asarray(jax_first_occurrence(jnp.asarray(rows[r]), NF))
        np.testing.assert_array_equal(got[r], want)
    dense = RowSparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), NF).densify()
    want = JRowSparseGrad(jnp.asarray(rows), jnp.asarray(vals), NF).densify()
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **TOL)
