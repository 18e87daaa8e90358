"""The SGD options ``nesterov`` and ``grad_clip`` in the port
(``optim.sgd``), held to the reference's ``sgd_update(replica_dim=True)``
on the same numpy inputs and to live reference training runs.

* ``sgd_update``: Nesterov momentum, global-norm clipping (per replica),
  and both, x momentum {0, 0.9} x {dense, row-sparse with duplicate rows
  and sentinel slots}, with per-replica learning rates and one frozen
  (masked) replica, two steps: f32 within rtol 2e-4 / atol 2e-5, the
  reference's kernel tolerance (``tests/test_kernels.py:26-29``). The
  frozen replica's parameters and momentum stay exactly as they were.
* ``clip_by_global_norm`` with and without the replica dim.
* one XML training run for each option, on the row-sparse and the dense
  gradient path: host decisions exact, losses and the global model within
  rtol 1e-5 / atol 1e-6 (``tests/torch_elastic_runs.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.optim.row_sparse import RowSparseGrad as JRowSparseGrad
from repro.optim.sgd import SGDConfig as JSGDConfig
from repro.optim.sgd import clip_by_global_norm as jax_clip
from repro.optim.sgd import init_momentum as jax_init_momentum
from repro.optim.sgd import sgd_update as jax_sgd_update
from repro_torch.optim.row_sparse import RowSparseGrad
from repro_torch.optim.sgd import SGDConfig, clip_by_global_norm, init_momentum, sgd_update

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=2e-4, atol=2e-5)
R, NF, H, S = 3, 20, 6, 14
FROZEN = 1
OPTIONS = {
    "nesterov": dict(nesterov=True),
    "grad_clip": dict(grad_clip=1.0),
    "nesterov_grad_clip": dict(nesterov=True, grad_clip=1.0),
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
    dense = rng.normal(size=(R, NF, H)).astype(np.float32)
    db = rng.normal(size=(R, H)).astype(np.float32)
    lr = np.array([0.1, 0.05, 0.2], np.float32)
    mask = np.ones(R, np.float32)
    mask[FROZEN] = 0.0
    return params, rows, vals, dense, db, lr, mask


@pytest.mark.parametrize("grad", ["row_sparse", "dense"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_sgd_option_matches_reference(option, momentum, grad):
    params, rows, vals, dense, db, lr, mask = _case(seed=len(option) + int(10 * momentum))
    kw = dict(OPTIONS[option], momentum=momentum)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tm = init_momentum(tp, SGDConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = jax_init_momentum(jp, JSGDConfig(**kw))
    if tm is not None:  # start from nonzero momentum so every term shows
        seed_m = np.random.default_rng(1).normal(size=(R, NF, H)).astype(np.float32)
        tm["w1"] = torch.from_numpy(seed_m.copy())
        jm = dict(jm, w1=jnp.asarray(seed_m))
    m0 = None if tm is None else {k: v.clone() for k, v in tm.items()}
    for _ in range(2):  # the second step runs on the first step's output
        if grad == "row_sparse":
            tw = RowSparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), NF)
            jw = JRowSparseGrad(jnp.asarray(rows), jnp.asarray(vals), NF)
        else:
            tw, jw = torch.from_numpy(dense), jnp.asarray(dense)
        tp, tm = sgd_update(tp, {"w1": tw, "b": torch.from_numpy(db)}, torch.tensor(lr),
                            SGDConfig(**kw), momentum_state=tm,
                            update_mask=torch.from_numpy(mask))
        jp, jm = jax_sgd_update(jp, {"w1": jw, "b": jnp.asarray(db)}, jnp.asarray(lr),
                                JSGDConfig(**kw), momentum_state=jm,
                                update_mask=jnp.asarray(mask), replica_dim=True)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        # the frozen replica stays exactly as it was
        np.testing.assert_array_equal(tp[k][FROZEN].numpy(), params[k][FROZEN])
        assert not np.allclose(tp[k].numpy(), params[k])   # the others moved
    assert (tm is None) == (jm is None)
    for k in tm or {}:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), err_msg=k, **TOL)
        np.testing.assert_array_equal(tm[k][FROZEN].numpy(), m0[k][FROZEN].numpy())


@pytest.mark.parametrize("replica_dim", [True, False])
def test_clip_by_global_norm_matches_reference(replica_dim):
    """One replica's gradient far above the limit, one below it (left as it
    is), one at zero; without the replica dim one norm over everything."""
    rng = np.random.default_rng(4)
    grads = {"w": rng.normal(size=(R, 5, 4)).astype(np.float32),
             "b": rng.normal(size=(R, 4)).astype(np.float32)}
    grads["w"][0] *= 50.0
    grads["w"][1] *= 0.01
    grads["b"][1] *= 0.01
    grads["w"][2] = 0.0
    grads["b"][2] = 0.0
    got = clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, 1.0,
                              replica_dim)
    want = jax_clip({k: jnp.asarray(v) for k, v in grads.items()}, 1.0, replica_dim)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    if replica_dim:
        np.testing.assert_array_equal(got["w"][1].numpy(), grads["w"][1])
    assert clip_by_global_norm(grads, 0.0, replica_dim) is grads


RUNS = [(o, sparse) for o in ("nesterov", "grad_clip") for sparse in (True, False)]


@pytest.mark.parametrize("case", RUNS, ids=lambda c: f"{c[0]}-{'sparse' if c[1] else 'dense'}")
def test_trainer_run_with_option_matches_reference(case):
    """Adaptive SGD, 4 mega-batches with evaluation, Nesterov at momentum
    0.9 or clipping at 1.0 (which binds: the gradients' norms reach past
    it), against a live reference run."""
    option, sparse = case
    kw = dict(nesterov=True, momentum=0.9) if option == "nesterov" else dict(grad_clip=1.0)
    tr, test = E.port_trainer("adaptive", sparse=sparse, sgd=SGDConfig(**kw))
    jtr, jtest = E.ref_trainer("adaptive", sparse=sparse, sgd=JSGDConfig(**kw))
    port_run = E.run_port("adaptive", n_mb=4, schedule=None, faults=None, trainer=(tr, test))
    ref_run = E.run_ref("adaptive", n_mb=4, schedule=None, faults=None, trainer=(jtr, jtest))
    E.assert_runs_match(port_run, ref_run, n_mb=4)
    # the option changed the trajectory: a plain run ends elsewhere
    plain, ptest = E.port_trainer("adaptive", sparse=sparse)
    p_state, _, _ = E.run_port("adaptive", n_mb=4, schedule=None, faults=None,
                               trainer=(plain, ptest))
    assert not torch.allclose(p_state.global_model["w1"], port_run[0].global_model["w1"])


@pytest.mark.parametrize("nesterov", [False, True])
def test_bf16_dense_rule_matches_reference_bitwise(nesterov):
    """bf16 leaves on the dense rule with momentum 0.9 and weight decay,
    per-replica learning rates and one frozen replica, three steps: the
    coefficients round to bf16 before they multiply (``0.9`` is
    ``0.8984375`` there, as JAX rounds a Python scalar), so every parameter
    and momentum value equals the reference's exactly."""
    params, _, _, dense, db, lr, mask = _case(seed=7 + nesterov)
    kw = dict(momentum=0.9, weight_decay=0.05, nesterov=nesterov)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    tp = {k: bf16(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tm, jm = init_momentum(tp, SGDConfig(**kw)), jax_init_momentum(jp, JSGDConfig(**kw))
    grads = {"w1": dense, "b": db}
    for step in range(3):
        g = {k: v * (1.0 + step) for k, v in grads.items()}
        tp, tm = sgd_update(tp, {k: bf16(v) for k, v in g.items()}, torch.tensor(lr),
                            SGDConfig(**kw), momentum_state=tm,
                            update_mask=torch.from_numpy(mask))
        jp, jm = jax_sgd_update(jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
                                jnp.asarray(lr), JSGDConfig(**kw), momentum_state=jm,
                                update_mask=jnp.asarray(mask), replica_dim=True)
    for tree, jtree in ((tp, jp), (tm, jm)):
        for k in params:
            assert jtree[k].dtype == jnp.bfloat16 and tree[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(tree[k].float().numpy(),
                                          np.asarray(jtree[k], np.float32), err_msg=k)
    assert not np.array_equal(tp["w1"].float().numpy(), params["w1"])
