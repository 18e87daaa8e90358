"""The partitioned steps on four real ranks (gloo, CPU processes of
``python -m repro_torch.launch.partitioned``) over a (2, 2) ``(data,
model)`` mesh, against the reference's live single-device round, with the
reference's own tolerances (``tests/test_sharded_integration.py``: loss
rtol 2e-3; merged leaves rtol 3e-2, atol 3e-3): the reduced llama3.2-1b
train round and Algorithm-2 merge (R = 2 replicas over ``data``, tensor
parallel over ``model``), from the reference's init. And the reduced
kimi-k2 prefill with the sharded MoE dispatch (experts and batch over
``data``: each rank's tokens one dispatch group) against the port's
unpartitioned prefill with the same groups, within phase 7's 2e-3."""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.launch.steps import make_merge_step, make_train_round
from repro.models import model as REF_MDL
from repro_torch.launch import partitioned as PT
from repro_torch.models import model as MDL
from repro_torch.utils import tree as tu


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("partitioned")
    cfg = REF_ARCHS[PT.TRAIN_ARCH].reduced()
    params = REF_MDL.init(cfg, jax.random.PRNGKey(0))
    inputs = PT.init_inputs(seed=3)
    inputs = {k: v for k, v in inputs.items() if not k.startswith("p/")}
    port_params = MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    for k, v in tu.flatten(port_params).items():
        inputs[f"p/{k}"] = v.numpy()
    init = os.path.join(out, "init.npz")
    np.savez(init, **inputs)

    # the reference's live round and merge on one device
    reps = jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l[None], (PT.R,) + l.shape), params)
    toks = jnp.asarray(inputs["tokens"])
    batch = {"tokens": jnp.stack([toks[:, :-1]] * PT.R), "targets": jnp.stack([toks[:, 1:]] * PT.R),
             "sample_mask": jnp.ones((PT.R, PT.B), jnp.bool_)}
    lr = jnp.full((PT.R,), PT.LR, jnp.float32)
    new, m = jax.jit(make_train_round(cfg))(reps, batch, lr, jnp.ones((PT.R,), jnp.float32))
    merged = jax.jit(make_merge_step(cfg, keep_global=False))(
        new, jnp.full((PT.R,), 1.0 / PT.R, jnp.float32))
    ref_merged = MDL.params_from_jax(
        jax.tree_util.tree_map(lambda l: np.asarray(l[0], np.float32), merged), "cpu")
    ref = {"loss": np.asarray(m["loss"]),
           "merged": {k: v.numpy() for k, v in tu.flatten(ref_merged).items()}}
    got = PT.spawn(4, (2, 2), "cpu", str(out / "run"), init)
    port_one = PT.unpartitioned(dict(np.load(init)), "cpu", (2, 2))
    return got, ref, port_one


def test_train_round_and_merge_match_the_reference(runs):
    got, ref, _ = runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-3)
    keys = sorted(ref["merged"])
    assert sorted(k[len("merged/"):] for k in got if k.startswith("merged/")) == keys
    for k in keys:
        np.testing.assert_allclose(got[f"merged/{k}"], ref["merged"][k], rtol=3e-2, atol=3e-3,
                                   err_msg=k)


def test_partitioned_round_matches_the_unpartitioned_port(runs):
    """Tighter than the reference's bound: the same f32 math, summed over
    the shards in another order."""
    got, _, one = runs
    np.testing.assert_allclose(got["loss"], one["loss"].numpy(), rtol=1e-5)
    for k, v in one["merged"].items():
        np.testing.assert_allclose(got[f"merged/{k}"], v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_pod_axis_moe_prefill_matches_the_same_groups_unpartitioned(runs):
    got, _, one = runs
    np.testing.assert_allclose(got["moe_logits"], one["logits"].numpy(), rtol=2e-3, atol=2e-3)
    assert np.isfinite(got["moe_logits"]).all()
