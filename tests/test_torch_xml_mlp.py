"""The port's XML MLP against the reference's, on weights carried over from
the reference's ``init_params`` with ``params_from_jax`` and the same
padded-COO batch.

Tolerance rtol 1e-5 / atol 1e-6: the same f32 function; the frameworks sum
the gathered rows, the head product and the softmax in different orders."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.batcher import SparseBatcher as JBatcher
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro.models import xml_mlp as jref
from repro_torch.models import xml_mlp as port

TOL = dict(rtol=1e-5, atol=1e-6)
NF, NC, H, R, B = 256, 64, 24, 3, 16


@pytest.fixture(scope="module")
def setup():
    ds = jax_make_dataset(n_samples=128, n_features=NF, n_classes=NC, avg_nnz=12, seed=1)
    batcher = JBatcher(ds, seed=2)
    batches = []
    for take in (B, B - 3, B - 7):  # partly filled batches: masked samples
        b = batcher.next_batch(take, B)
        batches.append({f: getattr(b, f) for f in
                        ("feat_idx", "feat_val", "feat_mask", "label_idx",
                         "label_mask", "sample_mask")})
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jcfg = jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    keys = jax.random.split(jax.random.PRNGKey(0), R)
    replicas = [{k: np.asarray(v) for k, v in jref.init_params(jcfg, key).items()}
                for key in keys]
    rep_np = {k: np.stack([p[k] for p in replicas]) for k in replicas[0]}
    pcfg = port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    return jcfg, pcfg, stacked, rep_np


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_params_from_jax_keeps_layout_and_values(setup):
    jcfg, _, _, _ = setup
    p = {k: np.asarray(v) for k, v in jref.init_params(jcfg, jax.random.PRNGKey(3)).items()}
    got = port.params_from_jax(p, "cpu")
    for k, v in p.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert tuple(got["w2"].shape) == (H, NC)   # reference layout, not nn.Linear's
    bf = port.params_from_jax({"w": np.asarray(jnp.asarray(p["w1"], jnp.bfloat16))}, "cpu")
    assert bf["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bf["w"].float().numpy(),
                                  np.asarray(jnp.asarray(p["w1"], jnp.bfloat16), np.float32))


def test_forward_and_loss_match_reference(setup):
    jcfg, pcfg, batches, reps = setup
    p_np = {k: v[0] for k, v in reps.items()}
    b_np = {k: v[0] for k, v in batches.items()}
    params = port.params_from_jax(p_np, "cpu")
    batch = _t(b_np)
    np.testing.assert_allclose(
        port.forward(pcfg, params, batch).numpy(),
        np.asarray(jref.forward(jcfg, _j(p_np), _j(b_np))), **TOL,
    )
    loss, aux = port.loss_fn(pcfg, params, batch)
    jloss, jaux = jref.loss_fn(jcfg, _j(p_np), _j(b_np))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert aux["accuracy"].item() == pytest.approx(float(jaux["accuracy"]))
    assert aux["n_valid"].item() == float(jaux["n_valid"])


def test_sparse_grad_matches_reference_per_replica(setup):
    """The port's explicit replica dim equals the reference's jax.vmap."""
    jcfg, pcfg, batches, reps = setup
    (loss, aux), grads = port.loss_and_sparse_grad(pcfg, _t(reps), _t(batches))
    (jloss, jaux), jgrads = jax.vmap(
        lambda p, b: jref.loss_and_sparse_grad(jcfg, p, b)
    )(_j(reps), _j(batches))
    assert loss.shape == (R,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(aux["accuracy"].numpy(), np.asarray(jaux["accuracy"]), **TOL)
    np.testing.assert_array_equal(aux["n_valid"].numpy(), np.asarray(jaux["n_valid"]))
    for k in ("b1", "w2", "b2"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]), **TOL)
    g, jg = grads["w1"], jgrads["w1"]
    assert g.n_rows == jg.n_rows == NF
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg.vals), **TOL)


def test_init_params_from_a_generator():
    cfg = port.XMLMLPConfig(n_features=300, n_classes=50, hidden=20)
    a = port.init_params(cfg, torch.Generator().manual_seed(5))
    b = port.init_params(cfg, torch.Generator().manual_seed(5))
    shapes = {"w1": (300, 20), "b1": (20,), "w2": (20, 50), "b2": (50,)}
    for k, s in shapes.items():
        assert tuple(a[k].shape) == s
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert abs(a["w1"].std().item() - 300 ** -0.5) < 0.2 * 300 ** -0.5
    assert not a["b1"].any()


def test_dense_model_w1_grad_equals_densified_sparse_grad(setup):
    """make_model(sparse_grads=False) has no sparse_grad_fn; autograd through
    its loss reaches w1 via spmm's backward and equals the sparse path's
    RowSparseGrad, densified. The other leaves' gradients agree too."""
    _, pcfg, batches, reps = setup
    dense_cfg = port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H, sparse_grads=False)
    model = port.make_model(dense_cfg)
    assert model.sparse_grad_fn is None
    assert port.make_model(pcfg).sparse_grad_fn is not None
    params = {k: v.requires_grad_(True) for k, v in _t(reps).items()}
    loss, _ = model.loss_fn(params, _t(batches))
    grads = dict(zip(params, torch.autograd.grad(loss.sum(), list(params.values()))))
    (sloss, _), sgrads = port.loss_and_sparse_grad(pcfg, _t(reps), _t(batches))
    np.testing.assert_allclose(loss.detach().numpy(), sloss.numpy(), **TOL)
    assert grads["w1"].shape == (R, NF, H)
    np.testing.assert_allclose(grads["w1"].numpy(), sgrads["w1"].densify().numpy(), **TOL)
    for k in ("b1", "w2", "b2"):
        np.testing.assert_allclose(grads[k].numpy(), sgrads[k].numpy(), **TOL)
