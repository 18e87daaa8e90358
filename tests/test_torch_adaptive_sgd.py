"""The port's Algorithms 1 and 2 against the reference's.

The host-side numpy functions are copies and must agree exactly. The
tensor math (``normalized_merge``, ``replica_regularization``) agrees
within f32 reassociation: rtol 1e-5 / atol 1e-6."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core import adaptive_sgd as jasgd
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import adaptive_sgd as asgd

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_host_algorithms_are_exact(seed):
    rng = np.random.default_rng(seed)
    R = int(rng.integers(2, 9))
    b_max = int(rng.choice([32, 64, 256]))
    cfg, jcfg = ElasticConfig.from_bmax(b_max), JElasticConfig.from_bmax(b_max)
    b = rng.uniform(cfg.b_min, b_max, size=R)
    lr = rng.uniform(0.01, 0.1, size=R)
    u = rng.integers(1, 8, size=R)
    if seed == 0:
        u[:] = 3  # identical update counts: alphas from batch sizes
    for got, want in zip(asgd.batch_size_scaling(b, lr, u, cfg),
                         jasgd.batch_size_scaling(b, lr, u, jcfg)):
        np.testing.assert_array_equal(got, want)
    alphas = asgd.merge_weights(u, b)
    np.testing.assert_array_equal(alphas, jasgd.merge_weights(u, b))
    norms = rng.uniform(0.0, 0.2, size=R)
    got, active = asgd.apply_perturbation(alphas, u, norms, cfg)
    want, jactive = jasgd.apply_perturbation(alphas, u, norms, jcfg)
    np.testing.assert_array_equal(got, want)
    assert active == jactive


def _trees(seed, R=4):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (30, 7), "b1": (7,), "w2": (7, 11), "b2": (11,)}
    reps = {k: rng.normal(size=(R,) + s).astype(np.float32) for k, s in shapes.items()}
    glob = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    prev = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    alphas = rng.random(R)
    return reps, glob, prev, alphas / alphas.sum()


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("gamma", [0.0, 0.9])
@pytest.mark.parametrize("with_globals", [False, True])
def test_normalized_merge_matches_reference(gamma, with_globals):
    reps, glob, prev, alphas = _trees(seed=int(gamma * 10) + with_globals)
    g, gp = (glob, prev) if with_globals else (None, None)
    got = asgd.normalized_merge(
        _t(reps), alphas, _t(g) if g else None, _t(gp) if gp else None, gamma
    )
    want = jasgd.normalized_merge(
        _j(reps), alphas, _j(g) if g else None, _j(gp) if gp else None, gamma,
        use_kernel=False,
    )
    for k in reps:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_replica_regularization_matches_reference():
    reps, *_ = _trees(seed=5)
    np.testing.assert_allclose(
        asgd.replica_regularization(_t(reps)),
        np.asarray(jasgd.replica_regularization(_j(reps))),
        **TOL,
    )
