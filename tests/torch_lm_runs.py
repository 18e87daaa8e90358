"""Live LM training runs of the port and of the reference, from the same
initial weights (the reference's init, carried over with
``params_from_jax`` and ``flatten``) and the same token stream, and their
comparison; shared by ``test_torch_lm_algorithms.py`` and
``test_torch_lm_algorithms_baselines.py``.

R = 4 (as each algorithm resolves it), 3 mega-batches of 20 batches of up
to 4 samples of 16 tokens: the update counts differ from the first
mega-batch on (``u = [5, 6, 5, 4]``), so Algorithm 1 rescales the batch
sizes and Algorithm 2 merges by u.

Host decisions — u, b, lr, alphas, n_rounds, virtual time, perturbation —
must be identical. Losses, accuracies, the test loss and the final global
model agree within a tolerance:
  * f32 (``F32_TOL``): rtol 1e-5 / atol 1e-5. The same f32 arithmetic in
    other orders (attention and SSD chunk sums, the MoE combine, autograd's
    accumulation) over up to 18 SGD steps and 3 merges. Measured on every
    case here: metrics within 1.5e-7 relative, the global model within
    1.9e-6 absolute (mamba2; jamba 1.4e-6, the rest under 5.1e-7).
  * bf16 (``BF16_TOL``): every matmul output and parameter update rounds
    to bf16 in each framework, in its own order, and the reference's CPU
    merge rounds twice (the weighted sum, then the momentum term;
    core/adaptive_sgd.py) where the port rounds once, as the reference's
    kernel does on an accelerator. Over 18 steps and 3 merges the two
    models drift apart by a few bf16 ulps in places (measured: 7.8e-3 at
    a weight of 0.28, four ulps), so the model is not held per element.
    The metrics are, at rtol 1e-2 / atol 1e-3 (measured within 6.0e-4
    relative). Each leaf of the global model is held by the L2 norm of
    its difference from the reference's, over the L2 norm of how far the
    reference's run moved that leaf from the initial weights: within
    ``move_l2`` 0.2 (measured at most 0.111, ffn.wg; each bf16 run is
    up to 14% of that movement away from the f32 run, and the port is
    within 8% as far from it as the reference). A leaf that did not train
    is 1.0 off.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core import algorithms as jalgorithms
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import TokenProvider as JProvider
from repro.models import model as JMDL
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import ElasticConfig
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import TokenProvider
from repro_torch.models import model as MDL
from repro_torch.models.protocol import TrainableModel
from repro_torch.utils import tree as tu

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3, move_l2=0.2)
N_MB, MEGA, B_MAX, SEQ, LR = 3, 20, 4, 16, 0.2
EXACT = ("u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active")
METRICS = ("train_loss", "train_accuracy", "accuracy", "test_loss")


@pytest.fixture(scope="module")
def one_thread():
    """The port's ops at these sizes are far too small to gain from
    threads, and on a CPU shared by several test workers its idle threads'
    spinning slows every one of them: one thread for the module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_archs.ARCHS[arch].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(torch_archs.ARCHS[arch].reduced(), dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def init_np(arch, dtype="float32"):
    """The reference's initial weights (its trainer's seed 0), as numpy."""
    jcfg, _ = configs(arch, dtype)
    return jax.tree_util.tree_map(np.asarray, JMDL.init(jcfg, jax.random.PRNGKey(0)))


def _elastic(cls, algo):
    R = jalgorithms.get(algo).resolve_n_replicas(4)
    return cls.from_bmax(B_MAX, algorithm=algo, n_replicas=R, mega_batch=MEGA)


def run_port(algo, arch, dtype="float32", mesh=None, overlap=True):
    """A port run; ``mesh`` (CPU devices) runs the sharded placement over
    it, ``overlap=False`` the sequential path."""
    _, tcfg = configs(arch, dtype)
    p0 = init_np(arch, dtype)
    model = TrainableModel(
        init=lambda generator: tu.flatten(MDL.params_from_jax(p0, "cpu")),
        loss_fn=MDL.make_model(tcfg).loss_fn, config=tcfg,
    )
    prov = TokenProvider.make(tcfg.vocab_size, SEQ, seed=0)
    test = prov.test_batches(2, B_MAX)
    cfg = _elastic(ElasticConfig, algo)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, placement="sharded")
    tr = ElasticTrainer(model, prov, cfg, base_lr=LR, seed=0,
                        device=None if mesh is not None else "cpu", mesh=mesh,
                        overlap=overlap)
    return tr.run(N_MB, test_batches=test)


def run_ref(algo, arch, dtype="float32", overlap=True):
    jcfg, _ = configs(arch, dtype)
    prov = JProvider.make(jcfg.vocab_size, SEQ, seed=0)
    test = prov.test_batches(2, B_MAX)
    tr = JTrainer(JMDL.make_model(jcfg), prov, _elastic(JElasticConfig, algo), base_lr=LR,
                  seed=0, overlap=overlap)
    return tr.run(N_MB, test_batches=test)


def assert_runs_match(port_run, ref_run, tol, init=None) -> list:
    """Hold the two runs to each other; returns the port's update counts.
    Where ``tol`` names ``move_l2``, the global model is held leaf by leaf
    relative to the reference's movement from ``init`` (its flat initial
    weights), else per element."""
    (state, mlog), (jstate, jlog) = port_run, ref_run
    elementwise = {k: tol[k] for k in ("rtol", "atol")}
    assert len(mlog.records) == len(jlog.records) == N_MB
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
    for k in METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **elementwise)
    want = tu.flatten(jax.tree_util.tree_map(np.asarray, jstate.global_model))
    assert sorted(state.global_model) == sorted(want)
    for k, v in state.global_model.items():
        got, ref = v.double().numpy(), np.asarray(want[k], np.float64)
        if "move_l2" in tol:
            moved = np.linalg.norm(ref - np.asarray(init[k], np.float64))
            assert np.linalg.norm(got - ref) <= tol["move_l2"] * moved, (
                k, np.linalg.norm(got - ref) / moved)
        else:
            np.testing.assert_allclose(got, ref, err_msg=k, **elementwise)
    return [r["u"] for r in mlog.records]
