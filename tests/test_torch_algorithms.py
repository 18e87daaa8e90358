"""Every algorithm of the reference's registry, in the port's trainer
against a live reference trainer, on the same dataset and the same
initial weights (``params_from_jax``): both gradient paths through the
pipeline (``scan``, the default), and through the sequential path
(``sequential``, ``overlap=False``) for ``adaptive`` and ``sync``; and
``adaptive`` and ``elastic`` at 1, 2, 3, 5 and 8 replicas on both
gradient paths.

Host decisions — u, b, lr, alphas, n_rounds, virtual time, perturbation —
must be identical. Losses, accuracies and the final global model agree
within rtol 1e-5 / atol 1e-6, the slice-1 tolerance
(tests/test_torch_trainer.py): the same f32 arithmetic, summed in
different orders by the two frameworks. ``single`` and ``sync`` are held
against live reference runs, not against the reference's golden file."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core import algorithms as jalgorithms
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import SparseProvider as JProvider
from repro.data.sparse import train_test_split as jax_split
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro.models import xml_mlp as jref
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import algorithms
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.models import xml_mlp as port
from repro_torch.models.protocol import TrainableModel

TOL = dict(rtol=1e-5, atol=1e-6)
NF, NC, H = 512, 128, 32
DATA = dict(n_samples=1024, n_features=NF, n_classes=NC, avg_nnz=16, seed=0)
N_MB, B_MAX, LR, MEGA = 3, 32, 0.5, 10
EXACT = ("u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active")
METRICS = ("train_loss", "train_accuracy", "accuracy", "test_loss")

ALGOS = ("adaptive", "crossbow", "delayed_sync", "elastic", "single", "sync")
CASES = [(a, "scan", sparse) for a in ALGOS for sparse in (True, False)] + [
    (a, "sequential", sparse) for a in ("adaptive", "sync") for sparse in (True, False)
]


def _ids(case):
    algo, path, sparse = case
    return f"{algo}-{path}-{'sparse' if sparse else 'dense'}"


def _cfg(cls, algo, n_replicas=4):
    R = jalgorithms.get(algo).resolve_n_replicas(n_replicas)
    return cls.from_bmax(B_MAX, algorithm=algo, n_replicas=R, mega_batch=MEGA)


def _run_port(algo, sparse, p0, n_replicas=4, n_mb=N_MB, overlap=True):
    ds = make_xml_dataset(**DATA)
    train, test = train_test_split(ds, 0.2, seed=0)
    prov = SparseProvider.make(train, seed=0)
    base = port.make_model(port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    model = TrainableModel(
        init=lambda generator: port.params_from_jax(p0, "cpu"),
        loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn, config=base.config,
    )
    tr = ElasticTrainer(model, prov, _cfg(ElasticConfig, algo, n_replicas), base_lr=LR, seed=0,
                        device="cpu", sparse_grads=sparse, overlap=overlap)
    return tr.run(n_mb, test_batches=prov.test_batches(test, B_MAX))


def _run_ref(algo, sparse, n_replicas=4, n_mb=N_MB, overlap=True):
    ds = jax_make_dataset(**DATA)
    train, test = jax_split(ds, 0.2, seed=0)
    prov = JProvider.make(train, seed=0)
    model = jref.make_model(jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    tr = JTrainer(model, prov, _cfg(JElasticConfig, algo, n_replicas), base_lr=LR, seed=0,
                  sparse_grads=sparse, overlap=overlap)
    return tr.run(n_mb, test_batches=prov.test_batches(test, B_MAX))


@pytest.fixture(scope="module")
def p0():
    cfg = jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    return {k: np.asarray(v) for k, v in jref.init_params(cfg, jax.random.PRNGKey(0)).items()}


def test_registry_matches_reference():
    """The port registers the reference's built-in algorithms: those defined
    in its ``core/algorithms`` package (other tests register plugins into
    the reference's registry at import)."""
    builtin = tuple(n for n in jalgorithms.available()
                    if type(jalgorithms.get(n)).__module__.startswith("repro.core.algorithms."))
    assert algorithms.available() == builtin == ALGOS
    for name in algorithms.available():
        assert (algorithms.get(name).resolve_n_replicas(4)
                == jalgorithms.get(name).resolve_n_replicas(4)), name


def _assert_runs_match(port_run, ref_run, n_mb):
    (state, mlog), (jstate, jlog) = port_run, ref_run
    assert len(mlog.records) == len(jlog.records) == n_mb
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
    for k in METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **TOL)
    for k, v in state.global_model.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.global_model[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_algorithm_matches_reference(case, p0):
    algo, path, sparse = case
    overlap = path == "scan"
    _assert_runs_match(_run_port(algo, sparse, p0, overlap=overlap),
                       _run_ref(algo, sparse, overlap=overlap), N_MB)


SWEEP = [(a, R, sparse) for a in ("adaptive", "elastic") for R in (1, 2, 3, 5, 8)
         for sparse in (True, False)]


@pytest.mark.parametrize(
    "case", SWEEP, ids=lambda c: f"{c[0]}-R{c[1]}-{'sparse' if c[2] else 'dense'}")
def test_replica_count_matches_reference(case, p0):
    """The replica dim at other sizes than 4: the vmap placement, the
    scheduler's grids, Alg. 2's weights and the sparse input layer's (R, B,
    K) slots, two mega-batches against a live reference run."""
    algo, R, sparse = case
    _assert_runs_match(_run_port(algo, sparse, p0, R, 2), _run_ref(algo, sparse, R, 2), 2)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_round_without_live_replica_is_a_no_op(dense):
    """A round whose replicas are all masked leaves them exactly as they
    were, crossbow's post-round correction included (the reference gates
    it by liveness); with one live replica the correction runs."""
    ds = make_xml_dataset(**DATA)
    prov = SparseProvider.make(ds, seed=0)
    model = port.make_model(port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    tr = ElasticTrainer(model, prov, _cfg(ElasticConfig, "crossbow"), base_lr=LR,
                        seed=0, device="cpu", sparse_grads=not dense)
    state = tr.init_state()
    for v in state.replicas.values():   # replicas that differ: a correction would move them
        v.add_(torch.randn(v.shape, generator=torch.Generator().manual_seed(1)))
    before = {k: v.clone() for k, v in state.replicas.items()}
    batch = {k: torch.from_numpy(v) for k, v in
             prov.stack([prov.fetch(B_MAX, B_MAX) for _ in range(4)]).items()}
    lr = torch.full((4,), LR)
    reps, *_ = tr._round(state.replicas, None, batch, lr, torch.zeros(4), live=False)
    for k, v in reps.items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    mask = torch.tensor([0.0, 1.0, 0.0, 0.0])
    reps, *_ = tr._round(reps, None, batch, lr, mask, live=True)
    assert not torch.equal(reps["w2"][0], before["w2"][0])   # corrected toward the center
