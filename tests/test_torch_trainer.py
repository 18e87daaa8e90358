"""The slice as a whole: the port's ElasticTrainer (Adaptive SGD, vmap
placement, CPU) against the reference's (adaptive, vmap, scan engine,
simulated SpeedModel) on the same dataset and the same initial weights.

Host decisions — u, b, lr, alphas, n_rounds, virtual time, perturbation —
must be identical. Losses, accuracies and the final global model agree
within rtol 1e-5 / atol 1e-6: the same f32 arithmetic, summed in different
orders by the two frameworks."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import SparseProvider as JProvider
from repro.data.sparse import train_test_split as jax_split
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro.models import xml_mlp as jref
from repro_torch.configs.base import ElasticConfig
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.launch import train as port_train
from repro_torch.models import xml_mlp as port
from repro_torch.models.protocol import TrainableModel

TOL = dict(rtol=1e-5, atol=1e-6)
NF, NC, H = 512, 128, 32
DATA = dict(n_samples=1024, n_features=NF, n_classes=NC, avg_nnz=16, seed=0)
# mega_batch 10 x b_max 32 = 320 samples over 4 replicas: update counts
# differ, so Algorithm 1 rescales and Algorithm 2 merges by u.
CFG = dict(n_replicas=4, mega_batch=10)
N_MB, B_MAX, LR = 5, 32, 0.5
EXACT = ("u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active")


def _init_np():
    cfg = jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    return {k: np.asarray(v) for k, v in jref.init_params(cfg, jax.random.PRNGKey(0)).items()}


def _port_trainer(p0, **kw):
    ds = make_xml_dataset(**DATA)
    train, test = train_test_split(ds, 0.2, seed=0)
    prov = SparseProvider.make(train, seed=0)
    base = port.make_model(port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    model = TrainableModel(
        init=lambda generator: port.params_from_jax(p0, "cpu"),
        loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn, config=base.config,
    )
    tr = ElasticTrainer(model, prov, ElasticConfig.from_bmax(B_MAX, **CFG),
                        base_lr=LR, seed=0, device="cpu", **kw)
    return tr, prov.test_batches(test, B_MAX)


def _ref_trainer(**kw):
    ds = jax_make_dataset(**DATA)
    train, test = jax_split(ds, 0.2, seed=0)
    prov = JProvider.make(train, seed=0)
    model = jref.make_model(jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    tr = JTrainer(model, prov, JElasticConfig.from_bmax(B_MAX, **CFG),
                  base_lr=LR, seed=0, **kw)
    return tr, prov.test_batches(test, B_MAX)


@pytest.fixture(scope="module")
def runs():
    p0 = _init_np()
    tr, tb = _port_trainer(p0)
    state, mlog = tr.run(N_MB, test_batches=tb)
    jtr, jtb = _ref_trainer()
    jstate, jlog = jtr.run(N_MB, test_batches=jtb)
    return state, mlog, jstate, jlog


def test_host_decisions_identical(runs):
    _, mlog, _, jlog = runs
    assert len(mlog.records) == len(jlog.records) == N_MB
    assert any(len(set(r["u"])) > 1 for r in mlog.records)  # u differ: Alg. 1/2 act
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in EXACT:
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])


def test_metrics_and_global_model_match(runs):
    state, mlog, jstate, jlog = runs
    for k in ("train_loss", "train_accuracy", "accuracy", "test_loss"):
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **TOL)
    for k, v in state.global_model.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.global_model[k]), **TOL)
    for k, v in state.replicas.items():  # replicas restart from the merge
        np.testing.assert_array_equal(v.numpy(), np.broadcast_to(
            state.global_model[k].numpy(), v.shape))


def test_nonfinite_guard_matches_reference():
    """A replica poisoned with NaN is re-cloned from the finite replicas'
    merge before the barrier, as in the reference."""
    tr, _ = _port_trainer(_init_np())
    jtr, _ = _ref_trainer(overlap=False)
    state, jstate = tr.init_state(), jtr.init_state()
    state.replicas["w2"][2, 0, 0] = float("nan")
    jstate.replicas = dict(jstate.replicas, w2=jstate.replicas["w2"].at[2, 0, 0].set(jnp.nan))
    state, info = tr.run_megabatch(state)
    jstate, jinfo = jtr.run_megabatch(jstate)
    assert info["guard_repaired"] == jinfo["guard_repaired"] == [2]
    for k in EXACT:
        assert info[k] == jinfo[k], k
    for k, v in state.global_model.items():
        assert np.isfinite(v.numpy()).all()
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.global_model[k]), **TOL)


def test_launcher_runs_end_to_end_on_cpu(tmp_path):
    out = tmp_path / "log.json"
    _, mlog = port_train.main([
        "--workload", "xml", "--algorithm", "adaptive", "--device", "cpu",
        "--replicas", "4", "--megabatches", "2", "--mega-batch", "10",
        "--b-max", str(B_MAX), "--samples", "1024", "--features", str(NF),
        "--classes", str(NC), "--avg-nnz", "16", "--hidden", str(H),
        "--out", str(out),
    ])
    records = json.loads(out.read_text())
    assert [r["megabatch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and 0.0 <= r["accuracy"] <= 1.0 for r in records)
    assert records == json.loads(json.dumps(mlog.records))


def test_launcher_dense_grads_overlap_off_sync_on_cpu(tmp_path):
    """--dense-grads --overlap off --algorithm sync: the same records as
    the pipelined sparse run of the same flags."""
    def run(*extra):
        out = tmp_path / f"log{len(extra)}.json"
        port_train.main([
            "--workload", "xml", "--algorithm", "sync", "--device", "cpu",
            "--replicas", "4", "--megabatches", "2", "--mega-batch", "10",
            "--b-max", str(B_MAX), "--samples", "1024", "--features", str(NF),
            "--classes", str(NC), "--avg-nnz", "16", "--hidden", str(H),
            "--out", str(out), *extra,
        ])
        return json.loads(out.read_text())

    dense = run("--dense-grads", "--overlap", "off")
    sparse = run()
    assert [r["megabatch"] for r in dense] == [1, 2]
    for a, b in zip(dense, sparse):
        for k in EXACT:
            assert a[k] == b[k], k
        for k in ("train_loss", "train_accuracy", "accuracy", "test_loss"):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
