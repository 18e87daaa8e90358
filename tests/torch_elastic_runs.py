"""Live elastic XML training runs of the port and of the reference, from
the same initial weights (the reference's init, carried over with
``params_from_jax``) and the same data, and their comparison; shared by
``test_torch_resize.py``, ``test_torch_fleet.py`` and
``test_torch_checkpoint.py``.

The main scenario (``SCHEDULE``, ``FAULTS``) grows R from 4 to 6 at
mega-batch 2 and shrinks it to 3 at mega-batch 5, and fires every fault
kind on the population it names: a NaN in replica 2 before mega-batch 1,
a crash of replica 1 and a stall of replica 0 before mega-batch 3, a
preemption of replica 2 with one mega-batch of notice before 4, the
readmission of both evicted workers and the stall's recovery before 5,
and a join before 6.

Host decisions — R, u, b, lr, alphas, n_rounds, virtual time,
perturbation, the guard's repairs — and the fleet's event log must be
identical. Losses, accuracies and the final global model agree within
rtol 1e-5 / atol 1e-6, the slice-1 tolerance (tests/test_torch_trainer.py):
the same f32 arithmetic, summed in different orders by the two
frameworks. A mega-batch that trained a poisoned replica has a NaN train
loss in both.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core import algorithms as jalgorithms
from repro.core import fleet as jfleet
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import SparseProvider as JProvider
from repro.data.sparse import train_test_split as jax_split
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro.models import xml_mlp as jref
from repro.optim.sgd import SGDConfig as JSGDConfig
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import fleet
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.kernels.weighted_merge import ops as merge_ops
from repro_torch.models import xml_mlp as port
from repro_torch.models.protocol import TrainableModel
from repro_torch.optim.sgd import SGDConfig

TOL = dict(rtol=1e-5, atol=1e-6)
NF, NC, H = 256, 64, 32
DATA = dict(n_samples=1024, n_features=NF, n_classes=NC, avg_nnz=16, seed=0)
B_MAX, LR, MEGA, R0 = 32, 0.5, 10, 4
SCHEDULE = {0: 4, 2: 6, 5: 3}
FAULTS = "1:nan:2,3:crash:1,3:stall:0,4:preempt:2:1,6:join"
N_MB = 7
EXACT = ("n_replicas", "u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active")
METRICS = ("train_loss", "train_accuracy", "accuracy", "test_loss")


@functools.lru_cache(maxsize=None)
def init_np() -> dict:
    """The reference's initial weights (its trainer's seed 0), as numpy."""
    cfg = jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    return {k: np.asarray(v) for k, v in jref.init_params(cfg, jax.random.PRNGKey(0)).items()}


def _cfg(cls, algo, n_replicas, placement="vmap"):
    R = jalgorithms.get(algo).resolve_n_replicas(n_replicas)
    return cls.from_bmax(B_MAX, algorithm=algo, n_replicas=R, mega_batch=MEGA,
                         placement=placement)


def port_trainer(algo, sparse=True, n_replicas=R0, device="cpu", momentum=0.0,
                 sgd=None, mesh=None, **trainer_kw):
    """(trainer, test batches) of the port; ``momentum`` > 0 keeps SGD
    momentum buffers, ``sgd`` (an ``SGDConfig``) replaces that config,
    ``mesh`` (CPU devices) runs the sharded placement over it in place of
    ``device``, and ``trainer_kw`` go to the trainer (a speed model,
    ``keep_global_copies``)."""
    ds = make_xml_dataset(**DATA)
    train, test = train_test_split(ds, 0.2, seed=0)
    prov = SparseProvider.make(train, seed=0)
    base = port.make_model(port.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    p0 = init_np()
    model = TrainableModel(
        init=lambda generator: port.params_from_jax(p0, "cpu"),
        loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn, config=base.config,
    )
    if mesh is not None:
        trainer_kw.update(mesh=mesh)
        device = None
    placement = "vmap" if mesh is None else "sharded"
    tr = ElasticTrainer(model, prov, _cfg(ElasticConfig, algo, n_replicas, placement),
                        sgd=sgd or SGDConfig(momentum=momentum), base_lr=LR, seed=0,
                        device=device, sparse_grads=sparse, **trainer_kw)
    return tr, prov.test_batches(test, B_MAX)


def ref_trainer(algo, sparse=True, n_replicas=R0, momentum=0.0, sgd=None,
                placement="vmap", **trainer_kw):
    """(trainer, test batches) of the reference; the arguments as
    ``port_trainer``'s, ``sgd`` a reference ``SGDConfig``, ``placement``
    the reference's (its sharded placement on this process's one CPU
    device is a one-shard mesh)."""
    ds = jax_make_dataset(**DATA)
    train, test = jax_split(ds, 0.2, seed=0)
    prov = JProvider.make(train, seed=0)
    model = jref.make_model(jref.XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H))
    tr = JTrainer(model, prov, _cfg(JElasticConfig, algo, n_replicas, placement),
                  sgd=sgd or JSGDConfig(momentum=momentum), base_lr=LR, seed=0,
                  sparse_grads=sparse, **trainer_kw)
    return tr, prov.test_batches(test, B_MAX)


def _run(mod, tr, test, n_mb, schedule, faults, timeout_factor, fleet_kw=None, **kw):
    ctl = None
    if faults is not None or timeout_factor > 0:
        ctl = mod.FleetController(
            injector=mod.parse_fault_spec(faults) if faults else None,
            **dict(dict(max_replicas=2 * R0, timeout_factor=timeout_factor), **(fleet_kw or {})),
        )
    state, mlog = tr.run(n_mb, test_batches=test, resize_schedule=schedule, fleet=ctl, **kw)
    return state, mlog, (ctl.events if ctl is not None else [])


def run_port(algo, sparse=True, n_mb=N_MB, schedule=SCHEDULE, faults=FAULTS,
             timeout_factor=0.0, trainer=None, **kw):
    """(state, mlog, fleet events) of a port run; ``fleet_kw`` goes to the
    FleetController, the rest of ``kw`` to ``run``."""
    tr, test = trainer or port_trainer(algo, sparse)
    return _run(fleet, tr, test, n_mb, schedule, faults, timeout_factor, **kw)


def run_ref(algo, sparse=True, n_mb=N_MB, schedule=SCHEDULE, faults=FAULTS,
            timeout_factor=0.0, trainer=None, **kw):
    """(state, mlog, fleet events) of a reference run."""
    tr, test = trainer or ref_trainer(algo, sparse)
    return _run(jfleet, tr, test, n_mb, schedule, faults, timeout_factor, **kw)


def assert_runs_match(port_run, ref_run, n_mb=N_MB):
    """Hold a port run to a reference run (module doc)."""
    (state, mlog, events), (jstate, jlog, jevents) = port_run, ref_run
    assert events == jevents
    assert len(mlog.records) == len(jlog.records) == n_mb
    for rec, jrec in zip(mlog.records, jlog.records):
        for k in EXACT + ("megabatch",):
            assert rec[k] == jrec[k], (rec["megabatch"], k, rec[k], jrec[k])
        assert rec.get("guard_repaired") == jrec.get("guard_repaired"), rec["megabatch"]
    for k in METRICS:
        np.testing.assert_allclose(mlog.column(k), jlog.column(k), err_msg=k, **TOL)
    assert_state_matches(state, jstate)


def assert_state_matches(state, jstate):
    """Global model within TOL; b and lr identical."""
    np.testing.assert_array_equal(state.b, np.asarray(jstate.b))
    np.testing.assert_array_equal(state.lr, np.asarray(jstate.lr))
    assert state.megabatch_idx == jstate.megabatch_idx
    for k, v in state.global_model.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.global_model[k]),
                                   err_msg=k, **TOL)


@pytest.fixture
def merge_counter(monkeypatch):
    """Counts calls of the weighted-merge op (one a leaf and merge); the
    card's wrapper counts its launches the same way."""
    calls = []
    real = merge_ops.merge

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(merge_ops, "merge", counted)
    return calls


def merge_calls(mlog, events, schedule, algo, r_start=R0) -> int:
    """Merges the run needed, from its records and fleet log: one a
    barrier for the algorithms that merge through Algorithm 2's weighted
    sum, one a membership change that moved R (a scheduled resize to
    another width, an eviction, a join or a readmission; ``single`` keeps
    R = 1 through all of them), and one a guard repair that kept a finite
    replica (its donor merge)."""
    barrier = algo in ("adaptive", "elastic", "delayed_sync")
    n, width = 0, jalgorithms.get(algo).resolve_n_replicas(r_start)
    for rec in mlog.records:
        mb = rec["megabatch"] - 1
        if algo != "single":
            n += int(mb in (schedule or {}) and schedule[mb] != width)
            n += sum(1 for e in events
                     if e["mb"] == mb and e["action"] in ("evict", "join", "rejoin"))
        n += int(barrier)
        repaired = rec.get("guard_repaired")
        n += int(bool(repaired) and len(repaired) < rec["n_replicas"])
        width = rec["n_replicas"]
    return n
