"""The paper's sparse XML MLP (``repro_torch.models.xml_mlp``) as a model
family of the benchmark: what the generic harness (``harness.py``) and
``control.py`` need of a model, under the names ``spec.family`` checks.

* ``pools``: the synthetic train and test pools (``traffic/xml_synth.py``);
* ``weights``: the initial weights (``inputs.py``);
* ``build``: the program, an ``ElasticTrainer`` over the cell's cards;
* ``fetched_samples``: the samples of one fetch of the provider;
* ``model_flops``: the window's model FLOPs (``roofline.model_flops``);
* ``launches``: the kernel launches the family's rooflines read;
* ``update_units``, ``reference``, ``replay``, ``FAULTS``: the plain
  reference (``reference/mlp.py``) and the faults ``control.py`` plants.
"""
from __future__ import annotations

import functools

import torch

from perfbench import inputs, roofline
from perfbench.reference import mlp
from perfbench.traffic import xml_synth

pools = xml_synth.pools
weights = inputs.weights
update_units = mlp.unit_norms
reference = mlp.train
replay = mlp.replay_decisions
FAULTS = mlp.FAULTS


def build(config: dict, traffic: dict, seed: int, devices: tuple, train: dict, test: dict):
    """The program: an ``ElasticTrainer`` over the cell's cards, its
    provider, and the test batches it evaluates."""
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.heterogeneity import MeasuredSpeedModel, SpeedModel
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.providers import SparseProvider
    from repro_torch.data.sparse import SparseDataset
    from repro_torch.models.protocol import TrainableModel
    from repro_torch.models.xml_mlp import XMLMLPConfig, make_model

    nf, nc = config["n_features"], config["n_classes"]
    provider = SparseProvider.make(SparseDataset(nf, nc, **train), seed=seed)
    b_max, R = traffic["b_max"], traffic["replicas"]
    test_batches = provider.test_batches(SparseDataset(nf, nc, **test), b_max)
    mcfg = XMLMLPConfig(n_features=nf, n_classes=nc, hidden=config["hidden"],
                        dtype=getattr(torch, config["dtype"]),
                        sparse_grads=traffic["sparse_grads"])
    base = make_model(mcfg)
    # the weights the benchmark makes on the first card, not the program's
    # CPU draw: the reference gets the same
    model = TrainableModel(init=lambda _generator: weights(config, seed, devices[0]),
                           loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                           config=mcfg)
    cfg = ElasticConfig.from_bmax(b_max, algorithm=traffic["algorithm"], n_replicas=R,
                                  mega_batch=traffic["mega_batch"],
                                  placement=traffic["placement"])
    speed = (MeasuredSpeedModel(R) if traffic["speed"] == "measured"
             else SpeedModel(R, max_gap=traffic["max_gap"], seed=seed))
    trainer = ElasticTrainer(
        model=model, provider=provider, cfg=cfg, base_lr=traffic["lr"], speed=speed,
        seed=seed, device=devices[0], sparse_grads=traffic["sparse_grads"],
        overlap=traffic["overlap"],
        mesh=devices if traffic["placement"] == "sharded" else None,
    )
    return trainer, provider, test_batches


def fetched_samples(payload, staged: bool) -> int:
    """The samples of one fetch: a staged fetch's lazy batch names them,
    an eager batch counts its valid rows."""
    return len(payload.ids) if staged else payload.n_valid


def model_flops(config: dict, n_samples: int, work: int) -> float:
    """The model FLOPs of ``n_samples`` samples whose fetches counted
    ``work`` nonzero features in all."""
    return roofline.model_flops(n_samples, work, config["hidden"], config["n_classes"])


def _spmm(orig, rec):
    @functools.wraps(orig)
    def run(idx, val, mask, w):
        if rec.recording:
            rec.launches["spmm"].append((idx, mask, tuple(w.shape), w.element_size()))
        return orig(idx, val, mask, w)
    return run


def launches() -> dict:
    """{name: (module, attribute, wrap)}: the launches the rooflines read
    (``roofline_pct.spmm``, ``roofline_pct.xml_head``). ``wrap(orig,
    recorder)`` appends a launch's inputs to ``recorder.launches[name]``
    while ``recorder.recording``."""
    return {"spmm": ("repro_torch.kernels.spmm.ops", "spmm_cuda", _spmm)}
