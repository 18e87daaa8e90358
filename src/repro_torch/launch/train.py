"""Training launcher for the PyTorch port.

Port of ``repro/launch/train.py``: any registered algorithm trains the
paper's 3-layer sparse MLP on synthetic XML data (``--workload xml``) or a
decoder-only LM architecture on a synthetic token stream (``--workload
lm``, the default, with ``--arch`` default tinyllama-1.1b), with the same
flags, defaults and log lines as the reference (the subset this port
supports: ``--engine``, ``--dense-grads``, ``--arch``, ``--reduced`` and
``--seq-len`` included), plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). The trainer logs one more line, ``init``,
with the seconds the initial weights took.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --replicas 4 --megabatches 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --algorithm adaptive --megabatches 5 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import algorithms
from repro_torch.core.heterogeneity import SpeedModel
from repro_torch.core.trainer import ENGINES, ElasticTrainer
from repro_torch.data.providers import SparseProvider, TokenProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.models import model as MDL
from repro_torch.models.xml_mlp import XMLMLPConfig, make_model as make_xml_model
from repro_torch.utils.logging import log


def build_xml_workload(args):
    ds = make_xml_dataset(
        n_samples=args.samples,
        n_features=args.features,
        n_classes=args.classes,
        avg_nnz=args.avg_nnz,
        seed=args.seed,
    )
    train, test = train_test_split(ds, test_frac=0.2, seed=args.seed)
    provider = SparseProvider.make(train, seed=args.seed)
    model = make_xml_model(
        XMLMLPConfig(n_features=ds.n_features, n_classes=ds.n_classes, hidden=args.hidden)
    )
    test_batches = provider.test_batches(test, args.b_max, max_samples=2048)
    return model, provider, test_batches


def build_lm_workload(args):
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    provider = TokenProvider.make(cfg.vocab_size, args.seq_len, seed=args.seed)
    model = MDL.make_model(cfg)
    test_batches = provider.test_batches(2, args.b_max)
    return model, provider, test_batches


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=["xml", "lm"])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU smoke)")
    ap.add_argument("--algorithm", default="adaptive", choices=list(algorithms.available()),
                    help="any algorithm in the core/algorithms registry")
    ap.add_argument("--engine", default="scan", choices=list(ENGINES),
                    help="mega-batch executor: device-resident scan (default)"
                         " or the per-round host loop")
    ap.add_argument("--dense-grads", action="store_true",
                    help="force dense autodiff instead of the row-sparse"
                         " gradient path (the differential oracle)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--megabatches", type=int, default=10)
    ap.add_argument("--mega-batch", type=int, default=20,
                    help="batches per mega-batch (paper default 100)")
    ap.add_argument("--b-max", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hetero", type=float, default=0.32,
                    help="max relative GPU speed gap (paper Fig.1: 32%%)")
    # XML synth dataset knobs
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--features", type=int, default=4096)
    ap.add_argument("--classes", type=int, default=1024)
    ap.add_argument("--avg-nnz", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--out", default="")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    if args.workload == "xml":
        model, provider, test_batches = build_xml_workload(args)
    else:
        model, provider, test_batches = build_lm_workload(args)
    ecfg = ElasticConfig.from_bmax(
        args.b_max,
        algorithm=args.algorithm,
        n_replicas=algorithms.get(args.algorithm).resolve_n_replicas(args.replicas),
        mega_batch=args.mega_batch,
    )
    speed = SpeedModel(ecfg.n_replicas, max_gap=args.hetero, seed=args.seed)
    trainer = ElasticTrainer(
        model=model, provider=provider, cfg=ecfg,
        base_lr=args.lr, speed=speed, seed=args.seed,
        device=args.device, engine=args.engine, sparse_grads=not args.dense_grads,
    )
    state, mlog = trainer.run(args.megabatches, test_batches=test_batches, verbose=True)
    final = mlog.records[-1] if mlog.records else {}
    log("final",
        algorithm=args.algorithm,
        accuracy=round(final.get("accuracy", float("nan")), 4),
        virtual_time=round(final.get("virtual_time", float("nan")), 3))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(mlog.records, f, indent=1)
    return state, mlog


if __name__ == "__main__":
    main()
