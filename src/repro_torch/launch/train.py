"""Training launcher for the PyTorch port.

Port of ``repro/launch/train.py``: any registered algorithm trains the
paper's 3-layer sparse MLP on synthetic XML data (``--workload xml``) or a
decoder-only LM architecture on a synthetic token stream (``--workload
lm``, the default, with ``--arch`` default tinyllama-1.1b; the stream
carries no ``frames`` or ``patch_embeds``, so seamless-m4t and internvl2
stop with the reference's ``KeyError``), with the same
flags, defaults and log lines as the reference (the subset this port
supports: ``--engine``, ``--overlap``, ``--placement``, ``--speed``, ``--dense-grads``,
``--arch``,
``--reduced``, ``--seq-len``, and the elastic-membership, fault and checkpoint flags
``--elastic-schedule``, ``--faults``, ``--min-replicas``,
``--max-replicas``, ``--timeout-factor``, ``--checkpoint-dir``,
``--checkpoint-every``, ``--checkpoint-retain`` and ``--restore-from``
included, and the multi-process flags ``--multihost``,
``--heartbeat-interval`` and ``--heartbeat-grace``), plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions) and
``--trace-out``, which writes the trainer's spans (``utils.trace``) as JSON
lines at the end of the run. ``--speed measured`` plans on relative speeds measured
from the real mega-batch times (``MeasuredSpeedModel``) instead of the
simulated factors. ``--placement sharded`` splits the replicas over a
replica mesh (``launch.mesh.make_replica_mesh``): every visible card, or
with ``--device cpu`` a size-1 CPU mesh; under an elastic schedule the
trainer draws a mesh for each population from those devices. The trainer
logs one more line, ``init``, with the seconds the initial weights took.

Multi-process training: launched by ``launch.multihost_launch`` (the
``REPRO_MH_*`` environment present and ``--multihost auto``), the process
joins its fleet (``launch.multihost.bootstrap``), forces ``--placement
sharded`` and trains its block of the global replicas on its local devices;
under a host span it renews a heartbeat lease, waits for every peer's
(``rendezvous``) and runs under a ``FleetController`` whose monitor evicts
a peer whose lease goes stale. Only process 0 writes checkpoints.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --replicas 4 --megabatches 20
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --speed measured --megabatches 20
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --placement sharded --megabatches 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --algorithm adaptive --megabatches 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --megabatches 30 --elastic-schedule "0:4,10:6,20:3" \
      --faults "seed=7,p_crash=0.05,3:nan:0,5:join" \
      --checkpoint-dir ckpt/run1 --checkpoint-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --workload xml \
      --algorithm adaptive --megabatches 30 \
      --checkpoint-dir ckpt/run1 --restore-from ckpt/run1
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import algorithms
from repro_torch.core.fleet import FleetController, HeartbeatMonitor, parse_fault_spec
from repro_torch.core.heterogeneity import MeasuredSpeedModel, SpeedModel
from repro_torch.core.trainer import ENGINES, PLACEMENTS, ElasticTrainer
from repro_torch.data.providers import SparseProvider, TokenProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.launch import multihost as mhmod
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.models import model as MDL
from repro_torch.models.xml_mlp import XMLMLPConfig, make_model as make_xml_model
from repro_torch.utils import trace
from repro_torch.utils.logging import log


def parse_elastic_schedule(spec: str) -> dict[int, int]:
    """``"0:4,20:6,40:3"`` -> ``{0: 4, 20: 6, 40: 3}``.

    Keys are 0-based mega-batch indices; values the replica count that
    takes effect before that mega-batch. Entries may come in any order;
    duplicates keep the last occurrence.
    """
    out: dict[int, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            mb_str, r_str = part.split(":")
            mb, r = int(mb_str), int(r_str)
        except ValueError:
            raise ValueError(
                f"bad --elastic-schedule entry {part!r}; expected"
                " 'megabatch:replicas' (e.g. '0:4,20:6,40:3')"
            ) from None
        if mb < 0 or r < 1:
            raise ValueError(
                f"bad --elastic-schedule entry {part!r}: mega-batch index"
                " must be >= 0 and replica count >= 1"
            )
        out[mb] = r
    if not out:
        raise ValueError("--elastic-schedule is empty")
    return out


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
    ap.add_argument("--overlap", default="on", choices=["on", "off"],
                    help="overlapped mega-batch pipeline: stage mega-batch"
                         " N+1 (plan + pack + upload) while N executes, and"
                         " evaluate asynchronously. 'off' is the sequential"
                         " oracle, bit-identical on the CPU. Only the scan"
                         " engine pipelines; the legacy engine always runs"
                         " sequentially")
    ap.add_argument("--placement", default="vmap", choices=list(PLACEMENTS),
                    help="replica placement: every replica on one device"
                         " (vmap, default) or split over a replica mesh, a"
                         " worker thread and a stream a shard (sharded): the"
                         " visible cards, or one CPU shard with --device cpu")
    ap.add_argument("--multihost", default="auto", choices=["auto", "off"],
                    help="multi-process fleet bootstrap: 'auto' spans processes when"
                         " the REPRO_MH_* environment (set by"
                         " repro_torch.launch.multihost_launch) is present; 'off'"
                         " ignores it")
    ap.add_argument("--heartbeat-interval", type=float, default=0.5,
                    help="multi-process lease renewal period (seconds)")
    ap.add_argument("--heartbeat-grace", type=float, default=3.0,
                    help="multi-process liveness deadline: a process whose lease"
                         " has not changed for this long is declared crashed and"
                         " evicted")
    ap.add_argument("--speed", default="simulated", choices=["simulated", "measured"],
                    help="heterogeneity source for the scheduler's virtual"
                         " clock: simulated per-replica factors (paper Fig. 1"
                         " reproduction, deterministic) or relative speeds"
                         " measured from real round times (closes the paper"
                         " §3.1 feedback loop on live hardware)")
    ap.add_argument("--dense-grads", action="store_true",
                    help="force dense autodiff instead of the row-sparse"
                         " gradient path (the differential oracle)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--elastic-schedule", default="",
                    help="'megabatch:R' list, e.g. '0:4,20:6,40:3': resize"
                         " the replica population at those mega-batch"
                         " boundaries. An entry at 0 overrides --replicas")
    ap.add_argument("--faults", default="",
                    help="fault-injection spec: comma list of injector rates"
                         " (seed=7,p_crash=0.02,...) and scripted events"
                         " 'MB:kind[:replica[:duration]]' with kind in"
                         " crash|preempt|join|stall|nan, e.g."
                         " 'seed=7,3:crash:1,5:join,7:nan:0'. Runs the"
                         " trainer under a FleetController")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="fleet floor: evictions never shrink below this")
    ap.add_argument("--max-replicas", type=int, default=0,
                    help="fleet ceiling for joins/readmissions (0 = 2x the"
                         " initial replica count)")
    ap.add_argument("--timeout-factor", type=float, default=0.0,
                    help="health detector: evict a replica whose relative"
                         " speed exceeds this multiple of the population"
                         " median (0 disables)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="enable crash-consistent async checkpointing into"
                         " this directory (atomic publish, bounded retention)")
    ap.add_argument("--checkpoint-every", type=int, default=5,
                    help="mega-batches between checkpoints")
    ap.add_argument("--checkpoint-retain", type=int, default=3,
                    help="published checkpoints kept on disk")
    ap.add_argument("--restore-from", default="",
                    help="resume from this checkpoint (a ckpt-* directory, or"
                         " a checkpoint dir: the newest complete checkpoint)")
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
    ap.add_argument("--trace-out", default="",
                    help="write the trainer's spans (utils.trace) here as JSON lines")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    mh, monitor = None, None
    if args.multihost != "off":
        spec = mhmod.spec_from_env()
        if spec is not None:
            if args.elastic_schedule:
                ap.error("--elastic-schedule is incompatible with a multi-host fleet:"
                         " membership is process-grained and signal-driven")
            if args.faults:
                ap.error("--faults is incompatible with a multi-host fleet: the"
                         " HeartbeatMonitor is the liveness source; the injector stays"
                         " a single-process test harness")
            if args.speed == "measured":
                ap.error("--speed measured is incompatible with a multi-host fleet:"
                         " per-replica timing only observes the local slot block")
            if args.placement != "sharded":
                log("multihost forces --placement sharded")
                args.placement = "sharded"
            mh = mhmod.bootstrap(spec, device=spec.local_devices[0] if spec.local_devices
                                 else args.device)
            log("multihost bootstrap",
                process=spec.process_id, n_processes=spec.num_processes,
                spanning=mh.spanning, fleet_dir=spec.fleet_dir or "-",
                devices=",".join(spec.local_devices or (args.device,)))
            if mh.spanning == "host":
                monitor = HeartbeatMonitor(
                    spec.fleet_dir, process_id=spec.process_id,
                    interval=args.heartbeat_interval, grace=args.heartbeat_grace,
                )
                monitor.renew(megabatch=0)
                monitor.start()
                mh.attach_liveness(monitor)
                mh.rendezvous()

    if args.workload == "xml":
        model, provider, test_batches = build_xml_workload(args)
    else:
        model, provider, test_batches = build_lm_workload(args)
    schedule = None
    if args.elastic_schedule:
        schedule = parse_elastic_schedule(args.elastic_schedule)
        if 0 in schedule:
            args.replicas = schedule[0]  # initial membership
        log("elastic schedule", events={mb: schedule[mb] for mb in sorted(schedule)})

    ecfg = ElasticConfig.from_bmax(
        args.b_max,
        algorithm=args.algorithm,
        n_replicas=algorithms.get(args.algorithm).resolve_n_replicas(args.replicas),
        mega_batch=args.mega_batch,
        placement=args.placement,
    )
    if args.speed == "measured":
        speed = MeasuredSpeedModel(ecfg.n_replicas)
    else:
        speed = SpeedModel(ecfg.n_replicas, max_gap=args.hetero, seed=args.seed)
    device, mesh = args.device, None
    if args.placement == "sharded":
        # a bare "cuda" spans every visible card; a named device is the pool
        dev = torch.device(args.device)
        devices = None if dev.type == "cuda" and dev.index is None else [dev]
        device = None if devices is None else devices[0]
        if mh is not None and mh.local_devices:
            device = None   # the trainer meshes the fleet's local devices
        elif schedule is None and mh is None:
            # with an elastic schedule the trainer draws a mesh for each
            # population from the same devices
            mesh = make_replica_mesh(ecfg.n_replicas, devices)
            log("replica mesh", devices=len(mesh),
                replicas_per_shard=ecfg.n_replicas // len(mesh))
    trainer = ElasticTrainer(
        model=model, provider=provider, cfg=ecfg,
        base_lr=args.lr, speed=speed, seed=args.seed,
        device=device, engine=args.engine, sparse_grads=not args.dense_grads,
        overlap=args.overlap == "on", mesh=mesh, multihost=mh,
    )
    fleet = None
    if args.faults or args.timeout_factor > 0 or monitor is not None:
        fleet = FleetController(
            injector=parse_fault_spec(args.faults) if args.faults else None,
            monitor=monitor,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas or 2 * ecfg.n_replicas,
            timeout_factor=args.timeout_factor,
            verbose=True,
        )
    manager = None
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir, every=args.checkpoint_every,
                                    retain=args.checkpoint_retain,
                                    publisher=mh is None or mh.process_id == 0)
    try:
        state, mlog = trainer.run(
            args.megabatches, test_batches=test_batches, verbose=True,
            resize_schedule=schedule, fleet=fleet, checkpoint=manager,
            restore_from=args.restore_from or None,
        )
    finally:
        if monitor is not None:
            monitor.stop()
    if monitor is not None:
        # completed: flip the lease to 'done' so survivors read our exit as
        # orderly, not as a missed deadline
        monitor.renew(status="done")
    final = mlog.records[-1] if mlog.records else {}
    log("final",
        algorithm=args.algorithm,
        accuracy=round(final.get("accuracy", float("nan")), 4),
        virtual_time=round(final.get("virtual_time", float("nan")), 3))
    if fleet is not None:
        log("fleet", events=len(fleet.events), replicas=trainer.cfg.n_replicas)
    if mh is not None:
        log("multihost exchange", process=mh.process_id, spanning=mh.spanning,
            stats=json.dumps(mh.stats, sort_keys=True))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(mlog.records, f, indent=1)
    if args.trace_out:
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        log("trace", spans=trace.write_jsonl(args.trace_out), file=args.trace_out)
    if mh is not None:
        mh.shutdown()
    return state, mlog


if __name__ == "__main__":
    main()
