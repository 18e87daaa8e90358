"""Run the partitioned steps on a small mesh of real ranks, one process a
rank, and write what each computed: the check that a step over a mesh
computes what the one-device step does.

Two steps, from the partitioned path of ``launch.steps``:

  * ``train`` — the reduced llama3.2-1b train round and the Algorithm-2
    merge (``keep_global=False``, alphas 1/R): R = 2 replicas split over
    the mesh's ``data`` axis, each replica tensor-parallel over ``model``;
    the merge is each rank's local partial through ``weighted_merge`` (the
    kernel on a card), summed by ``all_reduce`` over the data axis.
  * ``moe`` — the reduced kimi-k2 (a pod-axis arch: FSDP and expert
    parallelism over ``data``) prefill with ``moe_dispatch="sharded"``:
    the batch and the experts over ``data``, so each rank's tokens are one
    dispatch group and the buffer's reshard is the all-to-all.

The weights come from ``--init`` (an ``.npz`` of the train step's flat
leaves, tokens and the MoE prefill's tokens: the reference's, for the CPU
tests) or from ``init_inputs`` (seeded, the same in every process). Rank 0
writes ``<out>/result.npz``: the replicas' losses (gathered in replica
order), every merged leaf whole, the MoE logits whole, and the kernel's
launches summed over the ranks.

    PYTHONPATH=src python -m repro_torch.launch.partitioned --procs 4 \\
        --mesh 2,2 --device cpu --out /tmp/part

On cards (``--device cuda``) each rank takes card ``rank`` (NCCL) when
there are as many cards as ranks; ``--procs 1 --mesh 1,1`` is one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_ARCH, MOE_ARCH = "llama3.2-1b", "kimi-k2-1t-a32b"
R, B, S = 2, 4, 32           # replicas, samples a replica, tokens (the reference's test)
MOE_B, MOE_S = 4, 32
LR = 0.1


def train_config():
    return ARCHS[TRAIN_ARCH].reduced()


def moe_config():
    return dataclasses.replace(ARCHS[MOE_ARCH].reduced(), moe_dispatch="sharded")


def init_inputs(seed: int = 0) -> dict:
    """Seeded inputs (numpy): the train step's flat leaves ``p/<key>``, its
    tokens (B, S + 1), the MoE model's flat leaves ``m/<key>`` and its
    prefill tokens (MOE_B, MOE_S)."""
    from repro_torch.models import model as MDL
    from repro_torch.utils import tree as tu

    out = {}
    for tag, cfg in (("p", train_config()), ("m", moe_config())):
        g = torch.Generator().manual_seed(seed)
        for k, v in tu.flatten(MDL.init(cfg, g)).items():
            out[f"{tag}/{k}"] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    rng = np.random.default_rng(seed + 1)
    out["tokens"] = rng.integers(0, train_config().vocab_size, (B, S + 1), dtype=np.int32)
    out["moe_tokens"] = rng.integers(0, moe_config().vocab_size, (MOE_B, MOE_S),
                                     dtype=np.int32)
    return out


def _leaves(inputs: dict, tag: str, device) -> dict:
    n = len(tag) + 1
    return {k[n:]: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in inputs.items() if k.startswith(tag + "/")}


def unpartitioned(inputs: dict, device, mesh_shape: tuple = (2, 2)) -> dict:
    """The same steps on one device, no mesh: the round and merge of
    ``launch.steps``, and the MoE prefill under a context of the mesh's
    axis sizes (a mapping, no DTensor), so its dispatch takes the same
    groups."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.sharding.annotate import sharding_context
    from repro_torch.sharding.rules import MeshAxes
    from repro_torch.utils import tree as tu

    cfg = train_config()
    flat = {k: v[None].repeat((R,) + (1,) * v.ndim)
            for k, v in _leaves(inputs, "p", device).items()}
    toks = torch.from_numpy(inputs["tokens"]).to(device)
    batch = {"tokens": toks[None, :, :-1].repeat(R, 1, 1).contiguous(),
             "targets": toks[None, :, 1:].repeat(R, 1, 1).contiguous(),
             "sample_mask": torch.ones((R, B), dtype=torch.bool, device=device)}
    vec = torch.full((R,), LR, device=device)
    reps, m = ST.make_train_round(cfg)(flat, batch, vec, torch.ones(R, device=device))
    merged = ST.make_merge_step(cfg, keep_global=False)(reps, np.full(R, 1.0 / R))
    mcfg, sizes = moe_config(), dict(zip(("data", "model"), mesh_shape))
    params = tu.unflatten(_leaves(inputs, "m", device))
    with sharding_context(sizes, MeshAxes(mcfg, sizes).serve_rules()):
        logits = ST.make_prefill_step(mcfg)(
            params, {"tokens": torch.from_numpy(inputs["moe_tokens"]).to(device)})
    return {"loss": m["loss"], "merged": {k: v[0] for k, v in merged.items()}, "logits": logits}


def rank_main(rank: int, n_procs: int, mesh_shape: tuple, device: str, out: str,
              init_path: str) -> int:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.weighted_merge.ops import merge_cuda
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import MeshAxes, param_specs, serve_specs, train_batch_specs
    from repro_torch.utils import tree as tu

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    store = dist.FileStore(os.path.join(out, "store"), n_procs)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n_procs)
    try:
        inputs = dict(np.load(init_path)) if init_path else init_inputs()
        mesh = make_debug_mesh(*mesh_shape, device_type=dev.type)
        result = {}
        # -- the train round and the merge --------------------------------
        cfg = train_config()
        ax = MeshAxes(cfg, mesh)
        flat = {k: v[None].repeat((R,) + (1,) * v.ndim)
                for k, v in _leaves(inputs, "p", "cpu").items()}
        toks = torch.from_numpy(inputs["tokens"])
        batch = {"tokens": toks[None, :, :-1].repeat(R, 1, 1).contiguous(),
                 "targets": toks[None, :, 1:].repeat(R, 1, 1).contiguous(),
                 "sample_mask": torch.ones((R, B), dtype=torch.bool)}
        reps = ST.layout_replicas(flat, param_specs(cfg, flat, mesh, with_replica_dim=True),
                                  mesh, ax, dev)
        bt = ST.layout_replicas(batch, train_batch_specs(cfg, batch, mesh), mesh, ax, dev)
        index, count = ST.replica_coordinate(mesh, ax)
        rows = slice(index * (R // count), (index + 1) * (R // count))
        vec = torch.full((R,), LR, device=dev)[rows]
        merge_cuda.launches = 0
        reps, m = ST.make_partitioned_train_round(cfg, mesh)(reps, bt, vec, torch.ones_like(vec))
        merged = ST.make_partitioned_merge_step(cfg, mesh, keep_global=False)(
            reps, np.full(R // count, 1.0 / R))
        launches = torch.tensor([merge_cuda.launches], device=dev)
        dist.all_reduce(launches)
        losses = [torch.zeros_like(m["loss"]) for _ in range(n_procs)]
        dist.all_gather(losses, m["loss"].contiguous())
        # rank (d, m) holds replica block d: one entry a data coordinate
        n_model = mesh_shape[-1]
        result["loss"] = torch.cat([losses[d * n_model] for d in range(count)]).cpu().numpy()
        for k, v in merged.items():
            result[f"merged/{k}"] = v.full_tensor()[0].float().cpu().numpy()
        result["merge_launches"] = int(launches.item())
        # -- the pod-axis MoE prefill -------------------------------------
        mcfg = moe_config()
        params = tu.unflatten(_leaves(inputs, "m", "cpu"))
        mb = {"tokens": torch.from_numpy(inputs["moe_tokens"])}
        p_dt = ST.layout_tree(params, param_specs(mcfg, params, mesh), mesh, dev)
        b_dt = ST.layout_tree(mb, serve_specs(mcfg, mb, mesh), mesh, dev)
        logits = ST.make_partitioned_prefill_step(mcfg, mesh)(p_dt, b_dt)
        full = logits.full_tensor() if isinstance(logits, DTensor) else logits
        result["moe_logits"] = full.float().cpu().numpy()
        if rank == 0:
            np.savez(os.path.join(out, "result.npz"), **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def spawn(n_procs: int, mesh_shape: tuple, device: str, out: str, init_path: str = "",
          timeout: float = 600.0) -> dict:
    """Start ``n_procs`` fresh interpreters of this module, one a rank,
    wait for them, and return rank 0's results (raises if a rank failed)."""
    os.makedirs(out, exist_ok=True)
    for name in ("store", "result.npz"):
        if os.path.exists(os.path.join(out, name)):
            os.remove(os.path.join(out, name))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (SRC, env.get("PYTHONPATH")) if p)
    procs = []
    for rank in range(n_procs):
        cmd = [sys.executable, "-m", "repro_torch.launch.partitioned", "--rank", str(rank),
               "--procs", str(n_procs), "--mesh", ",".join(map(str, mesh_shape)),
               "--device", device, "--out", out, "--init", init_path]
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p, log in procs:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1.0)))
            log.close()
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(codes):
        tails = []
        for rank in range(n_procs):
            with open(os.path.join(out, f"rank{rank}.log"), errors="replace") as f:
                tails.append(f"rank {rank} (exit {codes[rank]}):\n" + "".join(f.readlines()[-25:]))
        raise RuntimeError("a partitioned rank failed\n" + "\n".join(tails))
    res = np.load(os.path.join(out, "result.npz"))
    return {k: res[k] for k in res.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--mesh", default="2,2", help="n_data,n_model")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--init", default="", help=".npz of the inputs (default: seeded)")
    ap.add_argument("--rank", type=int, default=None, help="(internal) run one rank")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    if args.rank is not None:
        return rank_main(args.rank, args.procs, mesh_shape, args.device, args.out, args.init)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    res = spawn(args.procs, mesh_shape, args.device, args.out, args.init)
    print(f"[partitioned] losses {res['loss'].tolist()} merge launches "
          f"{int(res['merge_launches'])} logits {tuple(res['moe_logits'].shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
