"""Multi-pod dry run: every (architecture x input shape x mesh) combination,
traced on the production mesh with nothing allocated, and its per-device
costs recorded.

Port of ``repro/launch/dryrun.py``. Where the reference lowers and compiles
each step with XLA against ``ShapeDtypeStruct`` inputs on 512 placeholder
devices, this traces it: a ``fake`` process group of the mesh's size
(``launch.mesh.init_fake_process_group``; this process is rank 0, and the
collectives move nothing), the parameters, batch and cache as DTensors
over the production ``DeviceMesh`` whose local shards are fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory), and the partitioned
steps of ``launch.steps`` run under ``launch.cost_analysis.CostMode``,
which counts rank 0's local program: FLOPs, HBM bytes, collective bytes and
counts, and the peak of the memory it allocates. Each step of a
combination (``train`` and the Algorithm-2 ``merge`` for train shapes,
``prefill``, ``decode``) is written to ``<out>/<arch>__<shape>__<mesh>.json``
with the reference's keys (``arch``, ``shape``, ``mesh``, ``mesh_shape``,
``steps``, ``model_flops_per_token``, ``total_params``,
``tokens_per_step``, ``mode``); each step holds ``flops``, ``hbm_bytes``,
``collectives`` (``bytes`` and ``counts`` under the reference's five
names), ``memory`` (``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes``, per device), ``trace_s`` (the reference's
``compile_s``), ``n_devices`` and ``fits_hbm`` (argument + temp within
one H100's 80 GB). The reference's raw XLA numbers (``xla_flops``,
``xla_bytes_accessed``), ``transcendentals`` and
``generated_code_size_in_bytes`` have no counterpart: nothing is compiled.

Cut and extrapolated. An eager trace runs every op of every layer and of
every attention chunk pair, which at full depth and 32k tokens is millions
of dispatches. So each step is traced on cut programs and every term is
extrapolated by the polynomial that describes it exactly: in depth, one
and two groups of the periodic blocks (the reference's scan body, whose
trip count its analyzer multiplies by), each term linear in the group
count; in sequence, for train and prefill shapes longer than five
attention chunks (5 x 512 tokens), 1,024 to 2,560 tokens, each term a
cubic in the chunk count: the blockwise attention's chunk pairs are
quadratic, and in the backward each pair's ``select`` of a chunk hands
autograd a gradient as large as the whole sequence, a cubic term of the
bytes; every other op is linear. Where a whole number of chunks holds a
fractional MoE capacity (kimi-k2: a third of an expert slot a chunk), the
cuts step by that many chunks, so the capacity's rounding does not bend
the fit. An encoder whose depth is a multiple of the group count is cut in
proportion. FLOPs, bytes and collectives are exact under this
(``tests/test_torch_dryrun.py`` holds them to a full trace); the temp
size, a peak, is extrapolated the same way and is an estimate, as is the
MoE capacity's rounding at the cut lengths. ``analyze_step(...,
full=True)`` traces the whole program instead.

``--trace-dir`` (``--hlo-dir``) archives each traced program's op list,
compressed with ``lzma`` (``<tag>__<step>.ops.xz``): ``--reanalyze``
recounts FLOPs, bytes and collectives from it and patches the stored JSONs
without tracing again.

Usage (on the CPU; the sweep takes minutes, one combination seconds):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import lzma
import math
import os
import time
import traceback
from fractions import Fraction

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import HBM_PER_CHIP, init_fake_process_group, make_production_mesh
from repro_torch.models import model as MDL
from repro_torch.sharding.annotate import is_dtensor, logical_axis_size, sharding_context
from repro_torch.sharding.rules import MeshAxes, Spec, param_specs, serve_specs, train_batch_specs
from repro_torch.utils import tree as tu

#: the attention chunk (``layers.blockwise_attention``'s q/kv chunk)
SEQ_CHUNK = 512
#: the cut sequence lengths, in chunks: a cubic needs four (module doc); one
#: chunk is left out, where the attention's reshapes need no copy
SEQ_POINTS = (2, 3, 4, 5)
#: the cut depths, in groups of the periodic blocks (a line needs two)
DEPTH_POINTS = (1, 2)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """6*N(_active) analytic FLOPs per token (roofline MODEL_FLOPS term)."""
    d = cfg.d_model
    n_active = cfg.vocab_size * d  # embed+unembed counted once
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            hd = cfg.resolved_head_dim
            n_active += d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
        else:
            d_inner = cfg.ssm_expand * d
            n_active += d * (2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_head_dim)
            n_active += d_inner * d
        if cfg.ffn_kind(i) == "moe":
            n_active += cfg.top_k * 3 * d * cfg.d_ff
            if cfg.dense_residual:
                n_active += 3 * d * cfg.dense_residual_ff
        elif cfg.d_ff:
            n_active += 3 * d * cfg.d_ff
    for _ in range(cfg.encoder_layers):
        hd = cfg.resolved_head_dim
        n_active += d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * cfg.d_ff
    return 6.0 * n_active


def total_params(cfg: ModelConfig) -> float:
    """Every parameter leaf's element count, summed."""
    leaves = tu.flatten(_fake_params(cfg)).values()
    return float(sum(math.prod(leaf.shape) for leaf in leaves))


def _fake_params(cfg: ModelConfig) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return MDL.init(cfg, torch.Generator())


# --------------------------------------------------------------------------
# one traced program
# --------------------------------------------------------------------------


def _local_bytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if is_dtensor(leaf) else leaf
            total += local.numel() * local.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _trace(cfg: ModelConfig, shape: InputShape, mesh, step: str) -> dict:
    """Trace ``step`` of (cfg, shape) once on ``mesh``: its terms."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ax = MeshAxes(cfg, mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        pshapes = MDL.init(cfg, torch.Generator())
        if step in ("train", "merge"):
            fn, args = _train_args(cfg, shape, mesh, ax, pshapes, step)
        elif step == "prefill":
            batch = SP.prefill_specs(cfg, shape.global_batch, shape.seq_len)
            args = (ST.layout_tree(pshapes, param_specs(cfg, pshapes, mesh), mesh),
                    ST.layout_tree(batch, serve_specs(cfg, batch, mesh), mesh))
            fn = ST.make_partitioned_prefill_step(cfg, mesh)
        else:
            window = SP.decode_window(cfg, shape)
            ins = SP.decode_specs(cfg, shape.global_batch, shape.seq_len, window)
            cache = ST.layout_tree(ins["cache"], serve_specs(cfg, ins["cache"], mesh), mesh)
            cache["cur_len"] = shape.seq_len - 1
            toks = {"tokens": ins["tokens"]}
            args = (ST.layout_tree(pshapes, param_specs(cfg, pshapes, mesh), mesh), cache,
                    ST.layout_tree(toks, serve_specs(cfg, toks, mesh), mesh)["tokens"])
            fn = ST.make_partitioned_decode_step(cfg, mesh, window)
        arg_bytes = _local_bytes(args)
        with CA.CostMode(record=True) as mode:
            out = fn(*args)
        out_bytes = _local_bytes(out)
        temp = max(mode.peak_bytes - mode.live_bytes, 0)
    return {"costs": mode.costs, "ops": mode.ops, "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes, "temp_size_in_bytes": temp,
            "trace_s": time.perf_counter() - t0}


def _train_args(cfg, shape, mesh, ax, pshapes, step):
    r = ax.n_replicas
    if shape.global_batch % r:
        raise ValueError(f"global batch {shape.global_batch} does not split over {r} replicas")
    flat = tu.flatten(pshapes)
    reps = {k: ((r,) + tuple(v.shape), v.dtype) for k, v in flat.items()}
    rep_specs = param_specs(cfg, reps, mesh, with_replica_dim=True)
    replicas = ST.layout_replicas(reps, rep_specs, mesh, ax)
    _, n = ST.replica_coordinate(mesh, ax)
    vec = torch.full((r // n,), 1.0 / r)
    if step == "train":
        b_rep = shape.global_batch // r
        batch = {k: ((r,) + tuple(s), dt)
                 for k, (s, dt) in SP.train_specs(cfg, b_rep, shape.seq_len).items()}
        batch = ST.layout_replicas(batch, train_batch_specs(cfg, batch, mesh), mesh, ax)
        return ST.make_partitioned_train_round(cfg, mesh), (replicas, batch, vec,
                                                            torch.ones(r // n))
    # Algorithm-2 merge (the paper's all-reduce model merging); memory-lean
    # (no global copies) for the pod-axis archs, as in the reference
    keep_global = cfg.replica_axis != "pod"
    merge = ST.make_partitioned_merge_step(cfg, mesh, keep_global=keep_global)
    if not keep_global:
        return merge, (replicas, vec)
    inner = ST.inner_mesh(mesh, ax)
    g_specs = {k: Spec(*s[1:]) for k, s in rep_specs.items()}
    glob = ST.layout_tree({k: (tuple(v.shape), v.dtype) for k, v in flat.items()}, g_specs, inner)
    prev = ST.layout_tree({k: (tuple(v.shape), v.dtype) for k, v in flat.items()}, g_specs, inner)
    return merge, (replicas, vec, glob, prev)


# --------------------------------------------------------------------------
# cut programs and the extrapolation (module doc)
# --------------------------------------------------------------------------


def _n_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    prefix, period = MDL.find_prefix_period(MDL.layer_pattern(cfg))
    return prefix, period, (cfg.n_layers - prefix) // period


def _chunk_step(cfg: ModelConfig, tokens_a_chunk: int, groups: int) -> int:
    """The fewest attention chunks whose MoE capacity (``round(t // G * k *
    1.25 / E)``) is a whole number, so that it grows exactly in proportion
    from one cut to the next (kimi-k2: 3); 1 without experts, and where no
    count up to 8 does."""
    if not cfg.n_experts:
        return 1
    per_chunk = Fraction(tokens_a_chunk // max(groups, 1)) * cfg.top_k * Fraction(5, 4) \
        / cfg.n_experts
    return per_chunk.denominator if per_chunk.denominator <= 8 else 1


def trace_plan(cfg: ModelConfig, shape: InputShape, step: str, full: bool = False,
               tokens_a_chunk: int = 0, moe_groups: int = 1):
    """([(groups, seq_len)] to trace, the full (groups, seq_len)).
    ``tokens_a_chunk``: the MoE's tokens in one chunk of the sequence (its
    batch times ``SEQ_CHUNK``), ``moe_groups`` its dispatch groups."""
    prefix, period, groups = _n_groups(cfg)
    depths = [g for g in DEPTH_POINTS if g < groups] if groups > DEPTH_POINTS[-1] else [groups]
    if full or len(depths) < len(DEPTH_POINTS):
        depths = [groups]
    seqs = [shape.seq_len]
    m = _chunk_step(cfg, tokens_a_chunk, moe_groups) if tokens_a_chunk else 1
    points = [m * n for n in (SEQ_POINTS if m == 1 else range(1, len(SEQ_POINTS) + 1))]
    long = shape.seq_len > SEQ_CHUNK * points[-1] and shape.seq_len % SEQ_CHUNK == 0
    if not full and step in ("train", "prefill") and long:
        seqs = [SEQ_CHUNK * n for n in points]
    return [(g, s) for g in depths for s in seqs], (groups, shape.seq_len)


def _cut(cfg: ModelConfig, groups: int) -> ModelConfig:
    """``cfg`` with ``groups`` groups of its periodic blocks, and an encoder
    cut in proportion where its depth is a multiple of the group count
    (seamless: one encoder layer a decoder layer), so every term stays
    linear in ``groups``."""
    prefix, period, full = _n_groups(cfg)
    if groups == full:
        return cfg
    enc = cfg.encoder_layers
    if enc and enc % full == 0:
        enc = groups * (enc // full)
    return dataclasses.replace(cfg, n_layers=prefix + groups * period, encoder_layers=enc)


def _lagrange(xs, ys, x) -> float:
    """The polynomial through (xs, ys) at x."""
    total = 0.0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        total += w * yi
    return total


def _extrapolate(points: dict, target: tuple, term, seq_degree: int = 3) -> float:
    """``term`` of the traced points {(groups, seq): record} at ``target``:
    a polynomial in the sequence's chunk count (of ``seq_degree``, through
    the longest cuts) at each depth, then a line in the group count."""
    depths = sorted({g for g, _ in points})
    at_depth = []
    for g in depths:
        seqs = sorted(s for gg, s in points if gg == g)[-(seq_degree + 1):]
        ys = [term(points[(g, s)]) for s in seqs]
        at_depth.append(ys[0] if len(seqs) == 1 else
                        _lagrange([s / SEQ_CHUNK for s in seqs], ys, target[1] / SEQ_CHUNK))
    if len(depths) == 1:
        return at_depth[0]
    return _lagrange(depths, at_depth, target[0])


TRACE_ARCHIVE: dict = {"dir": None, "tag": None}  # set by main() per combination


def _archive(step: str, plan: list, traces: list) -> None:
    """The traced programs' op lists, one lzma file a step."""
    if TRACE_ARCHIVE["dir"] is None:
        return
    os.makedirs(TRACE_ARCHIVE["dir"], exist_ok=True)
    path = os.path.join(TRACE_ARCHIVE["dir"], f"{TRACE_ARCHIVE['tag']}__{step}.ops.xz")
    payload = {"points": [list(p) for p in plan],
               "target": traces[0]["target"],
               "ops": [t["ops"] for t in traces]}
    with lzma.open(path, "wt") as f:
        json.dump(payload, f)


def analyze_step(cfg: ModelConfig, shape: InputShape, mesh, step: str,
                 full: bool = False) -> dict:
    """Trace the cut programs of ``step``, extrapolate, and return the
    step's record (module doc)."""
    ax = MeshAxes(cfg, mesh)
    b = shape.global_batch // ax.n_replicas if step in ("train", "merge") else shape.global_batch
    rules = ax.activation_rules() if step in ("train", "merge") else ax.serve_rules()
    moe_groups = 1
    if cfg.moe_dispatch == "sharded":
        with sharding_context(mesh, rules):
            moe_groups = logical_axis_size("experts")
    plan, target = trace_plan(cfg, shape, step, full, tokens_a_chunk=b * SEQ_CHUNK,
                              moe_groups=moe_groups)
    points, traces = {}, []
    for groups, seq in plan:
        cut_shape = dataclasses.replace(shape, seq_len=seq)
        rec = _trace(_cut(cfg, groups), cut_shape, mesh, step)
        rec["target"] = list(target)
        points[(groups, seq)] = rec
        traces.append(rec)
    _archive(step, plan, traces)
    return _record(points, target, mesh, traced=plan)


def _record(points: dict, target: tuple, mesh, traced: list) -> dict:
    def ext(term):
        value = _extrapolate(points, target, term)
        # every term grows with depth and length: a value under the largest
        # cut's means the cuts do not run one program (a layout that
        # changed with the size), and the extrapolation does not hold
        largest = max(term(r) for r in points.values())
        if value < largest * (1 - 1e-9):
            raise ValueError(f"the cut programs do not extrapolate to {target}: "
                             f"{value:.6g} below a cut's {largest:.6g}")
        return value

    colls = CA.COLLECTIVES
    mem = {k: int(round(ext(lambda r, k=k: r[k]))) for k in
           ("argument_size_in_bytes", "output_size_in_bytes")}
    # a peak: linear in the sequence through the two longest cuts (a
    # quadratic through three amplifies its steps), and never below the
    # longest cut's
    mem["temp_size_in_bytes"] = int(round(max(
        _extrapolate(points, target, lambda r: r["temp_size_in_bytes"], seq_degree=1),
        max(r["temp_size_in_bytes"] for r in points.values()))))
    return {
        "flops": ext(lambda r: r["costs"].flops),
        "hbm_bytes": ext(lambda r: r["costs"].hbm_bytes),
        "collectives": {
            "bytes": {c: ext(lambda r, c=c: r["costs"].collective_bytes[c]) for c in colls},
            "counts": {c: ext(lambda r, c=c: r["costs"].collective_counts[c]) for c in colls},
        },
        "memory": mem,
        "fits_hbm": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] <= HBM_PER_CHIP,
        "trace_s": sum(r["trace_s"] for r in points.values()),
        "n_devices": int(math.prod(mesh.shape)),
        "traced": [list(p) for p in traced],
    }


def lower_combo(cfg: ModelConfig, shape: InputShape, mesh, full: bool = False) -> dict:
    """Trace and analyze every step relevant to (cfg, shape) on ``mesh``."""
    steps = {"train": ("train", "merge"), "prefill": ("prefill",), "decode": ("decode",)}
    return {step: analyze_step(cfg, shape, mesh, step, full) for step in steps[shape.mode]}


def combo_record(arch: str, cfg: ModelConfig, shape_name: str, shape: InputShape, mesh,
                 mesh_tag: str, full: bool = False) -> dict:
    """The JSON record of one combination (module doc)."""
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape))),
        "steps": lower_combo(cfg, shape, mesh, full=full),
        "model_flops_per_token": model_flops_per_token(cfg),
        "total_params": total_params(cfg),
        "tokens_per_step": shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1),
        "mode": shape.mode,
    }


def reanalyze(out_dir: str, trace_dir: str) -> None:
    """Recount FLOPs, bytes and collectives from archived op lists and patch
    the stored JSONs (nothing is traced)."""
    for fn in sorted(os.listdir(trace_dir)):
        if not fn.endswith(".ops.xz"):
            continue
        tag, step_name = fn[: -len(".ops.xz")].rsplit("__", 1)
        jpath = os.path.join(out_dir, tag + ".json")
        if not os.path.exists(jpath):
            continue
        with lzma.open(os.path.join(trace_dir, fn), "rt") as f:
            payload = json.load(f)
        with open(jpath) as f:
            rec = json.load(f)
        step = rec["steps"].get(step_name)
        if step is None:
            continue
        points = {tuple(p): {"costs": CA.costs_from_ops(ops)}
                  for p, ops in zip(payload["points"], payload["ops"])}
        target = tuple(payload["target"])
        step["flops"] = _extrapolate(points, target, lambda r: r["costs"].flops)
        step["hbm_bytes"] = _extrapolate(points, target, lambda r: r["costs"].hbm_bytes)
        step["collectives"] = {
            "bytes": {c: _extrapolate(points, target, lambda r, c=c: r["costs"].collective_bytes[c])
                      for c in CA.COLLECTIVES},
            "counts": {c: _extrapolate(points, target,
                                       lambda r, c=c: r["costs"].collective_counts[c])
                       for c in CA.COLLECTIVES},
        }
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[reanalyzed] {tag}__{step_name}")


def _mesh(multi_pod: bool):
    """The production mesh over a fake group of its size. A ``cpu`` mesh:
    the fake group moves nothing whatever the device type, and fake CUDA
    tensors need a CUDA build (the cost mode counts DTensor's all-to-all
    stand-in on a ``cpu`` mesh as the all-to-all)."""
    init_fake_process_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--trace-dir", "--hlo-dir", dest="trace_dir", default="results/traces_torch",
                    help="archive the traced op lists (lzma) here ('' = off)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recount from the archived op lists, no tracing")
    ap.add_argument("--moe-dispatch", default="", choices=["", "global", "sharded"],
                    help="override cfg.moe_dispatch (perf experiments)")
    ap.add_argument("--moe-combine-dtype", default="", choices=["", "f32", "bf16"],
                    help="override cfg.moe_combine_dtype (perf experiments)")
    ap.add_argument("--moe-decode-gather", action="store_true",
                    help="decode-time expert-gather FFN (perf experiments)")
    ap.add_argument("--remat", default="", choices=["", "on", "off"],
                    help="override cfg.remat (perf experiments)")
    ap.add_argument("--remat-policy", default="", choices=["", "full", "dots"],
                    help="override cfg.remat_policy (perf experiments)")
    ap.add_argument("--tag-suffix", default="",
                    help="suffix for result filenames (perf experiments)")
    args = ap.parse_args(argv)

    if args.reanalyze:
        reanalyze(args.out, args.trace_dir)
        return

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for multi_pod in meshes:
        mesh = _mesh(multi_pod)
        mtag = "multipod" if multi_pod else "singlepod"
        for arch in archs:
            cfg = ARCHS[arch]
            if args.moe_dispatch:
                cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)
            if args.moe_combine_dtype:
                cfg = dataclasses.replace(cfg, moe_combine_dtype=args.moe_combine_dtype)
            if args.remat:
                cfg = dataclasses.replace(cfg, remat=args.remat == "on")
            if args.moe_decode_gather:
                cfg = dataclasses.replace(cfg, moe_decode_gather=True)
            if args.remat_policy:
                cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
            for shape_name in shapes:
                shape = INPUT_SHAPES[shape_name]
                tag = f"{arch}__{shape_name}__{mtag}{args.tag_suffix}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                TRACE_ARCHIVE["dir"] = args.trace_dir or None
                TRACE_ARCHIVE["tag"] = tag
                t0 = time.perf_counter()
                try:
                    record = combo_record(arch, cfg, shape_name, shape, mesh, mtag)
                    res = record["steps"]
                    with open(path, "w") as f:
                        json.dump(record, f, indent=1)
                    dt = time.perf_counter() - t0
                    step = next(iter(res.values()))
                    print(
                        f"[ok] {tag} trace={dt:.1f}s flops={step['flops']:.4g} "
                        f"coll={sum(step['collectives']['bytes'].values()):.4g}B "
                        f"arg={step['memory']['argument_size_in_bytes']:.4g}B "
                        f"temp={step['memory']['temp_size_in_bytes']:.4g}B "
                        f"fits={step['fits_hbm']}", flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — listed, and the exit code says so
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\ndry run: {time.perf_counter() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nAll dry-run combinations traced and analyzed successfully.")


if __name__ == "__main__":
    main()
