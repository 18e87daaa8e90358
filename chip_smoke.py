#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them.
2. build   — compiles the six ``src/repro_torch/csrc/*.cu`` sources
   (spmm, spmm_grad_w, weighted_merge, flash_attention, ssd_scan, moe_gmm)
   with nvcc, one process per source, in parallel, and loads the library.
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (plus ragged shapes and bf16), with
   the reference's kernel tolerances; times kernel, plain version and one
   PyTorch library call: device time from the profiler's trace, and
   CUDA events around each call (median of 20 after warm-up), which also
   count the host's cost of issuing it. spmm and spmm_grad_w must also be
   deterministic (two launches bitwise equal), spmm_grad_w also on 48 small
   edge cases of its chunking held against an f64 scatter; spmm_grad_w's
   output lands in memory that held NaN (at the main shape and in the
   one-row edge cases), and every row no slot names must come out exactly
   0; a NaN in a W row that only padding names reaches spmm's output, and a
   NaN in dh of a padded sample spmm_grad_w's row 0, where the plain
   versions put it, and an infinite val in a masked slot changes nothing
   (its scale is exactly 0, as the reference's select gives it); the
   counting sort that spmm_grad_w walks must give
   exactly the order of torch's stable sort (timed beside it); spmm and
   spmm_grad_w print each of their kernels' device time; and spmm's
   autograd Function (dW and d feat_val) must agree with autograd through
   the plain forward. The LM serving kernels likewise: flash_attention at the
   llama3.2-1b, moonshot-v1-16b-a3b and kimi-k2 (hd 112) prefill shapes,
   ssd_scan at the mamba2-780m one, moe_ffn_gmm at the moonshot one (bf16,
   B = 2, S = 4096; kimi-k2 B = 1), plus the reference's test shapes
   (ragged, windowed, non-causal, f32 and bf16; the bf16 ones reach the
   tensor-core paths of flash_attention and moe_ffn_gmm, the f32 ones their
   CUDA-core paths; ssd_scan runs on the tensor cores at every dtype, also
   at a ragged P, N and chunk, an N past 128 and a chunk past 256, and
   prints its three passes' device times)
   and every head dim flash_attention takes on both paths,
   with the reference's tolerances except flash_attention at S = 4096 (one
   bf16 ulp per element, relative L2 error 1e-2); each timed beside its
   bound, its plain version and, where one exists, one PyTorch call (SDPA;
   three bmm).
4. slice   — the port's trainer on the card against the same trainer on the
   CPU (plain versions), same weights and data, small width: every
   registered algorithm, plus adaptive and sync with dense gradients and
   adaptive under the legacy_loop engine, 2 mega-batches each; the host
   decisions must be identical and the losses agree within tolerance.
5. main    — the paper's experiment at Amazon-670K width (135,909 features,
   670,091 classes, hidden 128): Adaptive SGD, R = 4, b_max 256, 3
   mega-batches of 20 batches, with evaluation, through
   ``ElasticTrainer.run``. Checks finite losses and model, and that every
   kernel launch count is what the run needed. One more mega-batch runs
   under the profiler: the device busy share and the top kernels.
6. paths   — the same width and data: Adaptive SGD with dense gradients
   (``spmm_grad_w`` every round) for 2 mega-batches against a sparse run
   from the same weights (host decisions identical, losses within a
   relative 1e-4, one spmm_grad_w launch per round), one more dense
   mega-batch under the profiler; then elastic, sync, crossbow,
   delayed_sync and single for one mega-batch each.
7. serve   — the LM serving path on the card against the CPU at reduced
   size, same weights, kernel flags on: llama3.2-1b, mamba2-780m,
   moonshot-v1-16b-a3b and jamba-1.5-large-398b. prefill's logits and
   four decode steps within 2e-3 (the reference's kernel integration
   tolerance), greedy tokens identical, and one kernel launch per layer
   that reaches it, every ssd_scan launch on the tensor cores.
8. prefill — full width on one card, bf16, B = 2, S = 4096 (cut from
   ``INPUT_SHAPES["prefill_32k"]``: batch 32 -> 2, sequence 32,768 ->
   4,096): llama3.2-1b (16 layers) and mamba2-780m (48 layers) at full
   depth, moonshot-v1-16b-a3b cut to 4 of its 48 layers (1 dense, 3 MoE).
   Each prefill runs with the kernel flags on, its launch counts equal to
   the layers that reach each kernel, every flash_attention, moe_ffn_gmm
   and ssd_scan launch on the tensor-core path, its last-position logits held
   against the flags-off prefill (the model's plain paths on the card);
   the flags-off prefill is timed cold and warm (median of three); then
   peak device memory, one prefill with the flags on and one with them off
   under the profiler, ``greedy_generate`` (32-token prompt, 16
   new tokens; decode steps/s the median of three runs) and one greedy run
   under the profiler (the device's busy share of a decode step). Last,
   moonshot's last-position logits over eight more token draws: flags on
   and off against each other and against an f32 prefill (printed only).
9. train   — LM training through ``ElasticTrainer.run`` (Adaptive SGD,
   R = 4, kernel flags off: the LM kernels are forward-only, as in the
   reference). (a) Reduced llama3.2-1b, mamba2-780m, moonshot-v1-16b-a3b
   and jamba-1.5-large-398b in f32 (TF32 off), 2 mega-batches on the card
   against the CPU: host decisions identical, losses and the global model
   within 1e-4, one weighted_merge launch per leaf and barrier. (b)
   tinyllama-1.1b at full width and depth (22 layers, d_model 2048, vocab
   32,000, bf16, remat), 4 replicas x b_max 4 x 1,024 tokens a round (cut
   from ``INPUT_SHAPES["train_4k"]``: sequence 4,096 -> 1,024, global
   batch 256 -> 16), mega_batch 8, 3 mega-batches: loss, u, b, alphas, wall
   seconds and tokens/s a mega-batch, finite losses and no guard repair,
   launch counts, peak memory and the init time; one more round by hand
   (every leaf's gradient finite and nonzero in every replica); the
   weighted_merge of that barrier, leaf by leaf, against its plain version
   within one bf16 ulp (``MERGE_BF16_TOL``; a merge without the momentum
   term, with g and gp swapped or with the norm leaves zeroed must fail
   it), timed per barrier beside its byte bound and one ``einsum`` a leaf;
   and one warm mega-batch under the profiler (top device ops, the
   device's busy share and the host's).

10. elastic — the XML model at phase 5's width and data through
   ``ElasticTrainer.run`` with a resize schedule (R 4 -> 6 before
   mega-batch 2 -> 3 before 5), a ``FleetController`` firing every fault
   kind (a NaN, a crash, a stall, a preemption, a join; the readmissions)
   and a ``CheckpointManager`` every mega-batch in a temporary directory.
   (a) Adaptive SGD, 8 mega-batches with evaluation: the fleet log, each
   resize's, eviction's and guard repair's wall time, each checkpoint's
   bytes, synchronous snapshot and background write, the peak device
   memory of each mega-batch (R = 6's printed apart), and launch counts
   derived from the records and the fleet log (``weighted_merge``: 4
   leaves a barrier, resize, eviction, readmission, join and donor merge).
   (b) A fresh trainer restores the checkpoint after mega-batch 4, with a
   copy of the controller as it stood then (no checkpoint holds fleet
   state), and finishes the run: host decisions and fleet log identical,
   losses and global model within 1e-5 relative. (c) The same schedule
   and faults on the dense-gradient path (``spmm_grad_w``), 4
   mega-batches: host decisions equal (a)'s, launch counts checked. (d)
   Phase 4's small width, the elastic run on the card against the CPU:
   host decisions and fleet log identical, losses and model within 1e-5.
11. overlap — the overlapped mega-batch pipeline (the trainer's default
   since phase 4; phase 10's checkpoints are taken while a mega-batch is
   staged, and (b) replays it) against the sequential path: phase 5's
   width and data, Adaptive SGD, R = 4, 4 mega-batches with evaluation
   after each through ``ElasticTrainer.run`` with ``overlap=False`` and
   then ``overlap=True`` from the same weights and seed. Host decisions
   identical, losses, accuracies and the global model within 1e-5
   relative; launch counts what the plans need; every dispatch-to-collect
   window run under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   sync inside it raises); no staging slot allocated after the second
   mega-batch. Prints, both ways: the warm mega-batch wall time (median of
   mega-batches 2-4), the device busy share over one more warm mega-batch
   under the profiler, the host's staging time (plan, pack, upload) and
   bytes a mega-batch, and peak device memory.
12. measured — the measured speed model (``MeasuredSpeedModel``: the
   paper's §3.1 loop, plans on relative speeds from real mega-batch
   times). (a) Phase 4's small width, Adaptive SGD, R = 4, the pipeline on,
   6 mega-batches through a resize 4 -> 6 -> 3, on the card with a timer
   that records its readings of ``time.perf_counter``; a CPU run of the
   port replays those readings through a scripted timer: host decisions
   and factors identical every mega-batch, losses and model within 1e-4.
   (b) Phase 5's width and data, 8 mega-batches with evaluation, the
   pipeline on and then off: per mega-batch the measured window, the
   rounds' device time (CUDA events), the evaluation's device time and
   its estimated share inside the next window, factors, b and u; every
   window at least the rounds' device time, every factor finite, one
   ``weighted_merge`` launch a leaf a barrier. (c) The same with
   ``keep_global_copies=False`` (pipeline on): ``init_state`` allocates one
   model less (the global and prev-global copies share one set of
   tensors), within 1 MB, peak memory beside (b)'s, and the first two
   barriers launch ``weighted_merge``'s no-momentum branch (counted by the
   wrapper), the rest its momentum branch. (d) Phase 4's width, Nesterov
   (momentum 0.9) and clipping (1.0), on the row-sparse and the dense
   (``spmm_grad_w``) path, card against CPU within 1e-4. (e) Phase 5's
   8,192-sample dataset through ``write_libsvm`` and ``read_libsvm``: the
   arrays back equal (the values as their 6-digit text), seconds and bytes.
13. sharded — the sharded placement (replicas split over a replica mesh, a
   worker thread and a CUDA stream a shard, the merge's partials summed
   over the shards): phase 5's width and data, Adaptive SGD, R = 4, the
   pipeline on. (a) A one-shard mesh against vmap, 3 mega-batches: host
   decisions identical, losses and model within 1e-6. (b) Four shards on
   the one card (``("cuda:0",) * 4``) against vmap, 4 mega-batches: host
   decisions identical, losses and model within 1e-5; spmm launched by
   every shard each round and weighted_merge's no-momentum branch by every
   shard each barrier (counted by thread); the warm mega-batch wall time,
   the device's busy share (the union of the streams' kernel intervals)
   and peak memory beside vmap's. (c) The same mesh under
   ``MeasuredSpeedModel``, 6 mega-batches: each shard's CUDA-event window,
   the factors, u and b, and ``observe_shards`` once a mega-batch; then at
   phase 4's width the card's shard windows and clock readings replayed on
   four CPU shards: host decisions and factors identical. (d) The resize
   schedule 4 -> 2 -> 4 and a crash (R 3 on three shards), a checkpoint
   written sharded after mega-batch 3 and restored under vmap: host
   decisions and fleet log identical, the model within phase 10's limit of
   its movement since the restore. (e) Dense gradients at phase 4's width
   (``spmm_grad_w`` on every shard), card against four CPU shards.
14. multiprocess — multi-process training (``launch.multihost``): fleets
   of child processes (fresh interpreters of this script, or the port's
   spawner ``repro_torch.launch.multihost_launch`` driving the launcher),
   their exchange dirs on /dev/shm where it has room. (a) Host span (the
   file exchange and heartbeat leases), two processes of two shards each on
   the one card (``("cuda:0",) * 2`` a process), phase 5's width and data,
   Adaptive SGD, the pipeline on, 4 mega-batches, against one process of
   four shards from the same seed: host decisions identical, losses within
   1e-5, the model within phase 13's limit of its movement; each process's
   launches (counted in the child: spmm by both shards each round and each
   evaluation, the no-momentum weighted_merge by both shards a leaf and
   barrier), warm mega-batch, the exchange's seconds and bytes per barrier
   and share of the mega-batch, peak memory, and one more mega-batch under
   the profiler (this process's busy share). (b) The heartbeat drill
   through the spawner at phase 4's width: process 1 SIGKILLed once its
   lease reads mega-batch 2; the survivor evicts it (``action=evict``,
   ``process=1``, crash), finishes 8 mega-batches at R = 2 with finite
   losses and exits 0, the spawner reporting the kill as expected. (c) The
   device span (``torch.distributed``, gloo: two ranks share the card) of
   ``sync`` (in-round collectives across the processes) and ``adaptive``
   at phase 4's width against one process of four shards: decisions
   identical, losses within 1e-5. (d) Dense gradients under a host span at
   phase 4's width, a card fleet against a CPU fleet: within 1e-5. Where
   the machine shows two or more cards, (a) and (c) run again with a card
   of its own a process (NCCL for (c)); ``--only-multiprocess`` runs this
   phase alone after the build.

Then one JSON line with every kernel's numbers (weighted_merge's from
phase 3's f32 w2 leaf, with phase 9's full-width barrier under
``lm_barrier``, per barrier, and its launches on every path; spmm's and
spmm_grad_w's launches on theirs, under ``launches_by_path``; phase 11's and
12's runs among them, with weighted_merge's no-momentum launches of phase
12 (b, c), 13 and 14 under ``no_momentum_launches_by_path``; phase 13's paths are
``xml_sharded*``, phase 14's ``xml_multiprocess*``, each fleet's launches
summed over its processes), and as
the last line
``{"ok": true, "device": {...}}``. The data are synthetic, drawn from
``SEED``; the weights are random.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # bf16 dense tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12        # TF32 dense tensor cores, H100 SXM data sheet
F32_TOL = dict(rtol=2e-4, atol=2e-5)   # the reference's kernel tolerances
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # (tests/test_kernels.py)
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)        # flash_attention and moe_gmm, f32
BF16_ATTN_TOL = dict(rtol=3e-2, atol=3e-2)   # flash_attention and ssd_scan, bf16
# flash_attention at the S = 4096 prefill shapes: an output row averages v
# over up to 4096 keys, so |o| is often ~0.03 and the 3e-2 above (set for
# 128-long rows) would pass a kernel that drops a KV tile. The plain version
# computes in f32; the kernel's bf16 path sums exact products of the bf16
# inputs in f32 and takes P into P.V as a bf16 hi/lo pair (P to 2^-16 of
# itself; P rounded once to bf16 fails this check, see
# tests/test_torch_lm_kernels.py). Both round to bf16 once, so they differ by
# at most one bf16 ulp (under 2^-7 of the value): hold each element to that,
# and the whole output to a relative L2 error of 1e-2.
BF16_LONG_ATTN_TOL = dict(rtol=1e-2, atol=1e-3, rel_l2=1e-2)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)         # ssd_scan, f32
# ssd_scan at the main shape: f32 sums over 256-long chunks and a 16-chunk
# recurrence, taken in another order than the plain version's einsums, and
# products on the tensor cores in a 3xTF32 split (rounded once, x and the
# scores fail it: tests/test_torch_lm_kernels.py)
SSD_MAIN_TOL = dict(rtol=1e-3, atol=1e-3)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_us(event) -> float:
    """Self device time (us) of one profiler key-average row."""
    t = getattr(event, "self_device_time_total", None)
    return float(t if t is not None else getattr(event, "self_cuda_time_total", 0.0))


def device_ms(fn, reps: int = 20):
    """Mean device time per call of the kernels ``fn`` launches, summed from
    the profiler's CUPTI trace: no host gaps. None if the trace has none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(device_us(e) for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def device_ms_by_kernel(fn, reps: int = 20) -> list:
    """(name, device ms per call, launches per call) of each kernel ``fn``
    launches, from the profiler's trace, largest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, device_us(e) / reps / 1e3, e.count // reps)
            for e in sorted(prof.key_averages(), key=lambda e: -device_us(e))]


def device_breakdown(label: str, fn, reps: int = 20) -> dict:
    """Print and return the device ms a call of each kernel ``fn`` launches,
    by kernel name (no namespaces, template arguments or parameters)."""
    rows = [(name, ms, count) for name, ms, count in device_ms_by_kernel(fn, reps)
            if count and ms > 0]
    for name, ms, count in rows:
        print(f"{label} by kernel: {ms:.4f} ms/call x{count} {name[:90]}")
    short = (re.match(r"(?:void )?([\w:]+)", n.replace("(anonymous namespace)::", ""))
             for n, _, _ in rows)
    return {m.group(1).split("::")[-1]: ms for m, (_, ms, _) in zip(short, rows)}


def profile_call(label: str, fn, top: int):
    """One call of ``fn`` under the profiler: wall time, the device's busy
    time and op count, and the ``top`` kernels by device time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(prof.key_averages(), key=lambda e: -device_us(e))
    busy = sum(device_us(e) for e in per_kernel) / 1e6
    n_ops = sum(e.count for e in per_kernel)
    print(f"profile {label}: {wall:.3f} s wall, device busy {busy:.3f} s "
          f"({busy / wall:.1%}), {n_ops} device ops")
    for e in per_kernel[:top]:
        print(f"profile {label}: {device_us(e) / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")
    return wall, busy, n_ops


def check_close(what: str, got, want, tol: dict) -> float:
    """Max |got - want| in f32; raises if outside ``tol`` (rtol and atol
    per element, and, where it names one, ``rel_l2`` on the whole)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    rel = ((got - want).norm() / want.norm()).item() if "rel_l2" in tol else 0.0
    if (got.shape != want.shape or rel > tol.get("rel_l2", 0.0)
            or not torch.allclose(got, want, rtol=tol["rtol"], atol=tol["atol"])):
        raise RuntimeError(f"{what}: kernel disagrees with its plain version "
                           f"(max abs err {err:.3g}, rel L2 err {rel:.3g}, tolerance {tol})")
    if "rel_l2" in tol:
        print(f"{what}: rel L2 err {rel:.3g} (tol {tol['rel_l2']})")
    return err


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---- one run against another (phases 4, 9a and 10) ----
# the decisions the host makes from the virtual clock and the plan: equal
# in two runs of one schedule, whatever the device and the sum orders
HOST_KEYS = ("n_replicas", "u", "b", "lr", "alphas", "n_rounds", "virtual_time",
             "pert_active", "guard_repaired")


def check_host_decisions(label: str, recs: list, want_recs: list) -> None:
    """Raise unless two runs' records hold the same host decisions."""
    if len(recs) != len(want_recs):
        raise RuntimeError(f"{label}: {len(recs)} mega-batches against {len(want_recs)}")
    for a, b in zip(recs, want_recs):
        for k in HOST_KEYS:
            if a.get(k) != b.get(k):
                raise RuntimeError(f"{label}: {k} differs at mega-batch {a['megabatch']}: "
                                   f"{a.get(k)} vs {b.get(k)}")


def rel_err(a, b) -> float:
    """|a - b| / |b|; 0 where both are NaN, infinite where one is."""
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def loss_err(recs: list, want_recs: list, keys=("train_loss", "test_loss")) -> float:
    """The largest relative error of the records' losses."""
    return max(rel_err(a[k], b[k]) for a, b in zip(recs, want_recs) for k in keys)


def model_err(got: dict, want: dict) -> float:
    """The model's error: leaf by leaf, max |got - want| over the leaf's
    largest magnitude where that is below 1 (so never below the absolute
    error); the largest over the leaves."""
    return max(((got[k].float() - want[k].to(got[k].device).float()).abs().max()
                / want[k].float().abs().max().clamp(1e-12, 1.0)).item() for k in want)


def moved_err(got: dict, want: dict, base: dict) -> float:
    """The error against how far training moved the model: leaf by leaf,
    ||got - want|| / ||want - base|| (L2, in f64); the largest over the
    leaves. ``base`` is the model the two runs started from."""
    def norm(t):
        return torch.linalg.vector_norm(t, dtype=torch.float64).item()

    return max(norm(got[k].float() - want[k].float()) / max(norm(want[k].float()
                                                                 - base[k].float()), 1e-300)
               for k in want)


def amazon_like_dataset(n_samples: int, n_features: int, n_classes: int, rng) -> dict:
    """The arrays of a full-width XML ``SparseDataset``, drawn in bulk.

    A stand-in for ``make_xml_dataset``, whose per-class prototype loop
    takes tens of minutes at 670,091 classes: per-sample nnz lognormal
    (log 76, 0.5) clipped to [4, 304], Zipf(0.8) feature ids in one draw
    (deduplicated within a sample), gamma(2, 0.5) values, and a primary
    class followed by Poisson(5) further labels.
    """
    nnz = np.clip(rng.lognormal(np.log(76), 0.5, n_samples), 4, 304).astype(np.int64)
    zipf = 1.0 / np.arange(1, n_features + 1) ** 0.8
    feats = rng.choice(n_features, size=int(nnz.sum()), p=zipf / zipf.sum())
    keys = np.unique(np.repeat(np.arange(n_samples), nnz) * n_features + feats)
    sample, indices = keys // n_features, (keys % n_features).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(sample, minlength=n_samples))])
    n_lab = 1 + rng.poisson(5, n_samples)
    label_ptr = np.concatenate([[0], np.cumsum(n_lab)])
    labels = rng.integers(0, n_classes, int(n_lab.sum())).astype(np.int32)
    labels[label_ptr[:-1]] = rng.integers(0, n_classes, n_samples)
    return dict(
        n_features=n_features, n_classes=n_classes,
        indptr=indptr.astype(np.int64), indices=indices,
        values=rng.gamma(2.0, 0.5, len(indices)).astype(np.float32),
        label_ptr=label_ptr.astype(np.int64), labels=labels,
    )


# phase 9's settings. (a) reduced models, card against CPU: 20 batches of
# up to 4 samples of 16 tokens a mega-batch, so the update counts differ
# across the 4 replicas (tests/torch_lm_runs.py uses the same). (b) full
# width: tinyllama-1.1b, 4 replicas of up to 4 samples of 1,024 tokens a
# round, 8 batches a mega-batch.
LM_SMALL = dict(b_max=4, seq_len=16, mega_batch=20, lr=0.2, megabatches=2)
LM_FULL = dict(arch="tinyllama-1.1b", b_max=4, seq_len=1024, mega_batch=8, lr=0.05,
               megabatches=3)
# card against CPU at small width: f32 with TF32 off, the same sums in other
# orders (cuBLAS, the blockwise attention, the SSD chunks, the MoE combine),
# as phase 4 holds the XML trainer
LM_CARD_CPU_TOL = 1e-4
# the full-width barrier's merge against its plain version: both sum the R
# products and the momentum term in f32 and round to bf16 once, so they
# differ by at most one bf16 ulp, where the f32 sums straddle a rounding
# boundary (under 2^-7 of the value; rtol 8e-3 leaves room). atol only for
# values near zero: the norm leaves start at 0. BF16_TOL's 2e-2 is at or
# above the size of every leaf here (|w| ~ 0.01-0.02) and would pass a
# merge without the momentum term; these three wrong merges must fail it:
MERGE_BF16_TOL = dict(rtol=8e-3, atol=1e-6)
MERGE_MUTANTS = ("no momentum term", "g and gp swapped", "norm leaves zeroed")


def lm_training_phase(dev, reset_counts, read_counts) -> dict:
    """Phase 9: Adaptive SGD trains the decoder-only LM families through
    ``ElasticTrainer.run``. Returns weighted_merge's numbers at one
    full-width barrier, with its launches in the full-width run."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import INPUT_SHAPES, ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer, dense_value_and_grad
    from repro_torch.data.providers import TokenProvider
    from repro_torch.kernels.weighted_merge.ops import merge_cuda, merge_pytree
    from repro_torch.kernels.weighted_merge.ref import weighted_merge_ref
    from repro_torch.models import model as MDL
    from repro_torch.optim.sgd import sgd_update

    R = 4

    def lm_run(cfg, where, b_max, seq_len, mega_batch, lr, megabatches, verbose=False):
        prov = TokenProvider.make(cfg.vocab_size, seq_len, seed=SEED)
        test = prov.test_batches(1, b_max)
        trainer = ElasticTrainer(
            MDL.make_model(cfg), prov,
            ElasticConfig.from_bmax(b_max, n_replicas=R, mega_batch=mega_batch),
            base_lr=lr, seed=SEED, device=where,
        )
        state, mlog = trainer.run(megabatches, test_batches=test, verbose=verbose)
        return trainer, prov, state, mlog

    # ---- (a) small width, card against CPU ----
    for arch in ("llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"):
        cfg = ARCHS[arch].reduced()   # f32, kernel flags off
        reset_counts()
        _, _, card_state, card_log = lm_run(cfg, "cuda", **LM_SMALL)
        torch.cuda.synchronize()
        counts = read_counts()
        _, _, cpu_state, cpu_log = lm_run(cfg, "cpu", **LM_SMALL)
        recs = list(zip(card_log.records, cpu_log.records))
        check_host_decisions(f"train {cfg.name} card vs CPU", card_log.records, cpu_log.records)
        l_err = loss_err(card_log.records, cpu_log.records)
        m_err = model_err(card_state.global_model, cpu_state.global_model)
        want = {name: 0 for name in counts}
        want["weighted_merge"] = len(card_log.records) * len(card_state.global_model)
        print(f"train {cfg.name} card vs cpu: host decisions identical over {len(recs)} "
              f"mega-batches (u {[a['u'] for a, _ in recs]}); loss rel err {l_err:.3g}, "
              f"global model err {m_err:.3g} (tol {LM_CARD_CPU_TOL}); "
              f"weighted_merge launches {counts['weighted_merge']} "
              f"({len(card_state.global_model)} leaves x {len(recs)} barriers)")
        if len(recs) != LM_SMALL["megabatches"] or max(l_err, m_err) > LM_CARD_CPU_TOL:
            raise RuntimeError(f"train {cfg.name}: card and CPU runs disagree beyond tolerance")
        if counts != want:
            raise RuntimeError(f"train {cfg.name}: launch counts {counts} != expected {want}")
        del card_state, cpu_state
    torch.cuda.empty_cache()

    # ---- (b) full width: tinyllama-1.1b, all 22 layers, bf16 ----
    cfg = ARCHS[LM_FULL["arch"]]
    full = {k: v for k, v in LM_FULL.items() if k != "arch"}
    shape = INPUT_SHAPES["train_4k"]
    print(f"train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat_policy}; INPUT_SHAPES['train_4k'] "
          f"cut: seq_len {shape.seq_len} -> {full['seq_len']}, global batch "
          f"{shape.global_batch} -> {R * full['b_max']} a round ({R} replicas x b_max "
          f"{full['b_max']}); mega_batch {full['mega_batch']}, {full['megabatches']} mega-batches "
          f"(the first cold)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer, prov, state, mlog = lm_run(cfg, "cuda", verbose=True, **full)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(state.global_model)
    n_params = sum(v.numel() for v in state.global_model.values())
    tokens = full["mega_batch"] * full["b_max"] * full["seq_len"]
    prev = 0.0
    for rec in mlog.records:
        wall = rec["wall_clock"] - prev
        prev = rec["wall_clock"]
        print(f"train {cfg.name} mb={rec['megabatch']} loss={rec['train_loss']:.6f} "
              f"test_loss={rec['test_loss']:.6f} u={rec['u']} b={rec['b']} "
              f"alphas={rec['alphas']} n_rounds={rec['n_rounds']} seconds={wall:.3f} "
              f"tokens/s={tokens / wall:.0f} guard_repaired={rec.get('guard_repaired', [])}")
    print(f"train {cfg.name}: {n_params / 1e9:.3f} B params in {n_leaves} leaves; init "
          f"{trainer.init_seconds:.1f} s (CPU generator, then to the card); peak device memory "
          f"{peak_gb:.2f} GB; launches {counts}")
    losses = [r[k] for r in mlog.records for k in ("train_loss", "test_loss")]
    if not all(np.isfinite(losses)) or any("guard_repaired" in r for r in mlog.records):
        raise RuntimeError(f"train {cfg.name}: non-finite loss or a guard repair")
    want = {name: 0 for name in counts}
    want["weighted_merge"] = n_leaves * len(mlog.records)
    if counts != want:
        raise RuntimeError(f"train {cfg.name}: launch counts {counts} != expected {want}")
    launches = counts["weighted_merge"]

    # one more round by hand: every leaf's gradient finite and nonzero in
    # every replica (a dropped gradient shows as an all-zero leaf), then the
    # SGD step, so the replicas differ at the barrier measured below
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             prov.stack([prov.fetch(full["b_max"], full["b_max"]) for _ in range(R)]).items()}
    (loss, _), grads = dense_value_and_grad(trainer.model.loss_fn, state.replicas, batch)
    bad = [k for k, g in grads.items()
           if not (torch.isfinite(g).all().item() and bool((g.flatten(1) != 0).any(1).all()))]
    print(f"train {cfg.name} gradients: {len(grads)} leaves, each finite and nonzero in "
          f"every replica: {not bad} {bad}; round loss {loss.tolist()}")
    if bad:
        raise RuntimeError(f"train {cfg.name}: zero or non-finite gradient in {bad}")
    lr = torch.as_tensor(np.asarray(state.lr, np.float32), device=dev)
    sgd_update(state.replicas, grads, lr, trainer.sgd)
    del grads, batch
    torch.cuda.empty_cache()

    # weighted_merge at one barrier of this run: every leaf against its
    # plain version, three wrong merges that the same check must refuse,
    # then timed per barrier beside its bound and one einsum a leaf (the
    # weighted sum without the momentum term)
    reps, g, gp = state.replicas, state.global_model, state.prev_global
    alphas = torch.tensor(mlog.records[-1]["alphas"], dtype=torch.float32, device=dev)
    gamma = trainer.cfg.gamma

    def kernel():
        return merge_pytree(reps, alphas, g, gp, gamma)

    def plain():
        return {k: weighted_merge_ref(v.reshape(R, -1), alphas, g[k].reshape(-1),
                                      gp[k].reshape(-1), gamma) for k, v in reps.items()}

    a_cast = alphas.to(reps[next(iter(reps))].dtype)

    def library():
        return [torch.einsum("r,rn->n", a_cast, v.reshape(R, -1)) for v in reps.values()]

    merge_cuda.launches = 0
    got = kernel()
    per_barrier = merge_cuda.launches
    caught = {m: [] for m in MERGE_MUTANTS}
    err = 0.0
    for k, v in reps.items():
        args = (v.reshape(R, -1), alphas, g[k].reshape(-1), gp[k].reshape(-1))
        want = weighted_merge_ref(*args, gamma)
        err = max(err, check_close(f"weighted_merge barrier {k}", got[k].reshape(-1), want,
                                   MERGE_BF16_TOL))
        wrong = {
            "no momentum term": weighted_merge_ref(*args, 0.0),
            "g and gp swapped": weighted_merge_ref(args[0], alphas, args[3], args[2], gamma),
            "norm leaves zeroed": torch.zeros_like(want) if k.endswith("norm") else want,
        }
        for m, w in wrong.items():
            if not torch.allclose(w.float(), want.float(), **MERGE_BF16_TOL):
                caught[m].append(k)
        del want, wrong
    del got
    for m, leaves in caught.items():
        print(f"weighted_merge barrier, a merge with {m}: fails {MERGE_BF16_TOL} "
              f"in {len(leaves)} of {n_leaves} leaves {leaves}")
    if not all(caught.values()):
        raise RuntimeError(f"weighted_merge barrier: {MERGE_BF16_TOL} passes a wrong merge "
                           f"({[m for m, leaves in caught.items() if not leaves]})")
    elt = g[next(iter(g))].element_size()
    nbytes = (R + 3) * n_params * elt + R * 4 * n_leaves
    flops = (2 * R + 3) * n_params
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    b = dict(max_abs_err=err, bound_ms_per_barrier=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations", path="cuda_core",
             launches_per_barrier=per_barrier, leaves=n_leaves, params=n_params,
             dtype=str(g[next(iter(g))].dtype).removeprefix("torch."))
    # the kernel's device time a barrier: the merge_kernel rows of one
    # profiler trace, taken only where that trace holds every launch (one a
    # leaf); else CUDA events around each call. Events also time all three
    # (a barrier's calls queue back to back, so the host's gaps are small)
    rows = device_ms_by_kernel(kernel, reps=10)
    merge_rows = [(ms, count) for name, ms, count in rows if "merge_kernel" in name]
    seen = sum(count for _, count in merge_rows)
    b["call_ms_per_barrier"] = cuda_ms(kernel, reps=10, warmup=1)
    if seen == n_leaves:
        b["ms_per_barrier"], b["timing"] = sum(ms for ms, _ in merge_rows), "profiler"
    else:
        b["ms_per_barrier"], b["timing"] = b["call_ms_per_barrier"], "events"
    b["plain_ms_per_barrier"] = cuda_ms(plain, reps=10, warmup=1)
    b["library_ms_per_barrier"] = cuda_ms(library, reps=10, warmup=1)
    b["share"] = b["bound_ms_per_barrier"] / b["ms_per_barrier"]
    print(f"weighted_merge barrier: the profiler saw {seen} of {n_leaves} merge launches a "
          f"call; the kernel's time from the {b['timing']}, plain and einsum from CUDA events")
    print(f"kernel weighted_merge[{cfg.name} barrier, bf16, R={R}, {n_leaves} leaves, "
          f"{n_params / 1e9:.3f} B params]: {per_barrier} launches a barrier; "
          + " ".join(f"{k} {v:.4g}" for k, v in b.items() if isinstance(v, float))
          + f" ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP)")
    if per_barrier != n_leaves:
        raise RuntimeError(f"weighted_merge: {per_barrier} launches for {n_leaves} leaves")

    # where a warm full-width mega-batch's time goes
    wall, busy, _ = profile_call(f"train {cfg.name} mega-batch",
                                 lambda: trainer.run_megabatch(state), top=15)
    print(f"profile train {cfg.name}: host share of the wall time {1 - busy / wall:.1%}")
    del trainer, state, reps, g, gp
    torch.cuda.empty_cache()
    b["launches"] = launches
    return b


# phase 10's settings: the elastic scenario of tests/torch_elastic_runs.py
# at full XML width. R grows 4 -> 6 before mega-batch 2 and shrinks to 3
# before 5; the faults fire on the population they name: a NaN in replica
# 2 before mega-batch 1, a crash of replica 1 and a stall of replica 0
# before 3, a preemption of replica 2 (one mega-batch of notice) before 4,
# the readmissions and the stall's end before 5, a join before 6.
ELASTIC_SCHEDULE = {0: 4, 2: 6, 5: 3}
ELASTIC_FAULTS = "1:nan:2,3:crash:1,3:stall:0,4:preempt:2:1,6:join"
ELASTIC_MB, ELASTIC_RESTORE_AT, ELASTIC_DENSE_MB = 8, 4, 4
# the restored run against the uninterrupted one: the same f32 ops from the
# same state but for index_add_ (the row-sparse SGD step's scatter of
# duplicate rows adds in the order of the card's atomics); the small-width
# run on the card against the CPU: f32 sums in other orders
ELASTIC_TOL = 1e-5
# the same runs' global models against how far training moved them
# (``moved_err``): from the restore point in (b), from the initial weights
# in (c). Each run also measures faulty readings that must exceed the
# limit: (a)'s model one mega-batch behind, and in (b) a restore that
# leaves the provider at the start of its stream. On an H100 the sound
# readings were 1.9e-7 to 5.1e-7, but 4.0e-4 in (c) when one ReLU
# pre-activation of the sparse run, within rounding of 0, took the other
# side (index_add_'s order): one hidden unit's b1 and w1 column move by one
# sample's update. The faulty readings were 0.35-0.41; the limit sits
# between, a decade and more from each.
ELASTIC_MOVED_TOL = 1e-2


def merges_needed(records, events, schedule, r_start) -> int:
    """Adaptive SGD's merges in a run, from its records and fleet log: one
    a barrier, one a membership change that moved R (a scheduled resize to
    another width, an eviction, a join or a readmission: each one resize's
    final merge), one a guard repair that kept a finite replica (its donor
    merge)."""
    n, width = 0, r_start
    for rec in records:
        mb = rec["megabatch"] - 1
        n += int(mb in schedule and schedule[mb] != width)
        n += sum(1 for e in events if e["mb"] == mb and e["action"] in ("evict", "join", "rejoin"))
        repaired = rec.get("guard_repaired")
        n += 1 + int(bool(repaired) and len(repaired) < rec["n_replicas"])
        width = rec["n_replicas"]
    return n


def elastic_phase(reset_counts, read_counts, full_model, full_provider, test_batches,
                  small_model, small_provider, small_test) -> dict:
    """Phase 10: elastic XML training at full width through
    ``ElasticTrainer.run`` with a resize schedule, a ``FleetController``
    and a ``CheckpointManager``. Returns the kernels' launches on its paths
    (the uninterrupted run and the dense one)."""
    import copy
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.fleet import FleetController, parse_fault_spec
    from repro_torch.core.trainer import ElasticTrainer

    B_MAX, R = 256, 4
    membership = []          # (what, R before, R after, seconds)

    def trainer(model, provider, where="cuda", sparse=True, b_max=B_MAX, mega_batch=20,
                lr=0.05):
        tr = ElasticTrainer(model(), provider(), ElasticConfig.from_bmax(
            b_max, n_replicas=R, mega_batch=mega_batch), base_lr=lr, seed=SEED, device=where,
            sparse_grads=sparse)
        if where == "cuda":
            timed(tr)
        return tr

    def timed(tr):
        """Time each resize, eviction and guard repair (an eviction's own
        resize is part of it)."""
        inside = []

        def wrap(what, fn):
            def run(*args, **kw):
                nested = bool(inside)
                inside.append(what)
                torch.cuda.synchronize()
                r0, t0 = tr.cfg.n_replicas, time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.synchronize()
                    inside.pop()
                    r1 = tr.cfg.n_replicas
                    if not nested and (what != "resize" or r1 != r0):  # not a no-op
                        membership.append((what, r0, r1, time.perf_counter() - t0))
            return run

        tr.resize = wrap("resize", tr.resize)
        tr.remove_replicas = wrap("evict", tr.remove_replicas)
        tr._repair_nonfinite = wrap("guard repair", tr._repair_nonfinite)

    def controller():
        return FleetController(injector=parse_fault_spec(ELASTIC_FAULTS), max_replicas=2 * R,
                               verbose=True)

    def check_counts(label, counts, want):
        print(f"elastic {label} launches: {counts} (expected {want})")
        if counts != want:
            raise RuntimeError(f"elastic {label}: launch counts {counts} != expected {want}")

    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        # ---- (a) the elastic run, a checkpoint every mega-batch ----
        mgr = store.CheckpointManager(tmp, every=1, retain=ELASTIC_MB - ELASTIC_RESTORE_AT + 1)
        fleet = controller()
        fleet_at_restore, peaks = [], []
        tr = trainer(full_model, full_provider)
        # the global model after each mega-batch the checks below read
        # (0: the initial weights)
        models = {0: tr.init_state().global_model}

        class Checkpoints:
            """The manager, plus the controller as it stood at the restore
            point (a checkpoint holds no fleet state, in either package),
            the peak device memory of each mega-batch and the global models
            ``models`` keeps."""

            def maybe_save(self, trainer, state):
                torch.cuda.synchronize()
                peaks.append((trainer.cfg.n_replicas, torch.cuda.max_memory_allocated()))
                torch.cuda.reset_peak_memory_stats()
                mgr.maybe_save(trainer, state)
                idx = state.megabatch_idx
                if idx == ELASTIC_RESTORE_AT:
                    fleet_at_restore.append(copy.deepcopy(fleet))
                if idx in (ELASTIC_DENSE_MB - 1, ELASTIC_DENSE_MB, ELASTIC_RESTORE_AT,
                           ELASTIC_MB - 1, ELASTIC_MB):
                    models[idx] = {k: v.clone() for k, v in state.global_model.items()}

            def wait(self):
                mgr.wait()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, mlog = tr.run(ELASTIC_MB, test_batches=test_batches, verbose=True,
                             resize_schedule=ELASTIC_SCHEDULE, fleet=fleet,
                             checkpoint=Checkpoints())
        torch.cuda.synchronize()
        launches["elastic"] = read_counts()
        prev = 0.0
        for rec in mlog.records:
            print(f"elastic mb={rec['megabatch']} R={rec['n_replicas']} u={rec['u']} "
                  f"b={rec['b']} n_rounds={rec['n_rounds']} loss={rec['train_loss']:.6f} "
                  f"test_loss={rec['test_loss']:.6f} guard={rec.get('guard_repaired', [])} "
                  f"seconds={rec['wall_clock'] - prev:.3f}")
            prev = rec["wall_clock"]
        for e in fleet.events:
            print(f"elastic fleet: {json.dumps(e)}")
        for what, r0, r1, sec in membership:
            print(f"elastic {what}: R {r0} -> {r1}, {sec * 1e3:.2f} ms wall")
        for t in mgr.timings:
            print(f"elastic checkpoint mb={t['megabatch']}: {t['bytes'] / 1e9:.3f} GB, "
                  f"snapshot {t['snapshot_s']:.3f} s (synchronous), write {t['write_s']:.3f} s "
                  f"(background)")
        peak6 = max(p for r, p in peaks if r == 6) / 1e9
        print(f"elastic peak device memory by mega-batch (R, GB): "
              f"{[(r, round(p / 1e9, 2)) for r, p in peaks]}; at R = 6: {peak6:.2f} GB")
        n_rounds = sum(r["n_rounds"] for r in mlog.records)
        n_leaves = len(state.global_model)
        want = {name: 0 for name in launches["elastic"]}
        want.update(spmm=n_rounds + len(mlog.records) * len(test_batches),
                    weighted_merge=n_leaves * merges_needed(
                        mlog.records, fleet.events, ELASTIC_SCHEDULE, R))
        check_counts("(a)", launches["elastic"], want)
        actions = {e["action"] for e in fleet.events}
        if not {"nan", "evict", "stall", "stall_recovered", "rejoin", "join"} <= actions:
            raise RuntimeError(f"elastic: the fleet log misses a fault kind: {actions}")
        if [r["n_replicas"] for r in mlog.records] != [4, 4, 6, 5, 4, 5, 6, 6]:
            raise RuntimeError("elastic: the population did not follow the schedule and faults")
        finite = [r["train_loss"] for r in mlog.records if "guard_repaired" not in r]
        if not (all(np.isfinite(finite)) and all(np.isfinite(r["test_loss"])
                                                 for r in mlog.records)):
            raise RuntimeError("elastic: a non-finite loss outside the poisoned mega-batch")
        if not all(torch.isfinite(v).all().item() for v in state.global_model.values()):
            raise RuntimeError("elastic: the global model is not finite")

        # ---- (b) a fresh trainer restores mega-batch 4's checkpoint ----
        del tr, state
        torch.cuda.empty_cache()
        restore_s = []

        def restored_run(stale_provider=False):
            """A fresh trainer and a copy of the controller as they stood at
            the restore point finish the run from its checkpoint;
            ``stale_provider`` leaves the provider at the start of its
            stream (a faulty restore, for the check's own reading)."""
            tr_b = trainer(full_model, full_provider)
            restore = tr_b.restore_checkpoint
            if stale_provider:
                tr_b.provider.load_state_dict = lambda sd: None

            def timed_restore(path):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base, t0 = torch.cuda.memory_allocated(), time.perf_counter()
                out = restore(path)
                torch.cuda.synchronize()
                restore_s.append((time.perf_counter() - t0,
                                  torch.cuda.max_memory_allocated() - base))
                return out

            tr_b.restore_checkpoint = timed_restore
            fleet_b = copy.deepcopy(fleet_at_restore[0])
            fleet_b.verbose = False
            t0 = time.perf_counter()
            state_b, mlog_b = tr_b.run(ELASTIC_MB, test_batches=test_batches,
                                       resize_schedule=ELASTIC_SCHEDULE, fleet=fleet_b,
                                       restore_from=mgr.step_path(ELASTIC_RESTORE_AT))
            torch.cuda.synchronize()
            return state_b.global_model, mlog_b, fleet_b.events, time.perf_counter() - t0

        model_b, mlog_b, events_b, wall_b = restored_run()
        tail = mlog.records[ELASTIC_RESTORE_AT:]
        if [r["megabatch"] for r in mlog_b.records] != [r["megabatch"] for r in tail]:
            raise RuntimeError("elastic (b): the restored run did not resume after "
                               f"mega-batch {ELASTIC_RESTORE_AT}")
        check_host_decisions("elastic (b) restored vs uninterrupted", mlog_b.records, tail)
        if events_b != fleet.events:
            raise RuntimeError("elastic (b): the fleet log differs from the uninterrupted run's")
        l_err = loss_err(mlog_b.records, tail)
        m_err = model_err(model_b, models[ELASTIC_MB])
        at, end = models[ELASTIC_RESTORE_AT], models[ELASTIC_MB]
        moved = moved_err(model_b, end, at)
        behind = moved_err(models[ELASTIC_MB - 1], end, at)
        del model_b
        model_stale = restored_run(stale_provider=True)[0]
        stale = moved_err(model_stale, end, at)
        del model_stale
        torch.cuda.empty_cache()
        print(f"elastic (b) restored after mega-batch {ELASTIC_RESTORE_AT} (restore "
              f"{restore_s[0][0]:.3f} s, device memory {restore_s[0][1] / 1e9:.3f} GB at its "
              f"peak, then {len(mlog_b.records)} mega-batches; "
              f"{wall_b:.3f} s in all): host decisions "
              f"and fleet log identical; loss rel err {l_err:.3g}, global model err "
              f"{m_err:.3g} (tol {ELASTIC_TOL}; not bitwise: index_add_ in the "
              f"row-sparse SGD step adds duplicate rows in the order of the card's atomics)")
        print(f"elastic (b) global model against its movement since mega-batch "
              f"{ELASTIC_RESTORE_AT}: restored {moved:.3g} (tol {ELASTIC_MOVED_TOL}); faulty "
              f"readings: one mega-batch behind {behind:.3g}, a stale-provider restore "
              f"{stale:.3g}")
        if max(l_err, m_err) > ELASTIC_TOL or moved > ELASTIC_MOVED_TOL:
            raise RuntimeError("elastic (b): the restored run left the uninterrupted trajectory")
        if min(behind, stale) <= ELASTIC_MOVED_TOL:
            raise RuntimeError("elastic (b): a faulty run passes the check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- (c) the dense-gradient path (spmm_grad_w), same schedule and faults ----
    tr_c = trainer(full_model, full_provider, sparse=False)
    fleet_c = controller()
    fleet_c.verbose = False
    reset_counts()
    state_c, mlog_c = tr_c.run(ELASTIC_DENSE_MB, resize_schedule=ELASTIC_SCHEDULE,
                               fleet=fleet_c)
    torch.cuda.synchronize()
    launches["dense"] = read_counts()
    dense_rounds = sum(r["n_rounds"] for r in mlog_c.records)
    want = {name: 0 for name in launches["dense"]}
    want.update(spmm=dense_rounds, spmm_grad_w=dense_rounds, sort_rows=dense_rounds,
                weighted_merge=len(state_c.global_model) * merges_needed(
                    mlog_c.records, fleet_c.events, ELASTIC_SCHEDULE, R))
    sparse_recs = mlog.records[:ELASTIC_DENSE_MB]
    check_host_decisions("elastic (c) dense vs sparse", mlog_c.records, sparse_recs)
    dense_err = loss_err(mlog_c.records, sparse_recs, keys=("train_loss",))
    init, want_c = models[0], models[ELASTIC_DENSE_MB]
    m_err = model_err(state_c.global_model, want_c)
    moved = moved_err(state_c.global_model, want_c, init)
    behind = moved_err(models[ELASTIC_DENSE_MB - 1], want_c, init)
    print(f"elastic (c) dense path, {ELASTIC_DENSE_MB} mega-batches ({dense_rounds} rounds): "
          f"host decisions identical to (a)'s, train loss rel err {dense_err:.3g} (tol 1e-4), "
          f"global model err {m_err:.3g}, against its movement from the initial weights "
          f"{moved:.3g} (tol {ELASTIC_MOVED_TOL}; faulty reading: the sparse run one "
          f"mega-batch behind {behind:.3g})")
    check_counts("(c)", launches["dense"], want)
    if (dense_err > 1e-4 or moved > ELASTIC_MOVED_TOL
            or fleet_c.events != [e for e in fleet.events if e["mb"] < ELASTIC_DENSE_MB]):
        raise RuntimeError("elastic (c): the dense path left the sparse one")
    if behind <= ELASTIC_MOVED_TOL:
        raise RuntimeError("elastic (c): a faulty run passes the check")
    del tr_c, state_c, models
    torch.cuda.empty_cache()

    # ---- (d) small width, the card against the CPU ----
    runs = []
    for where in ("cuda", "cpu"):
        tr_d = trainer(small_model, small_provider, where=where, b_max=32, mega_batch=10, lr=0.5)
        fleet_d = controller()
        fleet_d.verbose = False
        state_d, mlog_d = tr_d.run(ELASTIC_MB, test_batches=small_test,
                                   resize_schedule=ELASTIC_SCHEDULE, fleet=fleet_d)
        runs.append((state_d, mlog_d, fleet_d.events))
    (card_state, card_log, card_events), (cpu_state, cpu_log, cpu_events) = runs
    check_host_decisions("elastic (d) card vs CPU", card_log.records, cpu_log.records)
    l_err = loss_err(card_log.records, cpu_log.records)
    m_err = model_err(card_state.global_model, cpu_state.global_model)
    print(f"elastic (d) small width card vs cpu: host decisions and fleet log identical over "
          f"{len(card_log.records)} mega-batches (R {[r['n_replicas'] for r in card_log.records]}"
          f"); loss rel err {l_err:.3g}, global model err {m_err:.3g} "
          f"(tol {ELASTIC_TOL})")
    if card_events != cpu_events or max(l_err, m_err) > ELASTIC_TOL:
        raise RuntimeError("elastic (d): card and CPU runs disagree")
    return launches


# phase 11's settings: phase 5's model and data, Adaptive SGD, R = 4, 4
# mega-batches with evaluation after each, through ``ElasticTrainer.run``
# with the overlap pipeline off and then on, from the same weights and seed.
# The two runs differ on the card only in index_add_'s order (the row-sparse
# SGD step's scatter of duplicate rows), as phase 10 (b)'s restored run
# differs from the uninterrupted one, and are held to its limit.
OVERLAP_MB = 4
OVERLAP_TOL = 1e-5


def overlap_phase(reset_counts, read_counts, full_model, full_provider, test_batches,
                  card: str) -> dict:
    """Phase 11: the overlapped mega-batch pipeline against the sequential
    path at full XML width, on ``card`` (nvidia-smi's name and power
    limit). Returns each run's kernel launches."""
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer

    B_MAX, R = 256, 4
    runs = {}
    for overlap in (False, True):
        label = "on" if overlap else "off"
        tr = ElasticTrainer(full_model(), full_provider(), ElasticConfig.from_bmax(
            B_MAX, n_replicas=R, mega_batch=20), base_lr=0.05, seed=SEED, device="cuda",
            overlap=overlap)
        allocations = []     # staging-slot allocations after each mega-batch

        class Probe:
            """The run's checkpoint hook, called after each mega-batch."""

            def maybe_save(self, trainer, state):
                allocations.append(trainer._staging.allocations)

            def wait(self):
                pass

        # every dispatch-to-collect window runs under the sync debug mode
        # "error": a host sync inside it (a blocking copy, .item(), a
        # pageable upload) raises
        windows = []
        if overlap:
            dispatch, finish = tr._dispatch_rounds, tr._finish_metrics

            def guarded_dispatch(*args, **kw):
                torch.cuda.set_sync_debug_mode("error")
                return dispatch(*args, **kw)

            def guarded_finish(stats):
                torch.cuda.set_sync_debug_mode(0)
                windows.append(1)
                return finish(stats)

            tr._dispatch_rounds, tr._finish_metrics = guarded_dispatch, guarded_finish
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            state, mlog = tr.run(OVERLAP_MB, test_batches=test_batches, checkpoint=Probe())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = read_counts()
        model = {k: v.clone() for k, v in state.global_model.items()}
        peak = torch.cuda.max_memory_allocated()
        staging = list(tr.staging_log)
        walls = [b["wall_clock"] - a["wall_clock"]
                 for a, b in zip(mlog.records, mlog.records[1:])]
        n_rounds = sum(r["n_rounds"] for r in mlog.records)
        want = {name: 0 for name in launches}
        want.update(spmm=n_rounds + len(mlog.records) * len(test_batches),
                    weighted_merge=len(state.global_model) * len(mlog.records))
        print(f"overlap {label} launches: {launches} (expected {want})")
        if launches != want:
            raise RuntimeError(f"overlap {label}: launch counts {launches} != expected {want}")
        if overlap and len(windows) != OVERLAP_MB:
            raise RuntimeError(f"overlap: {len(windows)} guarded windows for {OVERLAP_MB} "
                               "mega-batches")

        # one warm mega-batch more under the profiler: with the pipeline on,
        # its plan was staged by the one before, and it stages the next
        state, _ = tr.run_megabatch(state, prefetch=overlap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, info = tr.run_megabatch(state, prefetch=overlap)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
        tr.invalidate_prefetch()

        for rec, wall in zip(mlog.records, [mlog.records[0]["wall_clock"]] + walls):
            print(f"overlap {label} mb={rec['megabatch']} u={rec['u']} "
                  f"n_rounds={rec['n_rounds']} loss={rec['train_loss']:.6f} "
                  f"test_loss={rec['test_loss']:.6f} acc={rec['accuracy']:.4f} "
                  f"seconds={wall:.4f}")
        for e in staging[:OVERLAP_MB]:
            print(f"overlap {label} staging mb={e['megabatch'] + 1}: plan "
                  f"{e['plan_s'] * 1e3:.2f} ms, pack {e['pack_s'] * 1e3:.2f} ms, upload "
                  f"{e['upload_s'] * 1e3:.2f} ms (host), {e['bytes'] / 1e6:.2f} MB")
        runs[label] = dict(records=mlog.records, model=model, launches=launches, walls=walls,
                           peak=peak, staging=staging[:OVERLAP_MB], allocations=allocations,
                           busy=busy, prof_wall=prof_wall, prof_rounds=info["n_rounds"])
        del tr, state
        torch.cuda.empty_cache()

    off, on = runs["off"], runs["on"]
    check_host_decisions("overlap on vs off", on["records"], off["records"])
    l_err = loss_err(on["records"], off["records"],
                     keys=("train_loss", "train_accuracy", "test_loss", "accuracy"))
    m_err = model_err(on["model"], off["model"])
    print(f"overlap on vs off: host decisions identical over {OVERLAP_MB} mega-batches; "
          f"loss and accuracy rel err {l_err:.3g}, global model err {m_err:.3g} "
          f"(tol {OVERLAP_TOL}; not bitwise: index_add_'s order)")
    if max(l_err, m_err) > OVERLAP_TOL:
        raise RuntimeError("overlap: the pipelined run left the sequential one")
    allocs = on["allocations"]
    print(f"overlap staging slots allocated after each mega-batch: {allocs}")
    if allocs[1] != allocs[-1] or off["allocations"][-1] != 0:
        raise RuntimeError(f"overlap: a staging slot was allocated after the second "
                           f"mega-batch ({allocs})")

    print(f"overlap measured on: {card}")

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if len(xs) % 2 else (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2

    for label, run in runs.items():
        warm = run["staging"][1:]
        print(f"overlap {label}: warm mega-batch {median(run['walls']):.4f} s wall (median "
              f"of mega-batches 2-{OVERLAP_MB}, evaluation included: {run['walls']}); "
              f"profiled mega-batch ({run['prof_rounds']} rounds) {run['prof_wall']:.4f} s, "
              f"device busy {run['busy']:.4f} s ({run['busy'] / run['prof_wall']:.1%}); "
              f"staging (host, median of mega-batches 2-{OVERLAP_MB}): plan "
              f"{median([e['plan_s'] for e in warm]) * 1e3:.2f} ms, pack "
              f"{median([e['pack_s'] for e in warm]) * 1e3:.2f} ms, upload "
              f"{median([e['upload_s'] for e in warm]) * 1e3:.2f} ms, "
              f"{median([e['bytes'] for e in warm]) / 1e6:.2f} MB a mega-batch; "
              f"peak device memory {run['peak'] / 1e9:.2f} GB")
    return {label: run["launches"] for label, run in runs.items()}


# phase 12's settings. (a) phase 4's small width (512 features, 128
# classes, hidden 32, b_max 32, mega_batch 10), Adaptive SGD, R = 4, overlap
# on, 6 mega-batches through a resize 4 -> 6 -> 3, held to phase 4's 1e-4;
# (b) and (c) phase 5's width and data, R = 4, b_max 256, mega_batch 20, 8
# mega-batches with evaluation after each; (d) phase 4's width, 2
# mega-batches, its 1e-4.
MEASURED_SCHEDULE = {0: 4, 2: 6, 4: 3}
MEASURED_SMALL_MB = 6
MEASURED_MB = 8
MEASURED_TOL = 1e-4
ALLOC_SLACK = 1 << 20       # allocator rounding, bytes


class RecordingTimer:
    """``time.perf_counter``, keeping every reading."""

    def __init__(self):
        self.readings = []

    def __call__(self) -> float:
        t = time.perf_counter()
        self.readings.append(t)
        return t


class ScriptedTimer:
    """Hands out recorded readings in order; raises past the last."""

    def __init__(self, readings):
        self.readings, self.calls = list(readings), 0

    def __call__(self) -> float:
        if self.calls >= len(self.readings):
            raise RuntimeError(f"replay read the timer {self.calls + 1} times; "
                               f"the card's run read it {len(self.readings)} times")
        self.calls += 1
        return self.readings[self.calls - 1]


class SpeedProbe:
    """``run``'s checkpoint hook: the speed model's factors and
    observation counts after each mega-batch."""

    def __init__(self):
        self.rows = []

    def maybe_save(self, trainer, state):
        self.rows.append((np.array(trainer.speed.factors, np.float64),
                          np.array(trainer.speed.n_obs, np.int64)))

    def wait(self):
        pass


def measured_phase(reset_counts, read_counts, full_model, full_provider, test_batches,
                   small_model, small_provider, small_test, dataset, card: str) -> dict:
    """Phase 12: the measured speed model (the paper's §3.1 loop) on the
    card, ``keep_global_copies=False``, Nesterov and clipping, and libSVM
    I/O at full width. Returns each run's kernel launches by path."""
    import tempfile

    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.heterogeneity import MeasuredSpeedModel
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.libsvm import read_libsvm, write_libsvm
    from repro_torch.kernels.weighted_merge.ops import merge_cuda
    from repro_torch.optim.sgd import SGDConfig

    R = 4
    launches = {}

    def small_trainer(where, timer=None, sgd=None, sparse=True):
        speed = MeasuredSpeedModel(R, timer=timer) if timer is not None else None
        return ElasticTrainer(small_model(), small_provider(), ElasticConfig.from_bmax(
            32, n_replicas=R, mega_batch=10), sgd=sgd or SGDConfig(), base_lr=0.5, seed=SEED,
            device=where, speed=speed, sparse_grads=sparse)

    def expect(label, counts, want):
        print(f"measured {label} launches: {counts} (expected {want})")
        if any(counts[k] != v for k, v in want.items()):
            raise RuntimeError(f"measured {label}: launch counts {counts} != expected {want}")

    # ---- (a) the card's loop against a CPU replay of its clock ----
    timer = RecordingTimer()
    tr = small_trainer("cuda", timer)
    probe = SpeedProbe()
    reset_counts()
    state, mlog = tr.run(MEASURED_SMALL_MB, test_batches=small_test,
                         resize_schedule=MEASURED_SCHEDULE, checkpoint=probe)
    torch.cuda.synchronize()
    launches["replay"] = read_counts()
    card_run = (mlog.records, {k: v.cpu() for k, v in state.global_model.items()}, probe.rows)
    n_rounds = sum(r["n_rounds"] for r in mlog.records)
    resizes = sum(1 for a, b in zip(mlog.records, mlog.records[1:])
                  if a["n_replicas"] != b["n_replicas"])
    expect("(a)", launches["replay"], {
        "spmm": n_rounds + len(mlog.records) * len(small_test),
        "weighted_merge": len(state.global_model) * (len(mlog.records) + resizes)})
    replay = ScriptedTimer(timer.readings)
    tr_cpu = small_trainer("cpu", replay)
    probe_cpu = SpeedProbe()
    state_cpu, mlog_cpu = tr_cpu.run(MEASURED_SMALL_MB, test_batches=small_test,
                                     resize_schedule=MEASURED_SCHEDULE, checkpoint=probe_cpu)
    if replay.calls != len(timer.readings) or len(timer.readings) != 2 * MEASURED_SMALL_MB:
        raise RuntimeError(f"measured (a): the card read the timer {len(timer.readings)} "
                           f"times, the replay {replay.calls}")
    check_host_decisions("measured (a) card vs CPU replay", card_run[0], mlog_cpu.records)
    for mb, ((f, n), (f_cpu, n_cpu)) in enumerate(zip(card_run[2], probe_cpu.rows), 1):
        if not (np.array_equal(f, f_cpu) and np.array_equal(n, n_cpu)):
            raise RuntimeError(f"measured (a): factors differ at mega-batch {mb}: "
                               f"{f} vs {f_cpu}")
    l_err = loss_err(card_run[0], mlog_cpu.records)
    m_err = model_err(card_run[1], state_cpu.global_model)
    for rec, (f, n) in zip(card_run[0], card_run[2]):
        print(f"measured (a) mb={rec['megabatch']} R={rec['n_replicas']} u={rec['u']} "
              f"b={rec['b']} factors={np.round(f, 4).tolist()} n_obs={n.tolist()}")
    windows = [b - a for a, b in zip(timer.readings[::2], timer.readings[1::2])]
    print(f"measured (a) small width, card vs CPU replay of its {len(timer.readings)} "
          f"timer readings (windows {np.round(windows, 4).tolist()} s): host decisions and "
          f"factors identical over {len(card_run[0])} mega-batches (R "
          f"{[r['n_replicas'] for r in card_run[0]]}); loss rel err {l_err:.3g}, global model "
          f"err {m_err:.3g} (tol {MEASURED_TOL})")
    if max(l_err, m_err) > MEASURED_TOL:
        raise RuntimeError("measured (a): the card and its CPU replay disagree")
    del tr, tr_cpu, state, state_cpu
    torch.cuda.empty_cache()

    # ---- (b) full width, the pipeline on and off; (c) without the copies ----
    def full_run(label, overlap, keep):
        timer = RecordingTimer()
        tr = ElasticTrainer(full_model(), full_provider(), ElasticConfig.from_bmax(
            256, n_replicas=R, mega_batch=20), base_lr=0.05, seed=SEED, device="cuda",
            speed=MeasuredSpeedModel(R, timer=timer), overlap=overlap,
            keep_global_copies=keep)
        rounds, evals, init = [], [], {}
        dispatch, evaluate_async, init_state = (tr._dispatch_rounds, tr.evaluate_async,
                                                tr.init_state)

        def timed_dispatch(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = dispatch(*args, **kw)
            end.record()
            rounds.append((start, end))
            return out

        def timed_evaluate(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t_issue = time.perf_counter()
            start.record()
            out = evaluate_async(*args, **kw)
            end.record()
            evals.append((t_issue, start, end))
            return out

        def measured_init():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            state = init_state()
            torch.cuda.synchronize()
            init["allocated"] = torch.cuda.memory_allocated() - before
            init["model_bytes"] = sum(v.numel() * v.element_size()
                                      for v in state.replicas.values()) // R
            return state

        tr._dispatch_rounds, tr.evaluate_async, tr.init_state = (
            timed_dispatch, timed_evaluate, measured_init)
        probe = SpeedProbe()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        merge_cuda.no_momentum_launches = 0
        state, mlog = tr.run(MEASURED_MB, test_batches=test_batches, checkpoint=probe)
        torch.cuda.synchronize()
        counts = dict(read_counts(), weighted_merge_no_momentum=merge_cuda.no_momentum_launches)
        peak = torch.cuda.max_memory_allocated()
        recs = mlog.records
        n_leaves = len(state.global_model)
        expect(label, counts, {
            "spmm": sum(r["n_rounds"] for r in recs) + len(recs) * len(test_batches),
            "weighted_merge": n_leaves * len(recs),
            "weighted_merge_no_momentum": 0 if keep else 2 * n_leaves,
            "spmm_grad_w": 0})
        win = [b - a for a, b in zip(timer.readings[::2], timer.readings[1::2])]
        dev = [s.elapsed_time(e) / 1e3 for s, e in rounds]
        ev = [(t, s.elapsed_time(e) / 1e3) for t, s, e in evals]
        begins = timer.readings[::2]
        print(f"measured {label} on: {card}")
        for i, rec in enumerate(recs):
            # the evaluation issued after mega-batch i runs on the device at
            # the start of window i + 1 (the stream is serial, and the host
            # synced just before issuing it): its device time past the
            # window's opening, from the host clock
            in_window = 0.0
            if 0 < i <= len(ev):
                t_issue, d = ev[i - 1]
                in_window = max(0.0, min(d, t_issue + d - begins[i]))
            f, n = probe.rows[i]
            print(f"measured {label} mb={rec['megabatch']} window={win[i]:.4f} s "
                  f"rounds_device={dev[i]:.4f} s eval_device="
                  f"{ev[i - 1][1] if 0 < i <= len(ev) else 0.0:.4f} s "
                  f"eval_in_window~{in_window:.4f} s n_rounds={rec['n_rounds']} "
                  f"u={rec['u']} b={rec['b']} factors={np.round(f, 5).tolist()} "
                  f"n_obs={n.tolist()} loss={rec['train_loss']:.6f}")
            if not np.all(np.isfinite(f)):
                raise RuntimeError(f"measured {label}: a non-finite factor {f}")
            if win[i] < dev[i]:
                raise RuntimeError(f"measured {label}: window {win[i]} s shorter than the "
                                   f"rounds' device time {dev[i]} s")
        losses = [r[k] for r in recs for k in ("train_loss", "test_loss")]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"measured {label}: non-finite loss {losses}")
        print(f"measured {label}: windows {np.round(win, 4).tolist()} s, rounds' device "
              f"{np.round(dev, 4).tolist()} s, evaluations' device "
              f"{np.round([d for _, d in ev], 4).tolist()} s; init allocated "
              f"{init['allocated'] / 1e9:.4f} GB, peak {peak / 1e9:.2f} GB")
        out = dict(counts=counts, init=init, peak=peak, windows=win, rounds=dev)
        del tr, state
        torch.cuda.empty_cache()
        return out

    full = {"(b) overlap": full_run("(b) overlap", True, True),
            "(b) sequential": full_run("(b) sequential", False, True),
            "(c) lean": full_run("(c) lean", True, False)}
    kept, lean = full["(b) overlap"], full["(c) lean"]
    saved = kept["init"]["allocated"] - lean["init"]["allocated"]
    model_bytes = kept["init"]["model_bytes"]
    # the global and prev-global copies are one set of tensors (the initial
    # weights), in the reference as here: dropping them frees one model
    print(f"measured (c): init_state allocates {kept['init']['allocated']} B with the "
          f"copies, {lean['init']['allocated']} B without: {saved} B less, one model is "
          f"{model_bytes} B (global and prev-global share it); peak "
          f"{lean['peak'] / 1e9:.3f} GB against (b)'s {kept['peak'] / 1e9:.3f} GB")
    if abs(saved - model_bytes) > ALLOC_SLACK:
        raise RuntimeError(f"measured (c): {saved} B freed, not the model's {model_bytes} B")
    for label, run in full.items():
        launches[label] = run["counts"]

    # ---- (d) Nesterov and clipping, the card against the CPU ----
    for name, sgd in (("nesterov", SGDConfig(momentum=0.9, nesterov=True)),
                      ("grad_clip", SGDConfig(grad_clip=1.0))):
        for sparse in (True, False):
            label = f"(d) {name} {'sparse' if sparse else 'dense'}"
            runs = []
            for where in ("cuda", "cpu"):
                tr = small_trainer(where, sgd=sgd, sparse=sparse)
                if where == "cuda":
                    reset_counts()
                state, mlog = tr.run(2, test_batches=small_test)
                if where == "cuda":
                    torch.cuda.synchronize()
                    launches[label] = read_counts()
                runs.append((mlog.records, {k: v.cpu() for k, v in state.global_model.items()}))
            (recs, model), (cpu_recs, cpu_model) = runs
            n_rounds = sum(r["n_rounds"] for r in recs)
            expect(label, launches[label], {
                "spmm": n_rounds + len(recs) * len(small_test),
                "spmm_grad_w": 0 if sparse else n_rounds,
                "weighted_merge": len(model) * len(recs)})
            check_host_decisions(f"measured {label} card vs CPU", recs, cpu_recs)
            l_err, m_err = loss_err(recs, cpu_recs), model_err(model, cpu_model)
            print(f"measured {label} card vs cpu: host decisions identical over {len(recs)} "
                  f"mega-batches; loss rel err {l_err:.3g}, global model err {m_err:.3g} "
                  f"(tol {MEASURED_TOL})")
            if max(l_err, m_err) > MEASURED_TOL:
                raise RuntimeError(f"measured {label}: card and CPU runs disagree")

    # ---- (e) libSVM at full width ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "amazon_like.svm")
        t0 = time.perf_counter()
        write_libsvm(dataset, path)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = read_libsvm(path)
        t_read = time.perf_counter() - t0
    for k in ("indptr", "indices", "label_ptr", "labels"):
        if not np.array_equal(getattr(back, k), getattr(dataset, k)):
            raise RuntimeError(f"libsvm: {k} did not survive the round trip")
    # values pass through the format's 6 significant digits, exactly
    text_values = np.array([float(f"{float(v):.6g}") for v in dataset.values], np.float32)
    if ((back.n_features, back.n_classes) != (dataset.n_features, dataset.n_classes)
            or not np.array_equal(back.values, text_values)):
        raise RuntimeError("libsvm: values or sizes did not survive the round trip")
    rel = float(np.max(np.abs(back.values - dataset.values) / np.abs(dataset.values)))
    print(f"libsvm: {dataset.n_samples} samples, {len(dataset.indices)} features, "
          f"{len(dataset.labels)} labels; write {t_write:.3f} s, read {t_read:.3f} s, "
          f"file {size} bytes ({size / t_write / 1e6:.1f} MB/s written, "
          f"{size / t_read / 1e6:.1f} MB/s read); arrays equal, values as the "
          f"text's 6 digits (max rel change {rel:.3g})")
    return launches


# phase 13's settings: phase 5's widths and data, Adaptive SGD, R = 4, b_max
# 256, mega_batch 20, the overlap pipeline on. (a) a one-shard mesh on the
# card against vmap, 3 mega-batches; (b) four shards on the one card
# (``("cuda:0",) * 4``: four worker threads, four streams) against vmap, 4
# mega-batches; (c) the same mesh under ``MeasuredSpeedModel``, 6
# mega-batches, then at phase 4's width on the card and replayed on four CPU
# shards from the card's shard windows and clock readings; (d) the resize
# schedule 4 -> 2 -> 4 and a crash of replica 1, a checkpoint after
# mega-batch 3 written sharded and restored under vmap; (e) dense gradients
# at phase 4's width, card against CPU, 2 mega-batches.
CARD4 = ("cuda:0",) * 4
SHARDED_ONE_MB, SHARDED_MB, SHARDED_MEASURED_MB = 3, 4, 6   # (b) one past (a)
SHARDED_SCHEDULE = {0: 4, 1: 2, 3: 4}
SHARDED_FAULTS = "4:crash:1"
SHARDED_ELASTIC_MB, SHARDED_RESTORE_AT = 6, 3
# (a): the same ops as vmap but for the merge's momentum term (added to the
# no-momentum kernel's sum in torch, where vmap fuses it) and index_add_'s
# order (the card's atomics)
SHARDED_ONE_TOL = 1e-6
# (b), (d): the losses against vmap's. Four shards run each replica's rounds
# as R = 1 programs, so the GEMMs (cuBLAS picks its kernels by shape) and the
# gradient sums round otherwise than vmap's R = 4 ones, and the merge's
# partials add in shard order. On an H100 the losses read 7.1e-8, but b1,
# whose sums nearly cancel, read 1.1e-4 of its largest value (2.7e-8
# absolute) after one mega-batch, and from the second one hidden unit's
# ReLU took the other side for a sample: that unit's w1 column moved by up
# to 2.2e-5 (1.4e-3 of the leaf's largest weight), past any per-element
# limit a sound run keeps (the tests' 1e-5, the reference's multi-shard
# 2e-3 / 1e-5). So the model is held as phase 10 holds a restored run, by
# its distance over how far training moved it (``moved_err``), within
# ``ELASTIC_MOVED_TOL``; vmap's own model one mega-batch behind must fail
# that limit.
SHARDED_TOL = 1e-5


def device_busy_s(prof) -> tuple[float, float]:
    """(union, sum) seconds of the device ops in a profiler trace: with
    several streams, kernels overlap, so the busy time is the union of
    their intervals (the sum where the trace gives no intervals)."""
    from torch.autograd import DeviceType

    total = sum(device_us(e) for e in prof.key_averages()) / 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return total, total
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e6, total


def sharded_phase(reset_counts, read_counts, full_model, full_provider, test_batches,
                  small_model, small_provider, small_test, card: str) -> dict:
    """Phase 13: the sharded placement on the card (module doc). Returns
    each run's kernel launches by path, weighted_merge's no-momentum
    launches beside."""
    import collections
    import tempfile
    import threading

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.fleet import FleetController, parse_fault_spec
    from repro_torch.core.heterogeneity import MeasuredSpeedModel
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.kernels import _build
    from repro_torch.kernels.weighted_merge.ops import merge_cuda

    R = 4
    launches = {}

    def trainer(model, provider, mesh=None, where="cuda", b_max=256, mega_batch=20, lr=0.05,
                **kw):
        cfg = ElasticConfig.from_bmax(b_max, n_replicas=R, mega_batch=mega_batch,
                                      placement="vmap" if mesh is None else "sharded")
        return ElasticTrainer(model(), provider(), cfg, base_lr=lr, seed=SEED,
                              device=where if mesh is None else None, mesh=mesh, **kw)

    # launches by thread (each shard's worker, and the main thread's
    # evaluation), counted where every wrapper counts its own
    by_thread = collections.Counter()
    lock = threading.Lock()
    count_launch = _build.count_launch

    def per_thread(wrapper, **counters):
        count_launch(wrapper, **counters)
        with lock:
            by_thread[(wrapper.__name__, threading.current_thread().name)] += 1

    _build.count_launch = per_thread

    def counts():
        torch.cuda.synchronize()
        return dict(read_counts(), weighted_merge_no_momentum=merge_cuda.no_momentum_launches)

    def reset():
        reset_counts()
        merge_cuda.no_momentum_launches = 0
        by_thread.clear()

    def model_of(state):
        return {k: v.detach().cpu().clone() for k, v in state.global_model.items()}

    def timed_run(label, tr, n_mb, profile_one=False, **kw):
        """``run`` with evaluation; the peak memory, warm mega-batch walls
        and, optionally, one more warm mega-batch under the profiler."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset()
        state, mlog = tr.run(n_mb, test_batches=test_batches, **kw)
        out = dict(records=mlog.records, launches=counts(), by_thread=dict(by_thread),
                   peak=torch.cuda.max_memory_allocated(), model=model_of(state),
                   walls=[b["wall_clock"] - a["wall_clock"]
                          for a, b in zip(mlog.records, mlog.records[1:])])
        if profile_one:
            state, _ = tr.run_megabatch(state, prefetch=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, info = tr.run_megabatch(state, prefetch=True)
                torch.cuda.synchronize()
                out["prof_wall"] = time.perf_counter() - t0
            out["busy"], out["busy_sum"] = device_busy_s(prof)
            out["prof_rounds"] = info["n_rounds"]
            tr.invalidate_prefetch()
        for rec in mlog.records:
            print(f"sharded {label} mb={rec['megabatch']} R={rec['n_replicas']} u={rec['u']} "
                  f"b={rec['b']} loss={rec['train_loss']:.6f} test_loss={rec['test_loss']:.6f}")
        tr.close()
        return out

    def expect(label, got, want):
        print(f"sharded {label} launches: {got} (expected {want})")
        if any(got[k] != v for k, v in want.items()):
            raise RuntimeError(f"sharded {label}: launch counts {got} != expected {want}")

    leaves = 4   # the XML model's w1, b1, w2, b2
    n_eval = len(test_batches)

    # ---- (a) a one-shard mesh against vmap ----
    vmap = timed_run("(a) vmap", trainer(full_model, full_provider), SHARDED_ONE_MB)
    one = timed_run("(a) one shard", trainer(full_model, full_provider, mesh=CARD4[:1]),
                    SHARDED_ONE_MB)
    check_host_decisions("sharded (a) one shard vs vmap", one["records"], vmap["records"])
    l_err, m_err = loss_err(one["records"], vmap["records"]), model_err(one["model"],
                                                                      vmap["model"])
    n_rounds = sum(r["n_rounds"] for r in one["records"])
    launches["(a)"] = one["launches"]
    expect("(a)", one["launches"], {
        "spmm": n_rounds + SHARDED_ONE_MB * n_eval,
        "weighted_merge": leaves * SHARDED_ONE_MB,
        "weighted_merge_no_momentum": leaves * SHARDED_ONE_MB})
    print(f"sharded (a) one shard vs vmap: host decisions identical over {SHARDED_ONE_MB} "
          f"mega-batches; largest loss rel err {l_err:.3g}, global model err {m_err:.3g} "
          f"(tol {SHARDED_ONE_TOL})")
    if max(l_err, m_err) > SHARDED_ONE_TOL:
        raise RuntimeError("sharded (a): the one-shard run left the vmap one")

    # ---- (b) four shards on the card against vmap ----
    runs = {}
    for label, mesh in (("vmap", None), ("four shards", CARD4)):
        runs[label] = timed_run(f"(b) {label}", trainer(full_model, full_provider, mesh=mesh),
                                SHARDED_MB, profile_one=True)
    v, s4 = runs["vmap"], runs["four shards"]
    check_host_decisions("sharded (b) four shards vs vmap", s4["records"], v["records"])
    l_err, m_err = loss_err(s4["records"], v["records"]), model_err(s4["model"], v["model"])
    init = {k: t.cpu() for k, t in full_model().init(torch.Generator()).items()}
    moved = moved_err(s4["model"], v["model"], init)
    # (a)'s vmap run: the same trajectory, one mega-batch shorter
    behind = moved_err(vmap["model"], v["model"], init)
    leaf_err = {k: float((s4["model"][k] - v["model"][k]).abs().max()) for k in v["model"]}
    n_rounds = sum(r["n_rounds"] for r in s4["records"])
    launches["(b)"] = s4["launches"]
    expect("(b)", s4["launches"], {
        "spmm": 4 * n_rounds + SHARDED_MB * n_eval,
        "weighted_merge": 4 * leaves * SHARDED_MB,
        "weighted_merge_no_momentum": 4 * leaves * SHARDED_MB, "spmm_grad_w": 0})
    per_shard = {f"shard-{s}-of-4": (s4["by_thread"].get(("spmm_cuda", f"shard-{s}-of-4"), 0),
                                     s4["by_thread"].get(("merge_cuda", f"shard-{s}-of-4"), 0))
                 for s in range(4)}
    print(f"sharded (b) launches by shard (spmm, weighted_merge): {per_shard}; main thread "
          f"(evaluation) spmm {s4['by_thread'].get(('spmm_cuda', 'MainThread'), 0)}")
    if any(p != (n_rounds, leaves * SHARDED_MB) for p in per_shard.values()):
        raise RuntimeError(f"sharded (b): a shard missed its launches: {per_shard}")
    print(f"sharded (b) four shards vs vmap: host decisions identical over {SHARDED_MB} "
          f"mega-batches; largest loss rel err {l_err:.3g} (tol {SHARDED_TOL}); global "
          f"model {moved:.3g} of its movement from the initial weights (tol "
          f"{ELASTIC_MOVED_TOL}; vmap's own model one mega-batch behind reads {behind:.3g}), "
          f"max err {m_err:.3g}, max abs err by leaf {leaf_err}")
    if l_err > SHARDED_TOL or moved > ELASTIC_MOVED_TOL or behind <= ELASTIC_MOVED_TOL:
        raise RuntimeError("sharded (b): the four-shard run left the vmap one")
    print(f"sharded measured on: {card}")
    for label, run in runs.items():
        walls = run["walls"]
        print(f"sharded (b) {label}: warm mega-batch {sorted(walls)[len(walls) // 2]:.4f} s "
              f"wall (median of mega-batches 2-{SHARDED_MB}, evaluation included: "
              f"{np.round(walls, 4).tolist()}); profiled mega-batch ({run['prof_rounds']} "
              f"rounds) {run['prof_wall']:.4f} s, device busy {run['busy']:.4f} s "
              f"({run['busy'] / run['prof_wall']:.1%}; the ops' device time summed "
              f"{run['busy_sum']:.4f} s); peak device memory {run['peak'] / 1e9:.2f} GB")

    # ---- (c) the measured speed model: one window a shard ----
    tr = trainer(full_model, full_provider, mesh=CARD4, speed=MeasuredSpeedModel(R))
    windows, calls, rows = [], [], []
    take = tr._shard_timer.take
    tr._shard_timer.take = lambda: windows.append(take()) or windows[-1]
    for name in ("observe_shards", "observe_plan"):
        fn = getattr(tr.speed, name)
        setattr(tr.speed, name, lambda *a, _fn=fn, _name=name, **kw: (calls.append(_name),
                                                                      _fn(*a, **kw))[1])

    class Probe:
        def maybe_save(self, trainer, state):
            rows.append((np.array(trainer.speed.factors), np.array(trainer.speed.n_obs)))

        def wait(self):
            pass

    measured = timed_run("(c) measured", tr, SHARDED_MEASURED_MB, checkpoint=Probe())
    launches["(c) measured"] = measured["launches"]
    for rec, w, (f, n) in zip(measured["records"], windows, rows):
        print(f"sharded (c) mb={rec['megabatch']} shard windows (CUDA events) "
              f"{np.round(w, 4).tolist() if w is not None else None} s, factors "
              f"{np.round(f, 4).tolist()}, n_obs {n.tolist()}, u={rec['u']} b={rec['b']}")
    counted = SHARDED_MEASURED_MB - tr.speed.warmup_windows
    if (calls != ["observe_shards"] * SHARDED_MEASURED_MB
            or any(w is None or len(w) != 4 or not (w > 0).all() for w in windows)
            or tr.speed.n_windows != SHARDED_MEASURED_MB
            or not (tr.speed.n_obs == counted).all()):
        raise RuntimeError(f"sharded (c): observe_shards calls {calls}, windows {windows}, "
                           f"n_obs {tr.speed.n_obs}: not one window a shard per mega-batch")
    print(f"sharded (c): observe_shards once a mega-batch ({SHARDED_MEASURED_MB}), the first "
          f"window discarded (warmup), {counted} counted windows for every replica")
    n_rounds = sum(r["n_rounds"] for r in measured["records"])
    expect("(c) measured", measured["launches"], {
        "spmm": 4 * n_rounds + SHARDED_MEASURED_MB * n_eval,
        "weighted_merge": 4 * leaves * SHARDED_MEASURED_MB})

    # phase 4's width: the card's windows and clock readings replayed on
    # four CPU shards
    timer = RecordingTimer()
    tr = ElasticTrainer(small_model(), small_provider(), ElasticConfig.from_bmax(
        32, n_replicas=R, mega_batch=10, placement="sharded"), base_lr=0.5, seed=SEED,
        mesh=CARD4, speed=MeasuredSpeedModel(R, timer=timer))
    card_windows = []
    take = tr._shard_timer.take
    tr._shard_timer.take = lambda: card_windows.append(take()) or card_windows[-1]
    probe = SpeedProbe()
    reset()
    state, mlog = tr.run(SHARDED_MEASURED_MB, test_batches=small_test, checkpoint=probe)
    launches["(c) replay"] = counts()
    card_run = (mlog.records, model_of(state), probe.rows)
    tr.close()
    replay = ScriptedTimer(timer.readings)
    tr_cpu = ElasticTrainer(small_model(), small_provider(), ElasticConfig.from_bmax(
        32, n_replicas=R, mega_batch=10, placement="sharded"), base_lr=0.5, seed=SEED,
        mesh=("cpu",) * 4, speed=MeasuredSpeedModel(R, timer=replay))
    scripted = iter(card_windows)
    tr_cpu._shard_timer.take = lambda: next(scripted)
    probe_cpu = SpeedProbe()
    state_cpu, mlog_cpu = tr_cpu.run(SHARDED_MEASURED_MB, test_batches=small_test,
                                     checkpoint=probe_cpu)
    tr_cpu.close()
    check_host_decisions("sharded (c) card vs CPU replay", card_run[0], mlog_cpu.records)
    for mb, ((f, n), (f_cpu, n_cpu)) in enumerate(zip(card_run[2], probe_cpu.rows), 1):
        if not (np.array_equal(f, f_cpu) and np.array_equal(n, n_cpu)):
            raise RuntimeError(f"sharded (c): factors differ at mega-batch {mb}: {f} vs {f_cpu}")
    l_err = loss_err(card_run[0], mlog_cpu.records)
    m_err = model_err(card_run[1], state_cpu.global_model)
    for rec, w, (f, n) in zip(card_run[0], card_windows, card_run[2]):
        print(f"sharded (c) small width mb={rec['megabatch']} windows "
              f"{np.round(w, 5).tolist() if w is not None else None} s factors "
              f"{np.round(f, 4).tolist()} u={rec['u']} b={rec['b']}")
    print(f"sharded (c) small width, card vs four CPU shards replaying its shard windows and "
          f"{len(timer.readings)} clock readings: host decisions and factors identical over "
          f"{len(card_run[0])} mega-batches; loss rel err {l_err:.3g}, global model err "
          f"{m_err:.3g} (tol {MEASURED_TOL})")
    if max(l_err, m_err) > MEASURED_TOL or replay.calls != len(timer.readings):
        raise RuntimeError("sharded (c): the card and its CPU replay disagree")

    # ---- (d) resizes, a crash, a checkpoint restored under vmap ----
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer(full_model, full_provider, mesh=CARD4)
        widths, merges = [], []
        step, merge = tr.run_megabatch, tr._merge

        def run_megabatch(state, prefetch=None):
            widths.append(len(state.replicas.blocks))
            return step(state, prefetch)

        def counted_merge(*args, **kw):
            merges.append(len(tr.mesh))
            return merge(*args, **kw)

        tr.run_megabatch, tr._merge = run_megabatch, counted_merge
        ctl = FleetController(injector=parse_fault_spec(SHARDED_FAULTS), max_replicas=2 * R)
        mgr = store.CheckpointManager(tmp, every=SHARDED_RESTORE_AT, retain=2)
        elastic = timed_run("(d) sharded", tr, SHARDED_ELASTIC_MB,
                            resize_schedule=SHARDED_SCHEDULE, fleet=ctl, checkpoint=mgr)
        launches["(d)"] = elastic["launches"]
        n_rounds = sum(r["n_rounds"] * w for r, w in zip(elastic["records"], widths))
        expect("(d)", elastic["launches"], {
            "spmm": n_rounds + SHARDED_ELASTIC_MB * n_eval,
            "weighted_merge": leaves * sum(merges),
            "weighted_merge_no_momentum": leaves * sum(merges)})
        print(f"sharded (d) shards a mega-batch {widths} (R "
              f"{[r['n_replicas'] for r in elastic['records']]}), merges by shard count "
              f"{merges}; fleet log {ctl.events}")
        tr_v = trainer(full_model, full_provider)
        base = {}
        restore = tr_v.restore_checkpoint

        def captured(path):
            state = restore(path)
            base.update(model_of(state))
            return state

        tr_v.restore_checkpoint = captured
        ctl_v = FleetController(injector=parse_fault_spec(SHARDED_FAULTS), max_replicas=2 * R)
        restored = timed_run("(d) restored under vmap", tr_v, SHARDED_ELASTIC_MB,
                             resize_schedule=SHARDED_SCHEDULE, fleet=ctl_v,
                             restore_from=mgr.step_path(SHARDED_RESTORE_AT))
    check_host_decisions("sharded (d) restored under vmap", restored["records"],
                         elastic["records"][SHARDED_RESTORE_AT:])
    if ctl_v.events != [e for e in ctl.events if e["mb"] >= SHARDED_RESTORE_AT]:
        raise RuntimeError(f"sharded (d): fleet logs differ: {ctl_v.events} vs {ctl.events}")
    l_err = loss_err(restored["records"], elastic["records"][SHARDED_RESTORE_AT:])
    moved = moved_err(restored["model"], elastic["model"], base)
    print(f"sharded (d) restored under vmap after mega-batch {SHARDED_RESTORE_AT}: host "
          f"decisions and fleet log identical; loss rel err {l_err:.3g} (tol {SHARDED_TOL}), "
          f"global model {moved:.3g} of its movement since the restore (tol "
          f"{ELASTIC_MOVED_TOL}), max err {model_err(restored['model'], elastic['model']):.3g}")
    if l_err > SHARDED_TOL or moved > ELASTIC_MOVED_TOL:
        raise RuntimeError("sharded (d): the restored vmap run left the sharded one")

    # ---- (e) dense gradients: spmm_grad_w on every shard, card vs CPU ----
    runs = []
    for mesh in (CARD4, ("cpu",) * 4):
        tr = ElasticTrainer(small_model(), small_provider(), ElasticConfig.from_bmax(
            32, n_replicas=R, mega_batch=10, placement="sharded"), base_lr=0.5, seed=SEED,
            mesh=mesh, sparse_grads=False)
        reset()
        state, mlog = tr.run(2, test_batches=small_test)
        if mesh == CARD4:
            launches["(e)"] = counts()
            by = dict(by_thread)
        runs.append((mlog.records, model_of(state)))
        tr.close()
    (recs, model), (cpu_recs, cpu_model) = runs
    n_rounds = sum(r["n_rounds"] for r in recs)
    expect("(e)", launches["(e)"], {
        "spmm": 4 * n_rounds + 2 * len(small_test), "spmm_grad_w": 4 * n_rounds,
        "sort_rows": 4 * n_rounds, "weighted_merge": 4 * leaves * 2})
    check_host_decisions("sharded (e) dense card vs CPU", recs, cpu_recs)
    l_err, m_err = loss_err(recs, cpu_recs), model_err(model, cpu_model)
    print(f"sharded (e) dense gradients, four shards card vs CPU: host decisions identical; "
          f"loss rel err {l_err:.3g}, global model err {m_err:.3g} (tol {MEASURED_TOL}); "
          f"spmm launches by thread {by}")
    if max(l_err, m_err) > MEASURED_TOL:
        raise RuntimeError("sharded (e): card and CPU runs disagree")

    _build.count_launch = count_launch
    return launches


# phase 14's settings: (a) phase 5's width, 4 mega-batches; (b) the drill
# at phase 4's width, 8 mega-batches, process 1 killed once its lease
# reports mega-batch 2; (c) and (d) phase 4's width, 3 mega-batches
MP_FULL_MB, MP_DRILL_MB, MP_SMALL_MB = 4, 8, 3
MP_TOL = 1e-5                   # losses (and (d)'s model), relative
MP_CHILD_TIMEOUT = 480          # seconds a fleet may take, children included
MP_SHM_NEED = 10e9              # bytes the full-width exchange files may hold
# the merge partial at full width: w1 + b1 + w2 + b2 in f32, one model
MP_PARTIAL_BYTES = 415_352_876


def xml_inputs(width: str, dev) -> dict:
    """The XML model, data and settings of phase 5 (``full``: Amazon-670K
    width, the 8,192-sample stand-in, weights drawn on the card) or phase 4
    (``small``), built the way those phases build them, so a fleet's child
    and the parent start from the same weights and data."""
    sys.path.insert(0, str(SRC))
    from repro_torch.data.providers import SparseProvider
    from repro_torch.data.sparse import SparseDataset, train_test_split
    from repro_torch.data.xml_synth import AMAZON_670K, make_xml_dataset
    from repro_torch.models.protocol import TrainableModel
    from repro_torch.models.xml_mlp import XMLMLPConfig, init_params, make_model

    if width == "full":
        NF, NC = AMAZON_670K["n_features"], AMAZON_670K["n_classes"]
        cfg = XMLMLPConfig(n_features=NF, n_classes=NC, hidden=128)
        ds = SparseDataset(**amazon_like_dataset(8192, NF, NC, np.random.default_rng(SEED)))
        train, test = train_test_split(ds, test_frac=0.25, seed=SEED)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        b_max, mega_batch, lr = 256, 20, 0.05
        test_batches = SparseProvider.make(train, seed=SEED).test_batches(test, b_max,
                                                                         max_samples=2048)
    else:
        cfg = XMLMLPConfig(n_features=512, n_classes=128, hidden=32)
        ds = make_xml_dataset(n_samples=1024, n_features=512, n_classes=128, avg_nnz=16,
                              seed=SEED)
        train, test = train_test_split(ds, 0.2, seed=SEED)
        params = init_params(cfg, torch.Generator().manual_seed(SEED))
        b_max, mega_batch, lr = 32, 10, 0.5
        test_batches = SparseProvider.make(train, seed=SEED).test_batches(test, b_max)
    base = make_model(cfg)

    def model():
        return TrainableModel(init=lambda generator: {k: v.clone() for k, v in params.items()},
                              loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                              config=cfg)

    return dict(model=model, provider=lambda: SparseProvider.make(train, seed=SEED),
                test_batches=test_batches, params=params, b_max=b_max,
                mega_batch=mega_batch, lr=lr)


def mp_counters() -> dict:
    """The launch counters of the XML path's kernels (each wrapper's own)."""
    from repro_torch.kernels.spmm.ops import spmm_cuda, spmm_grad_w_cuda, sort_rows_cuda
    from repro_torch.kernels.weighted_merge.ops import merge_cuda

    return {"spmm": spmm_cuda, "spmm_grad_w": spmm_grad_w_cuda, "sort_rows": sort_rows_cuda,
            "weighted_merge": merge_cuda}


def phase14_child(spec: dict) -> int:
    """One process of a phase-14 fleet (the parent starts it as a fresh
    interpreter): joins the fleet, trains its block of the replicas through
    ``ElasticTrainer.run`` and prints one JSON line: its records, its
    kernels' launches (read here), warm mega-batch seconds, peak memory and
    the exchange's seconds and bytes by tag."""
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.launch.multihost import MultihostSpec, bootstrap

    devices = tuple(spec["devices"])
    on_card = devices[0].startswith("cuda")
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    mh = bootstrap(MultihostSpec(spec["n"], spec["pid"], spec["fleet_dir"],
                                 spanning=spec["spanning"], local_devices=devices),
                   device=devices[0])
    inputs = xml_inputs(spec["width"], devices[0] if on_card else "cpu")
    cfg = ElasticConfig.from_bmax(inputs["b_max"], algorithm=spec["algo"], n_replicas=4,
                                  mega_batch=inputs["mega_batch"], placement="sharded")
    tr = ElasticTrainer(inputs["model"](), inputs["provider"](), cfg, base_lr=inputs["lr"],
                        seed=SEED, multihost=mh, sparse_grads=not spec["dense"])
    counters = mp_counters()
    for fn in counters.values():
        fn.launches = 0
    counters["weighted_merge"].no_momentum_launches = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    state, mlog = tr.run(spec["n_mb"], test_batches=inputs["test_batches"])
    if on_card:
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["weighted_merge_no_momentum"] = counters["weighted_merge"].no_momentum_launches
    stats = json.loads(json.dumps(mh.stats))   # the run's exchanges, before the profiled one
    if spec.get("save_model"):
        torch.save({k: v.cpu() for k, v in state.global_model.items()},
                   Path(spec["fleet_dir"]) / f"model-p{spec['pid']}.pt")
    busy = None
    if spec.get("profile"):
        # one more mega-batch under the profiler (every process runs it: the
        # exchanges keep the processes in lockstep): this process's kernels'
        # busy union over the mega-batch's wall
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = tr.run_megabatch(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = {"wall": wall, "busy": device_busy_s(prof)[0]}
    walls = [b["wall_clock"] - a["wall_clock"] for a, b in zip(mlog.records, mlog.records[1:])]
    print(json.dumps({
        "child": spec["pid"], "spanning": mh.spanning, "backend": mh.backend,
        "mesh": [str(d) for d in tr.mesh], "records": mlog.records, "launches": launches,
        "walls": walls, "first_wall": mlog.records[0]["wall_clock"],
        "peak": torch.cuda.max_memory_allocated() if on_card else None,
        "stats": stats, "profiled": busy}), flush=True)
    tr.close()
    mh.shutdown()
    return 0


def fleet_root() -> tuple[str, str]:
    """A fresh directory for a fleet's exchange files, and what it is:
    on /dev/shm (memory) when it exists with room for the full-width
    exchange, else in the temporary directory."""
    import shutil
    import tempfile

    shm = Path("/dev/shm")
    if shm.is_dir():
        free = shutil.disk_usage(shm).free
        if free >= MP_SHM_NEED:
            d = tempfile.mkdtemp(prefix="chip-smoke-fleet-", dir=shm)
            return d, f"{d} on /dev/shm ({free / 1e9:.1f} GB free)"
        why = f"/dev/shm has {free / 1e9:.2f} GB free, under {MP_SHM_NEED / 1e9:.0f} GB"
    else:
        why = "no /dev/shm"
    d = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    return d, f"{d} in the temporary directory ({why})"


def run_fleet(label: str, fleet_dir: str, n_mb: int, width: str, algo: str,
              devices: list, spanning: str = "host", dense: bool = False,
              save_model: bool = False, profile: bool = False,
              env: Optional[list] = None) -> list:
    """Start one child process per entry of ``devices`` (each a process's
    local devices), wait for all, and return their JSON lines in process
    order. Any child failing fails the phase; every child is ended."""
    os.makedirs(fleet_dir, exist_ok=True)
    procs, logs = [], []
    try:
        for pid, local in enumerate(devices):
            spec = dict(pid=pid, n=len(devices), fleet_dir=fleet_dir, spanning=spanning,
                        devices=list(local), width=width, algo=algo, n_mb=n_mb, dense=dense,
                        save_model=save_model and pid == 0, profile=profile)
            child_env = dict(os.environ, **(env[pid] if env else {}))
            log_path = Path(fleet_dir) / f"child{pid}.log"
            logs.append(log_path)
            with open(log_path, "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-u", str(ROOT / "chip_smoke.py"), "--phase14-child",
                     json.dumps(spec)], stdout=subprocess.PIPE, stderr=log_f, text=True,
                    env=child_env))
        deadline = time.monotonic() + MP_CHILD_TIMEOUT
        outs = []
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            lines = [ln for ln in out.splitlines() if ln.startswith('{"child"')]
            if p.returncode != 0 or not lines:
                tail = "".join(open(logs[pid]).readlines()[-30:])
                raise RuntimeError(f"multiprocess {label}: process {pid} exited "
                                   f"{p.returncode}:\n{tail}")
            outs.append(json.loads(lines[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def fleet_launches(outs: list) -> dict:
    """The fleet's launches of each kernel, summed over its processes."""
    total: dict = {}
    for o in outs:
        for k, v in o["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def expect_fleet(label: str, outs: list, want) -> None:
    """Every process's launches against ``want(records)``."""
    for o in outs:
        w = want(o["records"])
        print(f"multiprocess {label} process {o['child']} launches: {o['launches']} "
              f"(expected {w})")
        if any(o["launches"][k] != v for k, v in w.items()):
            raise RuntimeError(f"multiprocess {label}: process {o['child']} launches "
                               f"{o['launches']} != expected {w}")


def check_fleet(label: str, outs: list, want_recs: list, tol: float = MP_TOL) -> float:
    """Every process's host decisions identical to ``want_recs``, losses
    within ``tol``; returns the largest loss error."""
    err = 0.0
    for o in outs:
        check_host_decisions(f"multiprocess {label} process {o['child']}", o["records"],
                             want_recs)
        err = max(err, loss_err(o["records"], want_recs))
    if err > tol:
        raise RuntimeError(f"multiprocess {label}: losses {err:.3g} from the single run "
                           f"(tol {tol})")
    return err


def multiprocess_phase(card: str, four_cards: bool) -> dict:
    """Phase 14: multi-process training (module doc). Returns each fleet's
    launches by path."""
    import shutil

    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer

    root, where = fleet_root()
    print(f"multiprocess fleet dirs under {where}")
    launches = {}
    leaves = 4   # the XML model's w1, b1, w2, b2

    def single(width, algo, n_mb, **kw):
        """The single-process sharded run of one seed: four shards on the
        card (CARD4); records, model, launches."""
        inputs = xml_inputs(width, "cuda")
        cfg = ElasticConfig.from_bmax(inputs["b_max"], algorithm=algo, n_replicas=4,
                                      mega_batch=inputs["mega_batch"], placement="sharded")
        tr = ElasticTrainer(inputs["model"](), inputs["provider"](), cfg,
                            base_lr=inputs["lr"], seed=SEED, mesh=CARD4, **kw)
        state, mlog = tr.run(n_mb, test_batches=inputs["test_batches"])
        model = {k: v.detach().cpu().clone() for k, v in state.global_model.items()}
        tr.close()
        del tr, state
        torch.cuda.empty_cache()
        return mlog.records, model, inputs

    def fleet_dir(name):
        return os.path.join(root, name)

    def per_process(n_eval):
        """The launches each process needs, from its records: its two
        shards launch spmm each round and, on the dense path, spmm_grad_w
        and the sort; each shard merges its replicas through the
        no-momentum weighted_merge once a leaf a barrier (adaptive; sync
        merges nothing); every process evaluates."""
        def want(recs, algo, dense=False):
            n_rounds = sum(r["n_rounds"] for r in recs)
            merges = 2 * leaves * len(recs) if algo == "adaptive" else 0
            return {"spmm": 2 * n_rounds + len(recs) * n_eval,
                    "spmm_grad_w": 2 * n_rounds if dense else 0,
                    "sort_rows": 2 * n_rounds if dense else 0,
                    "weighted_merge": merges, "weighted_merge_no_momentum": merges}
        return want

    try:
        # ---- (a) host span, two processes on the card, full width ----
        t0 = time.perf_counter()
        recs, model, inputs = single("full", "adaptive", MP_FULL_MB)
        single_s = time.perf_counter() - t0
        n_eval = len(inputs["test_batches"])
        init = {k: v.cpu() for k, v in inputs["params"].items()}
        del inputs
        t0 = time.perf_counter()
        outs = run_fleet("(a)", fleet_dir("a"), MP_FULL_MB, "full", "adaptive",
                         [("cuda:0", "cuda:0")] * 2, save_model=True, profile=True)
        fleet_s = time.perf_counter() - t0
        want = per_process(n_eval)
        expect_fleet("(a)", outs, lambda r: want(r, "adaptive"))
        l_err = check_fleet("(a)", outs, recs)
        span_model = torch.load(Path(fleet_dir("a")) / "model-p0.pt")
        moved = moved_err(span_model, model, init)
        print(f"multiprocess (a) host span, 2 processes x 2 shards on one card vs one process "
              f"x 4 shards: host decisions identical over {MP_FULL_MB} mega-batches; loss rel "
              f"err {l_err:.3g} (tol {MP_TOL}); global model {moved:.3g} of its movement "
              f"(tol {ELASTIC_MOVED_TOL}), max err {model_err(span_model, model):.3g}; "
              f"fleet wall {fleet_s:.1f} s (children's start, data and weights included), "
              f"single run {single_s:.1f} s")
        if moved > ELASTIC_MOVED_TOL:
            raise RuntimeError("multiprocess (a): the fleet's model left the single run's")
        print(f"multiprocess measured on: {card}")
        for o in outs:
            st, walls = o["stats"], o["walls"]
            warm = sorted(walls)[len(walls) // 2]
            merge = st["merge"]
            xchg_s = sum(v["seconds"] for v in st.values())
            print(f"multiprocess (a) process {o['child']}: mesh {o['mesh']}; warm mega-batch "
                  f"{warm:.4f} s (median of mega-batches 2-{MP_FULL_MB}: "
                  f"{np.round(walls, 4).tolist()}; the first {o['first_wall']:.3f} s); "
                  f"exchange per barrier {merge['seconds'] / merge['calls']:.4f} s, "
                  f"{merge['bytes_written'] / merge['calls']:.0f} B written and "
                  f"{merge['bytes_read'] / merge['calls']:.0f} B read (the partial is "
                  f"{MP_PARTIAL_BYTES} B); every exchange {xchg_s:.3f} s over the run, "
                  f"{xchg_s / (o['first_wall'] + sum(walls)):.1%} of its mega-batches; by "
                  f"tag {json.dumps({k: round(v['seconds'], 4) for k, v in st.items()})}; "
                  f"peak device memory {o['peak'] / 1e9:.2f} GB; one more mega-batch under "
                  f"the profiler {o['profiled']['wall']:.4f} s, this process's kernels busy "
                  f"{o['profiled']['busy']:.4f} s ({o['profiled']['busy'] / o['profiled']['wall']:.1%})")
        launches["(a)"] = fleet_launches(outs)
        shutil.rmtree(fleet_dir("a"), ignore_errors=True)

        # ---- (b) the heartbeat drill through the spawner and the launcher ----
        drill = fleet_dir("b")
        cmd = [sys.executable, "-m", "repro_torch.launch.multihost_launch", "--procs", "2",
               "--devices-per-proc", "2", "--spanning", "host", "--fleet-dir", drill,
               "--kill-proc", "1", "--kill-after-mb", "2", "--timeout", str(MP_CHILD_TIMEOUT),
               "--", "--workload", "xml", "--samples", "1024", "--features", "512",
               "--classes", "128", "--avg-nnz", "16", "--hidden", "32", "--b-max", "32",
               "--mega-batch", "10", "--lr", "0.5", "--replicas", "4", "--algorithm",
               "adaptive", "--megabatches", str(MP_DRILL_MB), "--seed", str(SEED),
               "--heartbeat-interval", "0.3", "--heartbeat-grace", "2.0"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=MP_CHILD_TIMEOUT + 60)
        drill_s = time.perf_counter() - t0
        survivor = (Path(drill) / "logs" / "proc0.log").read_text()
        evict = re.search(r"\[fleet\] mb=(\d+) action=evict replica=\[2, 3\] reason=crash "
                          r"graceful=False process=1", survivor)
        lines = re.findall(r"\[adaptive\] mb=(\d+) loss=(\S+) acc=\S+ u=(\[[^\]]*\])",
                           survivor)
        print(f"multiprocess (b) drill: spawner exit {res.returncode}; "
              + " ".join(ln for ln in res.stdout.splitlines() if ln.startswith(
                  "[multihost-launch] proc")))
        for ln in survivor.splitlines():
            if "[fleet]" in ln or "dropped process" in ln or "mb=" in ln:
                print(f"multiprocess (b) survivor: {ln}")
        ok = (res.returncode == 0 and "proc 1: killed (expected)" in res.stdout
              and evict is not None and len(lines) == MP_DRILL_MB
              and all(math.isfinite(float(loss)) for _, loss, _ in lines)
              and len(json.loads(lines[-1][2])) == 2
              and "fleet events=1 replicas=2" in survivor)
        print(f"multiprocess (b) drill: process 1 SIGKILLed once its lease read mega-batch "
              f">= 2; the survivor evicted it at mega-batch "
              f"{evict.group(1) if evict else None} and finished {len(lines)} mega-batches "
              f"at R = 2 with finite losses in {drill_s:.1f} s")
        if not ok:
            raise RuntimeError(f"multiprocess (b): the drill failed:\n{res.stdout[-3000:]}\n"
                               f"{survivor[-3000:]}")

        # ---- (c) device span over gloo, two processes on the card ----
        small_eval = None
        for algo in ("sync", "adaptive"):
            recs, _, inputs = single("small", algo, MP_SMALL_MB)
            small_eval = len(inputs["test_batches"])
            outs = run_fleet(f"(c) {algo}", fleet_dir(f"c-{algo}"), MP_SMALL_MB, "small",
                             algo, [("cuda:0", "cuda:0")] * 2, spanning="device")
            if any(o["backend"] != "gloo" or o["spanning"] != "device" for o in outs):
                raise RuntimeError(f"multiprocess (c): not a gloo device span: "
                                   f"{[(o['spanning'], o['backend']) for o in outs]}")
            want = per_process(small_eval)
            expect_fleet(f"(c) {algo}", outs, lambda r, a=algo: want(r, a))
            l_err = check_fleet(f"(c) {algo}", outs, recs)
            axis = outs[0]["stats"].get("axis", {})
            print(f"multiprocess (c) device span {algo} over gloo, 2 processes x 2 shards on "
                  f"one card vs one process x 4 shards: host decisions identical over "
                  f"{MP_SMALL_MB} mega-batches; loss rel err {l_err:.3g} (tol {MP_TOL}); "
                  f"the replica axis's all_reduce {axis.get('calls', 0)} calls, "
                  f"{axis.get('seconds', 0.0):.3f} s in process 0")
            launches[f"(c) {algo}"] = fleet_launches(outs)

        # ---- (d) dense gradients under a host span, card vs CPU ----
        card_outs = run_fleet("(d) card", fleet_dir("d-card"), MP_SMALL_MB, "small",
                              "adaptive", [("cuda:0", "cuda:0")] * 2, dense=True,
                              save_model=True)
        cpu_outs = run_fleet("(d) cpu", fleet_dir("d-cpu"), MP_SMALL_MB, "small",
                             "adaptive", [("cpu", "cpu")] * 2, dense=True, save_model=True)
        want = per_process(small_eval)
        expect_fleet("(d) card", card_outs, lambda r: want(r, "adaptive", dense=True))
        l_err = check_fleet("(d) card vs CPU", card_outs, cpu_outs[0]["records"])
        m_err = model_err(torch.load(Path(fleet_dir("d-card")) / "model-p0.pt"),
                          torch.load(Path(fleet_dir("d-cpu")) / "model-p0.pt"))
        print(f"multiprocess (d) dense gradients under a host span, card vs CPU (both 2 "
              f"processes x 2 shards): host decisions identical; loss rel err {l_err:.3g}, "
              f"global model err {m_err:.3g} (tol {MP_TOL})")
        if m_err > MP_TOL:
            raise RuntimeError("multiprocess (d): card and CPU fleets disagree")
        launches["(d)"] = fleet_launches(card_outs)

        # ---- on more cards: (a) and (c) with one card per process ----
        if four_cards:
            own = [{"CUDA_VISIBLE_DEVICES": str(p)} for p in range(2)]
            recs, model, _ = single("full", "adaptive", MP_FULL_MB)
            outs = run_fleet("(a) own cards", fleet_dir("a4"), MP_FULL_MB, "full",
                             "adaptive", [("cuda:0", "cuda:0")] * 2, save_model=True, env=own)
            l_err = check_fleet("(a) own cards", outs, recs)
            moved = moved_err(torch.load(Path(fleet_dir("a4")) / "model-p0.pt"), model, init)
            for o in outs:
                merge, walls = o["stats"]["merge"], o["walls"]
                print(f"multiprocess (a) own cards process {o['child']}: warm mega-batch "
                      f"{sorted(walls)[len(walls) // 2]:.4f} s ({np.round(walls, 4).tolist()}),"
                      f" exchange per barrier {merge['seconds'] / merge['calls']:.4f} s, "
                      f"peak {o['peak'] / 1e9:.2f} GB")
            print(f"multiprocess (a) own cards: decisions identical, loss rel err "
                  f"{l_err:.3g}, model {moved:.3g} of its movement")
            if moved > ELASTIC_MOVED_TOL:
                raise RuntimeError("multiprocess (a) own cards: the model left the single run")
            launches["(a) own cards"] = fleet_launches(outs)
            shutil.rmtree(fleet_dir("a4"), ignore_errors=True)
            for algo in ("sync", "adaptive"):
                recs, _, _ = single("small", algo, MP_SMALL_MB)
                outs = run_fleet(f"(c) own cards {algo}", fleet_dir(f"c4-{algo}"),
                                 MP_SMALL_MB, "small", algo, [("cuda:0", "cuda:0")] * 2,
                                 spanning="device", env=own)
                if any(o["backend"] != "nccl" for o in outs):
                    raise RuntimeError("multiprocess (c) own cards: not NCCL")
                l_err = check_fleet(f"(c) own cards {algo}", outs, recs)
                axis = outs[0]["stats"].get("axis", {})
                print(f"multiprocess (c) own cards {algo} over NCCL: decisions identical, "
                      f"loss rel err {l_err:.3g}; the axis's all_reduce "
                      f"{axis.get('calls', 0)} calls, {axis.get('seconds', 0.0):.3f} s")
                launches[f"(c) own cards {algo}"] = fleet_launches(outs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main(only_multiprocess: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p
    )

    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core import algorithms
    from repro_torch.configs.archs import ARCHS
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.providers import SparseProvider
    from repro_torch.data.sparse import SparseDataset, train_test_split
    from repro_torch.data.xml_synth import AMAZON_670K, make_xml_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmm.ops import spmm, spmm_cuda, spmm_grad_w_cuda, sort_rows_cuda
    from repro_torch.kernels.spmm.ref import sort_rows_ref, spmm_grad_w_ref, spmm_ref
    from repro_torch.kernels.weighted_merge.ops import merge_cuda
    from repro_torch.kernels.weighted_merge.ref import weighted_merge_ref
    from repro_torch.kernels.flash_attention.ops import PATHS as FLASH_PATHS
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gmm.ops import PATHS as GMM_PATHS
    from repro_torch.kernels.moe_gmm.ops import moe_ffn_gmm_cuda
    from repro_torch.kernels.moe_gmm.ref import moe_ffn_gmm_ref
    from repro_torch.kernels.ssd_scan.ops import PATHS as SSD_PATHS
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as MDL
    from repro_torch.models.protocol import TrainableModel
    from repro_torch.models.xml_mlp import XMLMLPConfig, init_params, make_model

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}")
    if only_multiprocess:
        # phase 14 alone (the multi-card runs of its fleets); the kernels'
        # line comes from the full run
        multiprocess = multiprocess_phase(smi, four_cards=torch.cuda.device_count() >= 2)
        print(f"multiprocess launches: {json.dumps(multiprocess)}")
        print(f"seconds: {time.perf_counter() - t_start:.1f}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernels against their plain versions --------------------------
    NF, NC, H = AMAZON_670K["n_features"], AMAZON_670K["n_classes"], 128
    R, B_MAX = 4, 256
    rng = np.random.default_rng(SEED)
    ds = SparseDataset(**amazon_like_dataset(8192, NF, NC, rng))
    train, test = train_test_split(ds, test_frac=0.25, seed=SEED)
    provider = SparseProvider.make(train, seed=SEED)
    K = provider.batcher.max_nnz
    print(f"data: {train.n_samples} train / {test.n_samples} test samples, avg nnz "
          f"{train.avg_nnz():.1f}, max_nnz K={K}, max_labels {provider.batcher.max_labels}")

    stacked = provider.stack([provider.fetch(B_MAX, B_MAX) for _ in range(R)])
    idx = torch.from_numpy(stacked["feat_idx"]).to(dev)
    idx[..., 1] = idx[..., 0]                          # duplicate slots
    val = torch.from_numpy(stacked["feat_val"]).to(dev)
    mask = torch.from_numpy(stacked["feat_mask"]).to(dev)
    print(f"spmm inputs: (R,B,K)=({R},{B_MAX},{K}), masked slots "
          f"{1 - mask.float().mean().item():.3f}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w32 = torch.randn((R, NF, H), generator=gen, device=dev)
    results = {}

    def measure(label, kernel_fn, plain_fn, library_fn, nbytes, flops, tol,
                peak=H100_F32_FLOPS, path="cuda_core"):
        """Check the kernel against its plain version, then time all three
        (``library_fn`` None: no single PyTorch call computes it). ``peak``
        is the card's rate for the inputs' type, or ``flops`` a list of
        (flops, rate) pairs where the work mixes types; ``path`` the
        kernel's path for them (tensor or CUDA cores)."""
        got, want = kernel_fn(), plain_fn()
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        err = max(check_close(label, g, w, tol) for g, w in pairs)
        del got, want
        work = flops if isinstance(flops, list) else [(flops, peak)]
        flops = sum(f for f, _ in work)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, sum(f / r for f, r in work) * 1e3
        r = dict(max_abs_err=err, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations", path=path)
        # ms: device time from the profiler trace (the CUDA-event time
        # where the trace shows none); call_ms: CUDA events around each
        # call, which also count the host's cost of issuing it
        for name, fn in (("", kernel_fn), ("plain_", plain_fn), ("library_", library_fn)):
            if fn is None:
                r[name + "call_ms"] = r[name + "ms"] = None
                continue
            r[name + "call_ms"] = cuda_ms(fn)
            dev_t = device_ms(fn)
            r[name + "ms"] = dev_t if dev_t is not None else r[name + "call_ms"]
            r[name + "timing"] = "profiler" if dev_t is not None else "events"
        r["share"] = r["bound_ms"] / r["ms"]  # how near the kernel comes to its bound
        shown = " ".join(f"{k} {v:.4g}" for k, v in r.items() if isinstance(v, float))
        print(f"kernel {label}: {shown} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        return r

    def spmm_case(name, idx, val, mask, w, tol, breakdown=False):
        a, b = spmm_cuda(idx, val, mask, w), spmm_cuda(idx, val, mask, w)
        if not torch.equal(a, b):
            raise RuntimeError(f"spmm[{name}]: two launches differ")
        del a, b
        elt, h = w.element_size(), w.shape[-1]
        n_slots, n_rows = idx.numel(), idx.numel() // idx.shape[-1]
        # yardstick: one embedding_bag over the replicas' rows, flattened
        offs = (torch.arange(w.shape[0], device=dev) * w.shape[-2]).view(-1, 1, 1) \
            if w.ndim == 3 else 0
        flat_idx = (idx.long() + offs).reshape(-1, idx.shape[-1])
        # the bound counts what this data needs: each distinct W row that an
        # unmasked slot names, read once; idx/val/mask read once; the output
        # written once; a multiply-add per unmasked slot and column
        live = mask.bool().reshape(-1, idx.shape[-1])
        n_live = int(live.sum())
        w_rows = torch.unique(flat_idx[live]).numel()
        print(f"spmm[{name}] needs: {n_live} of {n_slots} slots unmasked, "
              f"{w_rows} distinct W rows; two launches bitwise equal")
        psw = (val * mask).to(w.dtype).reshape(-1, idx.shape[-1])
        wf = w.reshape(-1, h)
        kernel = lambda: spmm_cuda(idx, val, mask, w)  # noqa: E731
        split = device_breakdown(f"spmm[{name}]", kernel) if breakdown else None
        r = measure(
            f"spmm[{name}]", kernel,
            lambda: spmm_ref(idx, val, mask, w),
            lambda: torch.nn.functional.embedding_bag(
                flat_idx, wf, per_sample_weights=psw, mode="sum"),
            nbytes=w_rows * h * elt + n_slots * (4 + 4 + 1) + n_rows * h * elt,
            flops=2 * n_live * h, tol=tol,
        )
        if split is not None:
            r["by_kernel_ms"] = split
        return r

    results["spmm"] = spmm_case("f32 R=4", idx, val, mask, w32, F32_TOL, breakdown=True)
    spmm_case("bf16 R=4", idx, val, mask, w32.to(torch.bfloat16), BF16_TOL)
    spmm_case("f32 2-D eval", idx[0], val[0], mask[0], w32[0].contiguous(), F32_TOL)
    odd = (idx[:, :8, :37].contiguous() % 5000, val[:, :8, :37].contiguous(),
           mask[:, :8, :37].contiguous())
    w_odd = w32[:, :5000, :100].contiguous()
    spmm_case("f32 H=100 K=37", *odd, w_odd, F32_TOL)
    spmm_case("bf16 H=100 K=37", *odd, w_odd.to(torch.bfloat16), BF16_TOL)

    def same_nan(what, got, want):
        """NaN exactly where the plain version has it, the rest within F32_TOL."""
        nan = want.isnan()
        if not (nan.any() and torch.equal(got.isnan(), nan)):
            raise RuntimeError(f"{what}: NaN at {int(got.isnan().sum())} places, the plain "
                               f"version at {int(nan.sum())}")
        check_close(what, got[~nan], want[~nan], F32_TOL)
        print(f"{what}: NaN at the same {int(nan.sum())} places as the plain version")

    # masked slots are multiplied in (scale 0): a NaN in W[r, 0], which only
    # the padding names here, reaches every output row with a padded slot,
    # though the kernel gathers a padding run's row once
    idx_pad = torch.where(mask, torch.where(idx == 0, 1, idx), 0).int()
    w_nan = w32.clone()
    w_nan[:, 0, 7] = float("nan")
    same_nan("spmm NaN in a W row only padding names", spmm_cuda(idx_pad, val, mask, w_nan),
             spmm_ref(idx_pad, val, mask, w_nan))
    del w_nan

    # the counting sort spmm_grad_w walks: exactly torch's stable sort
    def sort_case(name, keys, n_rows, timed=False):
        rows, order = sort_rows_cuda(keys, n_rows)
        want_rows, want_order = torch.sort(keys, dim=-1, stable=True)
        if not (torch.equal(rows, want_rows) and torch.equal(order.long(), want_order)):
            raise RuntimeError(f"sort_rows[{name}]: not the order of a stable sort")
        if not timed:
            return None
        plain_rows, plain_order = sort_rows_ref(keys, n_rows)
        if not (torch.equal(plain_rows, rows) and torch.equal(plain_order, order)):
            raise RuntimeError(f"sort_rows[{name}]: the plain emulation differs")
        times = {"ms": device_ms(lambda: sort_rows_cuda(keys, n_rows)),
                 "plain_ms": device_ms(lambda: sort_rows_ref(keys, n_rows)),
                 "library_ms": device_ms(lambda: torch.sort(keys, dim=-1, stable=True))}
        print(f"sort_rows[{name}]: equal to torch.sort(stable=True) and to its plain "
              "emulation; device ms a call " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        return times

    R_S = (R, idx[0].numel())
    sort_times = sort_case(f"{R_S} NF", idx.reshape(R_S), NF, timed=True)
    for n_rows, shape in ((1, (1, 1)), (300, (2, 5000)), (NF, (3, 4100)), (300_000, (2, 3001))):
        sort_case(f"{shape} n_rows {n_rows}",
                  torch.randint(0, n_rows, shape, generator=gen, device=dev, dtype=torch.int32),
                  n_rows)
    sort_case("all on row NF - 1", torch.full(R_S, NF - 1, device=dev, dtype=torch.int32), NF)
    sort_case("all on row 0", torch.zeros(R_S, device=dev, dtype=torch.int32), NF)
    print("sort_rows: the order of torch's stable sort at every shape")

    def into_nan(call):
        """``call()`` with its output landing in memory that held NaN: each
        try fills the last output with NaN and frees it, and the caching
        allocator hands the block back to the next call's output."""
        out = call()
        for _ in range(5):
            ptr = out.data_ptr()
            out.fill_(float("nan"))
            del out
            out = call()
            if out.data_ptr() == ptr:
                return out
        raise RuntimeError("the allocator did not hand the NaN-filled block back")

    def unnamed_rows_zero(what, got, idx, n_rows):
        """Every row that no slot of its replica names is exactly 0."""
        n_rep = got.numel() // (n_rows * got.shape[-1])
        named = torch.zeros((n_rep, n_rows), dtype=torch.bool, device=dev)
        named.scatter_(1, idx.reshape(n_rep, -1).long(), True)
        if not (got.reshape(n_rep, n_rows, -1)[~named] == 0).all():
            raise RuntimeError(f"{what}: a row no slot names is not 0 in a NaN-filled output")
        return int((~named).sum())

    def grad_w_case(name, idx, val, mask, dh, n_rows):
        """spmm_grad_w: kernel against plain, bitwise-repeatable, every row
        written into an output that held NaN, timed."""
        a = spmm_grad_w_cuda(idx, val, mask, dh, n_rows)
        b = spmm_grad_w_cuda(idx, val, mask, dh, n_rows)
        if not torch.equal(a, b):
            raise RuntimeError(f"spmm_grad_w[{name}]: two launches differ")
        del a, b
        got = into_nan(lambda: spmm_grad_w_cuda(idx, val, mask, dh, n_rows))
        n_zero = unnamed_rows_zero(f"spmm_grad_w[{name}]", got, idx, n_rows)
        check_close(f"spmm_grad_w[{name}] into NaN", got,
                    spmm_grad_w_ref(idx, val, mask, dh, n_rows), F32_TOL)
        del got
        h, lead = dh.shape[-1], idx.shape[:-2]
        n_rep = idx.numel() // (idx.shape[-1] * idx.shape[-2])
        # yardstick: one index_add_ of the per-slot products into a zeroed
        # output; its flat rows and products are made outside the timing
        flat, prods = scatter_operands(idx, val, mask, dh, n_rows, torch.float32)
        # the bound counts what this data needs: the dense f32 output written
        # once, idx/val/mask read once, one dh row per (replica, sample), and
        # a multiply-add per unmasked slot and column
        n_live = int(mask.sum())
        print(f"spmm_grad_w[{name}] needs: {n_live} of {idx.numel()} slots unmasked, "
              f"largest run {int(torch.bincount(flat).max())} slots; two launches bitwise "
              f"equal; into a NaN-filled output, its {n_zero} unnamed rows exactly 0")
        split = device_breakdown(f"spmm_grad_w[{name}]",
                                 lambda: spmm_grad_w_cuda(idx, val, mask, dh, n_rows))
        r = measure(
            f"spmm_grad_w[{name}]",
            lambda: spmm_grad_w_cuda(idx, val, mask, dh, n_rows),
            lambda: spmm_grad_w_ref(idx, val, mask, dh, n_rows),
            lambda: torch.zeros((n_rep * n_rows, h), device=dev).index_add_(0, flat, prods),
            nbytes=n_rep * n_rows * h * 4 + idx.numel() * (4 + 4 + 1)
            + math.prod(lead) * idx.shape[-2] * h * 4,
            flops=2 * n_live * h, tol=F32_TOL,
        )
        r["by_kernel_ms"] = split
        return r

    def scatter_operands(idx, val, mask, dh, n_rows, dtype):
        """spmm_grad_w as one scatter: (…*B*K,) flat output rows and the
        (…*B*K, H) per-slot products scale·dh in ``dtype``."""
        n_rep = idx.numel() // (idx.shape[-1] * idx.shape[-2])
        offs = (torch.arange(n_rep, device=dev) * n_rows).view(-1, 1)
        flat = (idx.reshape(n_rep, -1).long() + offs).reshape(-1)
        prods = (val * mask).to(dtype)[..., None] * dh.to(dtype)[..., None, :]
        return flat, prods.reshape(-1, dh.shape[-1])

    # spmm_grad_w's chunk boundaries at small sizes: fewer slots than a
    # chunk, runs crossing many chunks, one row for every slot, ragged H.
    # Long f32 sums differ by reassociation, so each result is held against
    # an f64 scatter: within 2e-5, or within twice the plain version's error.
    # The one-row cases also write into an output that held NaN.
    n_edge = 0
    for lead in ((), (3,)):
        for b, k in ((1, 1), (1, 128), (3, 257), (64, 100)):
            for h in (3, 128, 132):
                for one_row in (False, True):
                    e_mask = torch.rand(lead + (b, k), generator=gen, device=dev) > 0.67
                    e_idx = torch.randint(0, 300, lead + (b, k), generator=gen, device=dev,
                                          dtype=torch.int32)
                    e_idx = torch.full_like(e_idx, 7) if one_row else torch.where(e_mask, e_idx, 0)
                    e_val = torch.randn(lead + (b, k), generator=gen, device=dev)
                    e_dh = torch.randn(lead + (b, h), generator=gen, device=dev)
                    call = functools.partial(spmm_grad_w_cuda, e_idx, e_val, e_mask, e_dh, 300)
                    got = into_nan(call) if one_row else call()
                    again = call()
                    plain = spmm_grad_w_ref(e_idx, e_val, e_mask, e_dh, 300)
                    flat, prods = scatter_operands(e_idx, e_val, e_mask, e_dh, 300,
                                                   torch.float64)
                    exact = torch.zeros((flat.numel() // (b * k) * 300, h), dtype=torch.float64,
                                        device=dev).index_add_(0, flat, prods).view(got.shape)
                    err_k = (got.double() - exact).abs().max().item()
                    err_p = (plain.double() - exact).abs().max().item()
                    if not torch.equal(got, again) or err_k > max(2 * err_p, 2e-5):
                        raise RuntimeError(f"spmm_grad_w edge case {lead + (b, k, h)} one_row="
                                           f"{one_row}: error {err_k:.3g} against f64 (plain "
                                           f"{err_p:.3g}), repeatable {torch.equal(got, again)}")
                    if one_row:
                        unnamed_rows_zero(f"spmm_grad_w edge case {lead + (b, k, h)}", got,
                                          e_idx, 300)
                    n_edge += 1
    print(f"spmm_grad_w: {n_edge} edge cases repeatable and as close to f64 as the plain "
          "version; the one-row ones 0 in every other row of a NaN-filled output")

    dh = torch.randn((R, B_MAX, H), generator=gen, device=dev)
    results["spmm_grad_w"] = grad_w_case("f32 R=4", idx, val, mask, dh, NF)
    results["spmm_grad_w"]["sort"] = sort_times
    grad_w_case("f32 2-D", idx[0], val[0], mask[0], dh[0].contiguous(), NF)
    grad_w_case("f32 H=100 K=37", *odd, dh[:, :8, :100].contiguous(), 5000)
    # a NaN in dh[b] of a sample with padded (masked) slots reaches the row
    # they name, 0, as in the plain version
    dh_nan = dh.clone()
    padded = int((~mask[1]).any(-1).nonzero()[0])
    dh_nan[1, padded, 3] = float("nan")
    same_nan("spmm_grad_w NaN in dh of a padded sample",
             spmm_grad_w_cuda(idx, val, mask, dh_nan, NF),
             spmm_grad_w_ref(idx, val, mask, dh_nan, NF))
    del dh_nan
    # a masked slot's scale is exactly 0 whatever its val holds (the
    # reference's val * mask is a select): an infinite val in every padded
    # slot changes neither kernel's output
    val_inf = torch.where(mask, val, float("inf"))
    err_f = check_close("spmm with inf in masked vals", spmm_cuda(idx, val_inf, mask, w32),
                        spmm_ref(idx, val, mask, w32), F32_TOL)
    err_b = check_close("spmm_grad_w with inf in masked vals",
                        spmm_grad_w_cuda(idx, val_inf, mask, dh, NF),
                        spmm_grad_w_ref(idx, val, mask, dh, NF), F32_TOL)
    print(f"spmm, spmm_grad_w with inf in every masked val: as with finite vals (max abs err "
          f"{err_f:.3g}, {err_b:.3g})")
    del val_inf
    torch.cuda.empty_cache()

    # spmm's autograd Function: dW (the kernel) and d feat_val against
    # autograd through the plain forward, at the main path's shapes
    def grads(fn):
        v = val.clone().requires_grad_(True)
        w = w32.clone().requires_grad_(True)
        (fn(idx, v, mask, w) * dh).sum().backward()
        return w.grad, v.grad

    (dw, dv), (dw_ref, dv_ref) = grads(spmm), grads(spmm_ref)
    err_w = check_close("spmm backward dW", dw, dw_ref, F32_TOL)
    err_v = check_close("spmm backward dval", dv, dv_ref, F32_TOL)
    print(f"spmm autograd backward: dW max abs err {err_w:.3g}, dval {err_v:.3g}")
    del w32, w_odd, dw, dv, dw_ref, dv_ref

    def merge_case(name, n, dtype, momentum, tol):
        reps = torch.randn((R, n), generator=gen, device=dev).to(dtype)
        alphas = torch.rand((R,), generator=gen, device=dev)
        g = torch.randn((n,), generator=gen, device=dev).to(dtype) if momentum else None
        gp = torch.randn((n,), generator=gen, device=dev).to(dtype) if momentum else None
        gamma = 0.9 if momentum else 0.0
        elt = reps.element_size()
        # yardstick: the R-way weighted sum alone (no single call adds the
        # momentum term)
        a_cast = alphas.to(dtype)
        return measure(
            f"weighted_merge[{name}]",
            lambda: merge_cuda(reps, alphas, g, gp, gamma),
            lambda: weighted_merge_ref(reps, alphas, g, gp, gamma),
            lambda: torch.einsum("r,rn->n", a_cast, reps),
            nbytes=(R + 1) * n * elt + R * 4 + (2 * n * elt if momentum else 0),
            flops=2 * R * n + (3 * n if momentum else 0), tol=tol,
        )

    N_W2 = H * NC  # the w2 leaf: 85,771,648 elements
    results["weighted_merge"] = merge_case("f32 w2 momentum", N_W2, torch.float32, True, F32_TOL)
    merge_case("f32 w2", N_W2, torch.float32, False, F32_TOL)
    merge_case("bf16 w2 momentum", N_W2, torch.bfloat16, True, BF16_TOL)
    merge_case("f32 b2 ragged momentum", NC, torch.float32, True, F32_TOL)
    merge_case("bf16 ragged", 5001, torch.bfloat16, False, BF16_TOL)
    merge_case("f32 ragged momentum", 5001, torch.float32, True, F32_TOL)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the LM serving kernels, at the shapes the full-width prefills of
    # phase 8 give them (bf16, B = 2, S = 4096) and the reference's test
    # shapes (tests/test_kernels.py) with its tolerances
    peak = {torch.float32: H100_F32_FLOPS, torch.bfloat16: H100_BF16_FLOPS}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def flash_case(name, b, sq, skv, hq, hkv, hd, causal, window, dtype, tol, library=False):
        q, k, v = randn(b, sq, hq, hd, dtype=dtype), randn(b, skv, hkv, hd, dtype=dtype), \
            randn(b, skv, hkv, hd, dtype=dtype)
        # the bound counts the (query, key) pairs the masks allow: a
        # multiply-add per pair and dim for q.k and for p.v
        i = np.arange(sq)
        hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
        lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
        pairs = int(np.maximum(hi - lo + 1, 0).sum())
        lib = None
        if library:
            # yardstick: PyTorch's fused attention on (B, H, S, hd) copies
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        return measure(
            f"flash_attention[{name}]",
            lambda: flash_attention_cuda(q, k, v, causal=causal, window=window),
            lambda: attention_ref(q, k, v, causal=causal, window=window), lib,
            nbytes=(2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            flops=4 * b * hq * hd * pairs, tol=tol, peak=peak[dtype], path=FLASH_PATHS[dtype],
        )

    results["flash_attention"] = flash_case(
        "llama3.2-1b bf16 (2,4096,32/8,64) causal", 2, 4096, 4096, 32, 8, 64, True, 0,
        torch.bfloat16, BF16_LONG_ATTN_TOL, library=True)
    flash_case("moonshot bf16 (2,4096,16/16,128) causal", 2, 4096, 4096, 16, 16, 128, True, 0,
               torch.bfloat16, BF16_LONG_ATTN_TOL, library=True)
    # kimi-k2-1t-a32b's attention (64 q heads, 8 kv heads, head dim 112)
    flash_case("kimi-k2 bf16 (1,4096,64/8,112) causal", 1, 4096, 4096, 64, 8, 112, True, 0,
               torch.bfloat16, BF16_LONG_ATTN_TOL, library=True)
    for case in ((2, 128, 128, 4, 2, 64, True, 0), (1, 256, 256, 8, 2, 32, True, 64),
                 (2, 96, 160, 4, 4, 64, False, 0), (1, 200, 200, 2, 1, 64, True, 0)):
        flash_case(f"f32 {case}", *case, torch.float32, ATTN_TOL)
    for case in ((1, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 2, 1, 64, True, 0),
                 (1, 256, 256, 8, 2, 32, True, 64), (2, 96, 160, 4, 4, 64, False, 0),
                 (1, 192, 192, 8, 1, 112, True, 0), (1, 256, 256, 4, 2, 128, True, 96)):
        flash_case(f"bf16 {case}", *case, torch.bfloat16, BF16_ATTN_TOL)
    # every head dim the kernel takes, on both paths (ragged, GQA, causal)
    for hd in HEAD_DIMS:
        for dtype, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16, BF16_ATTN_TOL)):
            q, k, v = randn(1, 200, 4, hd, dtype=dtype), randn(1, 200, 2, hd, dtype=dtype), \
                randn(1, 200, 2, hd, dtype=dtype)
            err = check_close(f"flash_attention[{FLASH_PATHS[dtype]} hd {hd}]",
                              flash_attention_cuda(q, k, v), attention_ref(q, k, v), tol)
            print(f"kernel flash_attention[{FLASH_PATHS[dtype]} hd {hd} (1,200,200,4,2)]: "
                  f"max_abs_err {err:.4g}")
    for hd in (8, 24, 136):  # no multiple of 16 in [16, 128]: refused before launch
        q = randn(1, 64, 2, hd, dtype=torch.bfloat16)
        try:
            flash_attention_cuda(q, q, q)
        except ValueError:
            continue
        raise RuntimeError(f"flash_attention_cuda took head dim {hd}")
    torch.cuda.empty_cache()

    def gmm_case(name, e, c, d, f, dtype, tol, library=False):
        # bf16 reaches the tensor-core path; (2,100,64,300) also the
        # wrapper's padding of F to a multiple of 8
        buf = randn(e, c, d, scale=0.5, dtype=dtype)
        pad_rows = torch.rand((e, c), generator=gen, device=dev) > 0.8  # capacity padding
        buf[pad_rows] = 0
        wi, wg = randn(e, d, f, scale=d ** -0.5, dtype=dtype), randn(e, d, f, scale=d ** -0.5,
                                                                      dtype=dtype)
        wo = randn(e, f, d, scale=f ** -0.5, dtype=dtype)
        if moe_ffn_gmm_cuda(buf, wi, wg, wo)[pad_rows].any():
            raise RuntimeError(f"moe_ffn_gmm[{name}]: zero rows gave nonzero output")
        lib = None
        if library:
            lib = lambda: torch.bmm(  # noqa: E731
                torch.nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi), wo)
        return measure(
            f"moe_ffn_gmm[{name}]",
            lambda: moe_ffn_gmm_cuda(buf, wi, wg, wo),
            lambda: moe_ffn_gmm_ref(buf, wi, wg, wo), lib,
            nbytes=(2 * buf.numel() + 3 * wi.numel()) * buf.element_size(),
            flops=6 * e * c * d * f, tol=tol, peak=peak[dtype], path=GMM_PATHS[dtype],
        )

    results["moe_ffn_gmm"] = gmm_case("moonshot bf16 (64,960,2048,1408)", 64, 960, 2048, 1408,
                                      torch.bfloat16, BF16_TOL, library=True)
    for e, c, d, f in ((4, 64, 128, 256), (2, 100, 64, 300), (8, 32, 256, 512)):
        gmm_case(f"f32 {(e, c, d, f)}", e, c, d, f, torch.float32, ATTN_TOL)
        gmm_case(f"bf16 {(e, c, d, f)}", e, c, d, f, torch.bfloat16, BF16_TOL)
    torch.cuda.empty_cache()

    def ssd_case(name, b, l, h, p, n, chunk, bc_dtype, tol, shared_bc, passes=False):
        x = randn(b, l, h, p, scale=0.5)
        da = -torch.rand((b, l, h), generator=gen, device=dev) * 0.5
        if shared_bc:
            # as mamba2_forward passes them: slices of the conv output,
            # broadcast over heads with a head stride of 0
            xbc = randn(b, l, h * p + 2 * n, scale=0.5, dtype=bc_dtype)
            bm = xbc[..., h * p:h * p + n][:, :, None, :].expand(b, l, h, n)
            cm = xbc[..., h * p + n:][:, :, None, :].expand(b, l, h, n)
        else:
            bm, cm = randn(b, l, h, n, scale=0.5, dtype=bc_dtype), randn(b, l, h, n, scale=0.5,
                                                                        dtype=bc_dtype)
        bc_elems = b * l * n if shared_bc else bm.numel()
        # the bound counts the lower-triangular work of each chunk, each
        # product once: C.B^T over i >= j, once per (b, chunk) where the heads
        # share B/C, at the bf16 tensor-core rate where both are bf16; and
        # (scores).x, the carry-in and the state update, which have an f32
        # operand, at the TF32 rate. The kernel's C.B^T for each head and its
        # 3xTF32 split's extra passes are its own cost, not the function's.
        nc = l // chunk
        cb_flops = (b if shared_bc else b * h) * nc * chunk * (chunk + 1) * n
        tf32_flops = b * h * nc * (chunk * (chunk + 1) * p + 4 * chunk * n * p)
        cb_rate = H100_BF16_FLOPS if bc_dtype == torch.bfloat16 else H100_TF32_FLOPS
        r = measure(
            f"ssd_scan[{name}]",
            lambda: ssd_scan_cuda(x, da, bm, cm, chunk),
            lambda: ssd_scan_ref(x, da, bm, cm, chunk), None,
            nbytes=x.numel() * 4 * 2 + da.numel() * 4 + 2 * bc_elems * bm.element_size()
            + b * h * p * n * 4,
            flops=[(cb_flops, cb_rate), (tf32_flops, H100_TF32_FLOPS)], tol=tol,
            path=SSD_PATHS[x.dtype],
        )
        if passes:
            # one call is three kernels: each one's device time
            by_kernel = device_ms_by_kernel(lambda: ssd_scan_cuda(x, da, bm, cm, chunk))
            r["pass_ms"] = {}
            for kernel in ("chunk_states", "state_passing", "chunk_outputs"):
                hits = [(ms, count) for key, ms, count in by_kernel if f"{kernel}_kernel" in key]
                if [count for _, count in hits] != [1]:
                    raise RuntimeError(f"ssd_scan[{name}]: {kernel} launched {hits} a call")
                r["pass_ms"][kernel] = hits[0][0]
            print(f"kernel ssd_scan[{name}] passes, device ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["pass_ms"].items()))
        return r

    results["ssd_scan"] = ssd_case("mamba2-780m (2,4096,48,64) N128 c256, bf16 B/C", 2, 4096,
                                   48, 64, 128, 256, torch.bfloat16, SSD_MAIN_TOL, True,
                                   passes=True)
    for case in ((2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64), (2, 64, 8, 16, 8, 16)):
        ssd_case(f"f32 {case}", *case, torch.float32, SSD_TOL, False)
    ssd_case("bf16 B/C (1,64,2,32,16,32)", 1, 64, 2, 32, 16, 32, torch.bfloat16, BF16_ATTN_TOL,
             False)
    ssd_case("f32 shared B/C, chunk 96 (1,192,3,64,64,96)", 1, 192, 3, 64, 64, 96,
             torch.float32, SSD_TOL, True)
    # P, N and chunk off the fragment multiples: zero-padded in shared memory
    ssd_case("f32 ragged (1,120,3,24,12,40)", 1, 120, 3, 24, 12, 40, torch.float32, SSD_TOL,
             False)
    # N past one 128-column k-tile of the outputs pass, and a chunk past one
    # 256-position segment of the chunk-states pass' scan of a
    ssd_case("f32 N 300 (1,128,2,16,300,64)", 1, 128, 2, 16, 300, 64, torch.float32, SSD_TOL,
             False)
    ssd_case("f32 chunk 640 (1,1280,2,16,16,640)", 1, 1280, 2, 16, 16, 640, torch.float32,
             SSD_TOL, False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4. the slice on the card against the CPU, small width -------------
    small = dict(n_features=512, n_classes=128, hidden=32)
    p0 = init_params(XMLMLPConfig(**small), torch.Generator().manual_seed(SEED))
    sds = make_xml_dataset(n_samples=1024, n_features=512, n_classes=128, avg_nnz=16,
                           seed=SEED)
    strain, stest = train_test_split(sds, 0.2, seed=SEED)

    def small_run(where, algo, engine, sparse):
        sprov = SparseProvider.make(strain, seed=SEED)
        base = make_model(XMLMLPConfig(**small))
        model = TrainableModel(init=lambda generator: {k: v.clone() for k, v in p0.items()},
                               loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                               config=base.config)
        n_rep = algorithms.get(algo).resolve_n_replicas(4)
        cfg = ElasticConfig.from_bmax(32, algorithm=algo, n_replicas=n_rep, mega_batch=10)
        tr = ElasticTrainer(model, sprov, cfg, base_lr=0.5, seed=SEED, device=where,
                            engine=engine, sparse_grads=sparse)
        state, mlog = tr.run(2, test_batches=sprov.test_batches(stest, 32))
        return mlog.records, {k: v.cpu() for k, v in state.global_model.items()}

    slice_cases = [(a, "scan", True) for a in algorithms.available()] + [
        ("adaptive", "scan", False), ("sync", "scan", False), ("adaptive", "legacy_loop", True)]
    for algo, engine, sparse in slice_cases:
        label = f"{algo}/{engine}/{'sparse' if sparse else 'dense'}"
        (gpu_recs, gpu_model), (cpu_recs, cpu_model) = (
            small_run(where, algo, engine, sparse) for where in ("cuda", "cpu"))
        check_host_decisions(f"slice {label} card vs CPU", gpu_recs, cpu_recs)
        # tolerance: f32 sums in other orders (kernels, cuBLAS, and
        # index_add_, whose CUDA atomics add in a nondeterministic order)
        l_err = loss_err(gpu_recs, cpu_recs)
        m_err = model_err(gpu_model, cpu_model)
        print(f"slice {label} card vs cpu: host decisions identical over {len(gpu_recs)} "
              f"mega-batches; loss rel err {l_err:.3g} (tol 1e-4), global model "
              f"err {m_err:.3g} (tol 1e-4)")
        if len(gpu_recs) != 2 or l_err > 1e-4 or m_err > 1e-4:
            raise RuntimeError(f"slice {label}: card and CPU runs disagree beyond tolerance")

    # ---- 5. the main path at full width ---------------------------------
    test_batches = provider.test_batches(test, B_MAX, max_samples=2048)
    trainer = ElasticTrainer(
        make_model(XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)), provider,
        ElasticConfig.from_bmax(B_MAX, n_replicas=R, mega_batch=20),
        base_lr=0.05, seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"spmm": spmm_cuda, "weighted_merge": merge_cuda,
                "spmm_grad_w": spmm_grad_w_cuda, "sort_rows": sort_rows_cuda,
                "flash_attention": flash_attention_cuda,
                "ssd_scan": ssd_scan_cuda, "moe_ffn_gmm": moe_ffn_gmm_cuda}

    # the kernels with a tensor-core path count its launches apart (ssd_scan
    # has that path alone, so its check stands guard over a second path
    # coming back, as flash and gmm have one)
    tensor_core = ("flash_attention", "moe_ffn_gmm", "ssd_scan")

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for name in tensor_core:
            counters[name].tensor_core_launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    reset_counts()
    state, mlog = trainer.run(3, test_batches=test_batches, verbose=True)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prev = 0.0
    for rec in mlog.records:
        print(f"main mb={rec['megabatch']} u={rec['u']} b={rec['b']} n_rounds={rec['n_rounds']} "
              f"loss={rec['train_loss']:.6f} test_loss={rec['test_loss']:.6f} "
              f"acc={rec['accuracy']:.4f} seconds={rec['wall_clock'] - prev:.3f}")
        prev = rec["wall_clock"]
    print(f"main peak device memory: {peak_gb:.2f} GB")
    n_rounds = sum(r["n_rounds"] for r in mlog.records)
    want = {"spmm": n_rounds + len(mlog.records) * len(test_batches),
            "weighted_merge": 4 * len(mlog.records), "spmm_grad_w": 0, "sort_rows": 0,
            "flash_attention": 0, "ssd_scan": 0, "moe_ffn_gmm": 0}
    print(f"main launches: {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"main: launch counts {launches} != expected {want}")
    losses = [r[k] for r in mlog.records for k in ("train_loss", "test_loss")]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"main: non-finite loss {losses}")
    if not all(torch.isfinite(v).all().item() for v in state.global_model.values()):
        raise RuntimeError("main: the global model is not finite")

    # ---- where a warm mega-batch's device time goes ----------------------
    def profile_megabatch(label, trainer, state):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, info = trainer.run_megabatch(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per_kernel = sorted(prof.key_averages(), key=lambda e: -device_us(e))
        busy = sum(device_us(e) for e in per_kernel) / 1e6
        print(f"profile{label}: warm mega-batch ({info['n_rounds']} rounds) {wall:.3f} s "
              f"wall, device busy {busy:.3f} s ({busy / wall:.1%})")
        for e in per_kernel[:12]:
            print(f"profile{label}: {device_us(e) / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")
        return state

    profile_megabatch("", trainer, state)
    del trainer, state
    torch.cuda.empty_cache()

    # ---- 6. the dense-gradient path and the other algorithms, full width ----
    cfg_full = XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)
    p_full = init_params(cfg_full, torch.Generator(device=dev).manual_seed(SEED))

    def full_trainer(algo="adaptive", sparse=True):
        base = make_model(cfg_full)
        model = TrainableModel(init=lambda generator: {k: v.clone() for k, v in p_full.items()},
                               loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                               config=cfg_full)
        n_rep = algorithms.get(algo).resolve_n_replicas(R)
        return ElasticTrainer(
            model, SparseProvider.make(train, seed=SEED),
            ElasticConfig.from_bmax(B_MAX, algorithm=algo, n_replicas=n_rep, mega_batch=20),
            base_lr=0.05, seed=SEED, device="cuda", sparse_grads=sparse,
        )

    def megabatches(trainer, n):
        """n mega-batches from the trainer's initial state, each timed."""
        state, infos = trainer.init_state(), []
        for _ in range(n):
            t0 = time.perf_counter()
            state, info = trainer.run_megabatch(state)
            torch.cuda.synchronize()
            infos.append(dict(info, seconds=time.perf_counter() - t0))
        return state, infos

    sparse_state, sparse_infos = megabatches(full_trainer(), 2)
    del sparse_state
    torch.cuda.empty_cache()
    dense_trainer = full_trainer(sparse=False)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dense_state, dense_infos = megabatches(dense_trainer, 2)
    dense_launches = read_counts()
    dense_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for label, infos in (("sparse", sparse_infos), ("dense", dense_infos)):
        for i, info in enumerate(infos):
            print(f"paths adaptive/{label} mb={i + 1} u={info['u']} n_rounds={info['n_rounds']} "
                  f"loss={info['train_loss']:.6f} seconds={info['seconds']:.3f}")
    for a, b in zip(dense_infos, sparse_infos):
        for k in ("u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active"):
            if a[k] != b[k]:
                raise RuntimeError(f"paths: {k} differs dense vs sparse: {a[k]} vs {b[k]}")
    dense_err = max(abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
                    for a, b in zip(dense_infos, sparse_infos))
    dense_rounds = sum(info["n_rounds"] for info in dense_infos)
    print(f"paths dense vs sparse: host decisions identical, train loss rel err "
          f"{dense_err:.3g} (tol 1e-4); launches {dense_launches} over {dense_rounds} "
          f"rounds; peak device memory {dense_peak_gb:.2f} GB")
    if dense_err > 1e-4:
        raise RuntimeError("paths: dense and sparse losses disagree beyond tolerance")
    if not dense_launches["spmm_grad_w"] == dense_launches["sort_rows"] == dense_rounds:
        raise RuntimeError(f"paths: {dense_launches['spmm_grad_w']} spmm_grad_w and "
                           f"{dense_launches['sort_rows']} sort_rows launches for "
                           f"{dense_rounds} dense rounds")
    if not all(torch.isfinite(v).all().item() for v in dense_state.global_model.values()):
        raise RuntimeError("paths: the dense run's global model is not finite")
    profile_megabatch(" dense", dense_trainer, dense_state)
    del dense_trainer, dense_state
    torch.cuda.empty_cache()

    for algo in ("elastic", "sync", "crossbow", "delayed_sync", "single"):
        algo_state, (info,) = megabatches(full_trainer(algo), 1)
        finite = all(torch.isfinite(v).all().item() for v in algo_state.global_model.values())
        print(f"paths {algo}: R={info['n_replicas']} n_rounds={info['n_rounds']} "
              f"loss={info['train_loss']:.6f} seconds={info['seconds']:.3f} "
              f"finite model {finite}")
        if not (np.isfinite(info["train_loss"]) and finite):
            raise RuntimeError(f"paths {algo}: non-finite loss or global model")
        del algo_state
        torch.cuda.empty_cache()

    # ---- 7. serving on the card against the CPU, small width --------------
    kernel_flags = dict(use_flash_kernel=True, use_ssd_kernel=True, use_gmm_kernel=True)
    lm_names = ("flash_attention", "ssd_scan", "moe_ffn_gmm")

    def layer_launches(cfg):
        """Kernel launches one prefill needs: one per layer that reaches each."""
        pattern = MDL.layer_pattern(cfg)
        return {
            "flash_attention": sum(k == "attn" for k, _ in pattern) * cfg.use_flash_kernel,
            "ssd_scan": sum(k == "ssm" for k, _ in pattern) * cfg.use_ssd_kernel,
            "moe_ffn_gmm": sum(f == "moe" for _, f in pattern) * cfg.use_gmm_kernel,
        }

    def lm_counts():
        return {name: counters[name].launches for name in lm_names}

    serve_archs = ("llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b")
    for arch in serve_archs:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), **kernel_flags)
        p_cpu = MDL.init(cfg, torch.Generator().manual_seed(SEED))
        p_card = tree_map(lambda t: t.to(dev), p_cpu)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 64)))
        reset_counts()
        card = MDL.prefill(cfg, p_card, {"tokens": tokens.to(dev)})
        torch.cuda.synchronize()
        counts, want = lm_counts(), layer_launches(cfg)
        ssd_tc = counters["ssd_scan"].tensor_core_launches
        cpu = MDL.prefill(cfg, p_cpu, {"tokens": tokens})
        prefill_err = (card.cpu() - cpu).abs().max().item()
        # decode: four steps from the same prompt token, card against CPU
        caches = [MDL.init_cache(cfg, 2, 4, device=d) for d in (dev, "cpu")]
        decode_err = 0.0
        for i in range(4):
            step = tokens[:, i:i + 1]
            lc, caches[0] = MDL.decode_step(cfg, p_card, caches[0], step.to(dev))
            lp, caches[1] = MDL.decode_step(cfg, p_cpu, caches[1], step)
            decode_err = max(decode_err, (lc.cpu() - lp).abs().max().item())
        toks_card, _ = greedy_generate(cfg, p_card, tokens[:, :8].to(dev), 8)
        toks_cpu, _ = greedy_generate(cfg, p_cpu, tokens[:, :8], 8)
        same = torch.equal(toks_card.cpu(), toks_cpu)
        print(f"serve {cfg.name} card vs cpu: prefill logits max abs err {prefill_err:.3g}, "
              f"decode {decode_err:.3g} (tol 2e-3); greedy tokens identical {same}; "
              f"launches {counts} (expected {want}), ssd_scan on the tensor cores {ssd_tc}")
        if not (torch.allclose(card.cpu(), cpu, rtol=2e-3, atol=2e-3) and decode_err <= 2e-3):
            raise RuntimeError(f"serve {cfg.name}: card and CPU disagree beyond 2e-3")
        if not same or counts != want:
            raise RuntimeError(f"serve {cfg.name}: greedy tokens differ or launch counts wrong")
        if ssd_tc != counts["ssd_scan"]:
            raise RuntimeError(f"serve {cfg.name}: {counts['ssd_scan']} ssd_scan launches, "
                               f"{ssd_tc} on the tensor cores")

    # ---- 8. full-width prefill and greedy decoding, one card ---------------
    full_models = (("llama3.2-1b", 16), ("mamba2-780m", 48), ("moonshot-v1-16b-a3b", 4))

    lm_launches = dict.fromkeys(lm_names, 0)
    for arch, depth in full_models:
        base = dataclasses.replace(ARCHS[arch], n_layers=depth)
        cfg = dataclasses.replace(base, **kernel_flags)
        params = MDL.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
        sizes = []
        tree_map(lambda t: sizes.append(t.numel()), params)
        n_params = sum(sizes)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 4096))).to(dev)
        batch = {"tokens": tokens}
        prefill, prefill_plain = make_prefill_step(cfg), make_prefill_step(base)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        on = prefill(params, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts, want = lm_counts(), layer_launches(cfg)
        tc_counts = {name: counters[name].tensor_core_launches for name in tensor_core}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for name in lm_names:
            lm_launches[name] += counts[name]
        # the flags-off prefill four times: the first call meets cuBLAS's
        # and the allocator's first use of these shapes; the median of the
        # other three is the warm time
        off_s = []
        for _ in range(4):
            t0 = time.perf_counter()
            off = prefill_plain(params, batch)
            torch.cuda.synchronize()
            off_s.append(time.perf_counter() - t0)
        off_warm = sorted(off_s[1:])
        # bf16 rounds at other places on the two paths (the kernels keep f32
        # between their products; the plain einsums round each output to
        # bf16), compounded through every layer: hold the logits to a
        # relative L2 error of 5e-2
        rel = ((on - off).norm() / off.norm()).item()
        agree = (on.argmax(-1) == off.argmax(-1)).float().mean().item()
        print(f"prefill {arch} ({depth} layers, {n_params / 1e9:.3f} B params, bf16, B=2 S=4096): "
              f"flags on {first_s:.3f} s first, {warm_s:.3f} s warm; flags off {off_s[0]:.3f} s "
              f"first, {off_warm[1]:.3f} s warm (median of "
              f"{', '.join(f'{t:.3f}' for t in off_warm)}); "
              f"peak device memory {peak_gb:.2f} GB; launches {counts} (expected {want}), "
              f"on the tensor cores {tc_counts}; "
              f"logits on vs off rel L2 err {rel:.3g} (tol 5e-2), max abs err "
              f"{(on - off).abs().max().item():.3g}, argmax agreement {agree:.2f}")
        if counts != want:
            raise RuntimeError(f"prefill {arch}: launch counts {counts} != expected {want}")
        if any(tc_counts[name] != counts[name] for name in tensor_core):
            raise RuntimeError(f"prefill {arch}: launches {counts} not all on the tensor-core "
                               f"path {tc_counts}")
        if not (torch.isfinite(on).all() and rel <= 5e-2):
            raise RuntimeError(f"prefill {arch}: kernel and plain prefill disagree")
        profile_call(f"prefill {arch}", lambda: prefill(params, batch), top=8)
        profile_call(f"prefill flags off {arch}", lambda: prefill_plain(params, batch), top=4)
        # decode steps/s: the median of three greedy runs (the first also
        # meets the decode shapes' first use); then one run under the
        # profiler, whose 48 steps (32 prompt, 16 new) show the device's
        # busy share of a decode step
        runs = [greedy_generate(cfg, params, tokens[:, :32], 16) for _ in range(3)]
        toks, rates = runs[0][0], sorted(rate for _, rate in runs)
        print(f"decode {arch}: greedy 32-token prompt + 16 new tokens, B=2: "
              f"{rates[1]:.2f} decode steps/s (median of {', '.join(f'{r:.2f}' for r in rates)})")
        wall, busy, n_ops = profile_call(
            f"decode {arch}", lambda: greedy_generate(cfg, params, tokens[:, :32], 16), top=0)
        print(f"profile decode {arch}: a step of the 48 (32 prompt, 16 new) {wall / 48 * 1e3:.2f} "
              f"ms under the profiler ({1e3 / rates[1]:.2f} without it), device busy "
              f"{busy / 48 * 1e3:.2f} ms, {n_ops / 48:.0f} device ops")
        if toks.shape != (2, 16) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise RuntimeError(f"decode {arch}: bad tokens {toks}")
        del params, tokens, batch, on, off
        torch.cuda.empty_cache()

    # moonshot's router picks 6 of 64 experts a token and drops what
    # overflows an expert's capacity: a decision flipped by bf16 rounding for
    # a batch row's last token moves its logits far more than rounding alone.
    # Over eight token draws, both bf16 prefills (flags on and off) against
    # an f32 prefill of the same weights (flags off) show which of them the
    # on/off gap above comes from. Printed, not checked.
    base = dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"], n_layers=4)
    params = MDL.init(base, torch.Generator(device=dev).manual_seed(SEED))
    params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    steps = {"on": (make_prefill_step(dataclasses.replace(base, **kernel_flags)), params),
             "off": (make_prefill_step(base), params),
             "f32": (make_prefill_step(dataclasses.replace(base, dtype="float32")), params32)}
    for draw in range(8):
        tokens = torch.from_numpy(rng.integers(0, base.vocab_size, size=(2, 4096))).to(dev)
        logits = {name: step(p, {"tokens": tokens}).float() for name, (step, p) in steps.items()}
        rel = {pair: ((logits[pair[0]] - logits[pair[1]]).norm()
                      / logits[pair[1]].norm()).item()
               for pair in (("on", "off"), ("on", "f32"), ("off", "f32"))}
        print(f"routing moonshot draw {draw}: last-position logits rel L2 "
              + ", ".join(f"{a} vs {b} {v:.4g}" for (a, b), v in rel.items()))
    del params, params32, steps, logits
    torch.cuda.empty_cache()

    # ---- 9. LM training: Adaptive SGD on the decoder-only families ---------
    # weighted_merge's entry keeps phase 3's f32 w2 leaf at its top level
    # and nests the full-width LM barrier's numbers, per barrier
    barrier = lm_training_phase(dev, reset_counts, read_counts)
    results["weighted_merge"]["lm_barrier"] = barrier

    # ---- 10. elastic XML training at full width ---------------------------
    def model_from(params, cfg):
        base = make_model(cfg)
        return TrainableModel(init=lambda generator: {k: v.clone() for k, v in params.items()},
                              loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                              config=cfg)

    elastic = elastic_phase(
        reset_counts, read_counts,
        full_model=lambda: model_from(p_full, cfg_full),
        full_provider=lambda: SparseProvider.make(train, seed=SEED),
        test_batches=test_batches,
        small_model=lambda: model_from(p0, XMLMLPConfig(**small)),
        small_provider=lambda: SparseProvider.make(strain, seed=SEED),
        small_test=SparseProvider.make(strain, seed=SEED).test_batches(stest, 32),
    )

    # ---- 11. the overlap pipeline at full width ---------------------------
    overlap = overlap_phase(
        reset_counts, read_counts,
        full_model=lambda: model_from(p_full, cfg_full),
        full_provider=lambda: SparseProvider.make(train, seed=SEED),
        test_batches=test_batches, card=smi,
    )

    # ---- 12. the measured speed model, memory-lean merging, Nesterov and
    # clipping, libSVM ----
    measured = measured_phase(
        reset_counts, read_counts,
        full_model=lambda: model_from(p_full, cfg_full),
        full_provider=lambda: SparseProvider.make(train, seed=SEED),
        test_batches=test_batches,
        small_model=lambda: model_from(p0, XMLMLPConfig(**small)),
        small_provider=lambda: SparseProvider.make(strain, seed=SEED),
        small_test=SparseProvider.make(strain, seed=SEED).test_batches(stest, 32),
        dataset=ds, card=smi,
    )

    # ---- 13. the sharded placement: replicas split over a replica mesh ------
    sharded = sharded_phase(
        reset_counts, read_counts,
        full_model=lambda: model_from(p_full, cfg_full),
        full_provider=lambda: SparseProvider.make(train, seed=SEED),
        test_batches=test_batches,
        small_model=lambda: model_from(p0, XMLMLPConfig(**small)),
        small_provider=lambda: SparseProvider.make(strain, seed=SEED),
        small_test=SparseProvider.make(strain, seed=SEED).test_batches(stest, 32),
        card=smi,
    )
    # ---- 14. multi-process training: host span, the drill, device span ------
    torch.cuda.empty_cache()
    multiprocess = multiprocess_phase(smi, four_cards=torch.cuda.device_count() >= 2)
    multiprocess_paths = {
        "(a)": "xml_multiprocess_host", "(c) sync": "xml_multiprocess_device_sync",
        "(c) adaptive": "xml_multiprocess_device", "(d)": "xml_multiprocess_dense",
        "(a) own cards": "xml_multiprocess_host_own_cards",
        "(c) own cards sync": "xml_multiprocess_device_own_cards_sync",
        "(c) own cards adaptive": "xml_multiprocess_device_own_cards"}

    sharded_paths = {
        "(a)": "xml_sharded_one", "(b)": "xml_sharded", "(c) measured": "xml_sharded_measured",
        "(c) replay": "xml_sharded_replay", "(d)": "xml_sharded_elastic",
        "(e)": "xml_sharded_dense"}

    measured_paths = {
        "replay": "xml_measured_replay", "(b) overlap": "xml_measured_on",
        "(b) sequential": "xml_measured_off", "(c) lean": "xml_measured_lean",
        "(d) nesterov sparse": "xml_nesterov", "(d) nesterov dense": "xml_nesterov_dense",
        "(d) grad_clip sparse": "xml_grad_clip", "(d) grad_clip dense": "xml_grad_clip_dense"}

    sources = {
        "spmm": ("src/repro_torch/csrc/spmm.cu", "src/repro/kernels/spmm/spmm.py:74"),
        "weighted_merge": ("src/repro_torch/csrc/weighted_merge.cu",
                           "src/repro/kernels/weighted_merge/weighted_merge.py:60"),
        "spmm_grad_w": ("src/repro_torch/csrc/spmm_grad_w.cu",
                        "src/repro/kernels/spmm/spmm.py:147"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:102"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:81"),
        "moe_ffn_gmm": ("src/repro_torch/csrc/moe_gmm.cu",
                        "src/repro/kernels/moe_gmm/moe_gmm.py:59"),
    }
    # launches: spmm on the XML main path (phase 5) and the elastic runs
    # (phase 10 a, c), spmm_grad_w on the dense-gradient paths (phases 6,
    # 10 c), the LM kernels on the first flags-on prefill of each full-width
    # model (phase 8), weighted_merge on the XML main path (phase 5), in the
    # full-width LM training run (phase 9) and the elastic runs (phase 10);
    # spmm and weighted_merge in the overlap pipeline's runs, off and on
    # (phase 11)
    launches["spmm_grad_w"] = dense_launches["spmm_grad_w"]
    results["weighted_merge"]["launches_by_path"] = {
        "xml_main": launches["weighted_merge"], "lm_train": barrier["launches"],
        "xml_elastic": elastic["elastic"]["weighted_merge"],
        "xml_elastic_dense": elastic["dense"]["weighted_merge"],
        "xml_overlap_off": overlap["off"]["weighted_merge"],
        "xml_overlap_on": overlap["on"]["weighted_merge"]}
    results["spmm"]["launches_by_path"] = {
        "xml_main": launches["spmm"], "xml_elastic": elastic["elastic"]["spmm"],
        "xml_elastic_dense": elastic["dense"]["spmm"],
        "xml_overlap_off": overlap["off"]["spmm"], "xml_overlap_on": overlap["on"]["spmm"]}
    results["spmm_grad_w"]["launches_by_path"] = {
        "xml_dense": launches["spmm_grad_w"],
        "xml_elastic_dense": elastic["dense"]["spmm_grad_w"]}
    # phase 12's runs: the card's measured loop (a), full width with the
    # pipeline on and off (b) and without the global copies (c), Nesterov
    # and clipping (d); weighted_merge's no-momentum launches beside
    for label, path in measured_paths.items():
        counts = measured[label]
        for name in ("weighted_merge", "spmm"):
            results[name]["launches_by_path"][path] = counts[name]
        if counts["spmm_grad_w"]:
            results["spmm_grad_w"]["launches_by_path"][path] = counts["spmm_grad_w"]
    results["weighted_merge"]["no_momentum_launches_by_path"] = {
        measured_paths[label]: measured[label]["weighted_merge_no_momentum"]
        for label in ("(b) overlap", "(b) sequential", "(c) lean")}
    # phase 13's runs: every shard launches spmm each round and merges its
    # own replicas through weighted_merge's no-momentum branch
    for label, path in sharded_paths.items():
        counts = sharded[label]
        for name in ("weighted_merge", "spmm"):
            results[name]["launches_by_path"][path] = counts[name]
        if counts["spmm_grad_w"]:
            results["spmm_grad_w"]["launches_by_path"][path] = counts["spmm_grad_w"]
        results["weighted_merge"]["no_momentum_launches_by_path"][path] = counts[
            "weighted_merge_no_momentum"]
    # phase 14's fleets: each process's launches, summed over the fleet
    for label, counts in multiprocess.items():
        path = multiprocess_paths[label]
        for name in ("weighted_merge", "spmm"):
            results[name]["launches_by_path"][path] = counts[name]
        if counts["spmm_grad_w"]:
            results["spmm_grad_w"]["launches_by_path"][path] = counts["spmm_grad_w"]
        results["weighted_merge"]["no_momentum_launches_by_path"][path] = counts[
            "weighted_merge_no_momentum"]
    for name in ("weighted_merge", "spmm", "spmm_grad_w"):
        launches[name] = sum(results[name]["launches_by_path"].values())
    results["spmm_grad_w"]["sort"]["launches"] = (
        dense_launches["sort_rows"] + elastic["dense"]["sort_rows"]
        + sum(counts["sort_rows"] for counts in measured.values())
        + sum(counts["sort_rows"] for counts in sharded.values())
        + sum(counts["sort_rows"] for counts in multiprocess.values()))
    launches.update(lm_launches)
    kernels = []
    for name, r in results.items():
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=launches[name], kernel_ms=r["ms"], **r,
        ))
    print(f"seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase14-child":
        sys.exit(phase14_child(json.loads(sys.argv[2])))
    sys.exit(main(only_multiprocess=sys.argv[1:] == ["--only-multiprocess"]))
