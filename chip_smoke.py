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
   count the host's cost of issuing it. spmm_grad_w must also be
   deterministic (two launches bitwise equal), also on 48 small edge cases
   of its chunking held against an f64 scatter, and spmm's autograd
   Function (dW and d feat_val) must agree with autograd through the plain
   forward. The LM serving kernels likewise: flash_attention at the
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

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. The data are synthetic, drawn from
``SEED``; the weights are random.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

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


def device_breakdown(label: str, fn, reps: int = 20) -> None:
    """Print the device time per call of each kernel ``fn`` launches."""
    for name, ms, count in device_ms_by_kernel(fn, reps):
        print(f"{label}: {ms:.4f} ms/call x{count} {name[:90]}")


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


def main() -> int:
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
    from repro_torch.kernels.spmm.ops import spmm, spmm_cuda, spmm_grad_w_cuda
    from repro_torch.kernels.spmm.ref import spmm_grad_w_ref, spmm_ref
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

    def spmm_case(name, idx, val, mask, w, tol):
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
              f"{w_rows} distinct W rows")
        psw = (val * mask).to(w.dtype).reshape(-1, idx.shape[-1])
        wf = w.reshape(-1, h)
        return measure(
            f"spmm[{name}]",
            lambda: spmm_cuda(idx, val, mask, w),
            lambda: spmm_ref(idx, val, mask, w),
            lambda: torch.nn.functional.embedding_bag(
                flat_idx, wf, per_sample_weights=psw, mode="sum"),
            nbytes=w_rows * h * elt + n_slots * (4 + 4 + 1) + n_rows * h * elt,
            flops=2 * n_live * h, tol=tol,
        )

    results["spmm"] = spmm_case("f32 R=4", idx, val, mask, w32, F32_TOL)
    spmm_case("bf16 R=4", idx, val, mask, w32.to(torch.bfloat16), BF16_TOL)
    spmm_case("f32 2-D eval", idx[0], val[0], mask[0], w32[0].contiguous(), F32_TOL)
    odd = (idx[:, :8, :37].contiguous() % 5000, val[:, :8, :37].contiguous(),
           mask[:, :8, :37].contiguous())
    w_odd = w32[:, :5000, :100].contiguous()
    spmm_case("f32 H=100 K=37", *odd, w_odd, F32_TOL)
    spmm_case("bf16 H=100 K=37", *odd, w_odd.to(torch.bfloat16), BF16_TOL)

    def grad_w_case(name, idx, val, mask, dh, n_rows):
        """spmm_grad_w: kernel against plain, bitwise-repeatable, timed."""
        a = spmm_grad_w_cuda(idx, val, mask, dh, n_rows)
        b = spmm_grad_w_cuda(idx, val, mask, dh, n_rows)
        if not torch.equal(a, b):
            raise RuntimeError(f"spmm_grad_w[{name}]: two launches differ")
        del a, b
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
              f"largest run {int(torch.bincount(flat).max())} slots")
        device_breakdown(f"spmm_grad_w[{name}] by kernel",
                         lambda: spmm_grad_w_cuda(idx, val, mask, dh, n_rows))
        return measure(
            f"spmm_grad_w[{name}]",
            lambda: spmm_grad_w_cuda(idx, val, mask, dh, n_rows),
            lambda: spmm_grad_w_ref(idx, val, mask, dh, n_rows),
            lambda: torch.zeros((n_rep * n_rows, h), device=dev).index_add_(0, flat, prods),
            nbytes=n_rep * n_rows * h * 4 + idx.numel() * (4 + 4 + 1)
            + math.prod(lead) * idx.shape[-2] * h * 4,
            flops=2 * n_live * h, tol=F32_TOL,
        )

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
                    got = spmm_grad_w_cuda(e_idx, e_val, e_mask, e_dh, 300)
                    again = spmm_grad_w_cuda(e_idx, e_val, e_mask, e_dh, 300)
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
                    n_edge += 1
    print(f"spmm_grad_w: {n_edge} edge cases repeatable and as close to f64 as the plain version")

    dh = torch.randn((R, B_MAX, H), generator=gen, device=dev)
    results["spmm_grad_w"] = grad_w_case("f32 R=4", idx, val, mask, dh, NF)
    grad_w_case("f32 2-D", idx[0], val[0], mask[0], dh[0].contiguous(), NF)
    grad_w_case("f32 H=100 K=37", *odd, dh[:, :8, :100].contiguous(), 5000)

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
        for a, b in zip(gpu_recs, cpu_recs):
            for k in ("u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active"):
                if a[k] != b[k]:
                    raise RuntimeError(f"slice {label}: {k} differs card vs CPU: "
                                       f"{a[k]} vs {b[k]}")
        # tolerance: f32 sums in other orders (kernels, cuBLAS, and
        # index_add_, whose CUDA atomics add in a nondeterministic order)
        loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                       for a, b in zip(gpu_recs, cpu_recs) for k in ("train_loss", "test_loss"))
        model_err = max((gpu_model[k] - cpu_model[k]).abs().max().item() for k in gpu_model)
        print(f"slice {label} card vs cpu: host decisions identical over {len(gpu_recs)} "
              f"mega-batches; loss rel err {loss_err:.3g} (tol 1e-4), global model max abs "
              f"err {model_err:.3g} (tol 1e-4)")
        if len(gpu_recs) != 2 or loss_err > 1e-4 or model_err > 1e-4:
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
                "spmm_grad_w": spmm_grad_w_cuda, "flash_attention": flash_attention_cuda,
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
            "weighted_merge": 4 * len(mlog.records), "spmm_grad_w": 0,
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
    if dense_launches["spmm_grad_w"] != dense_rounds:
        raise RuntimeError(f"paths: {dense_launches['spmm_grad_w']} spmm_grad_w launches "
                           f"for {dense_rounds} dense rounds")
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

    def profile_call(label, fn, top):
        """One call of ``fn`` under the profiler: wall time, the device's
        busy time and op count, and the ``top`` kernels by device time."""
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
    # launches: spmm and weighted_merge on the main path (phase 5),
    # spmm_grad_w on the dense-gradient path (phase 6), the LM kernels on
    # the first flags-on prefill of each full-width model (phase 8)
    launches["spmm_grad_w"] = dense_launches["spmm_grad_w"]
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
    sys.exit(main())
