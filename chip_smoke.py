#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them.
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) and loads the library.
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (plus ragged shapes and bf16), with
   the reference's kernel tolerances; times kernel, plain version and one
   PyTorch library call: device time from the profiler's trace, and
   CUDA events around each call (median of 20 after warm-up), which also
   count the host's cost of issuing it.
4. slice   — the port's trainer on the card against the same trainer on the
   CPU (plain versions), same weights and data, small width: the host
   decisions must be identical and the losses agree within tolerance.
5. main    — the paper's experiment at Amazon-670K width (135,909 features,
   670,091 classes, hidden 128): Adaptive SGD, R = 4, b_max 256, 3
   mega-batches of 20 batches, with evaluation, through
   ``ElasticTrainer.run``. Checks finite losses and model, and that every
   kernel launch count is what the run needed. One more mega-batch runs
   under the profiler: the device busy share and the top kernels.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. The data are synthetic, drawn from
``SEED``; the weights are random.
"""
from __future__ import annotations

import json
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
F32_TOL = dict(rtol=2e-4, atol=2e-5)   # the reference's kernel tolerances
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # (tests/test_kernels.py)


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


def check_close(what: str, got, want, tol: dict) -> float:
    """Max |got - want| in f32; raises if outside ``tol``."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, **tol):
        raise RuntimeError(f"{what}: kernel disagrees with its plain version "
                           f"(max abs err {err:.3g}, tolerance {tol})")
    return err


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
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.providers import SparseProvider
    from repro_torch.data.sparse import SparseDataset, train_test_split
    from repro_torch.data.xml_synth import AMAZON_670K, make_xml_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmm.ops import spmm_cuda
    from repro_torch.kernels.spmm.ref import spmm_ref
    from repro_torch.kernels.weighted_merge.ops import merge_cuda
    from repro_torch.kernels.weighted_merge.ref import weighted_merge_ref
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

    def measure(label, kernel_fn, plain_fn, library_fn, nbytes, flops, tol):
        """Check the kernel against its plain version, then time all three."""
        err = check_close(label, kernel_fn(), plain_fn(), tol)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
        r = dict(max_abs_err=err, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        # ms: device time from the profiler trace (the CUDA-event time
        # where the trace shows none); call_ms: CUDA events around each
        # call, which also count the host's cost of issuing it
        for name, fn in (("", kernel_fn), ("plain_", plain_fn), ("library_", library_fn)):
            r[name + "call_ms"] = cuda_ms(fn)
            dev_t = device_ms(fn)
            r[name + "ms"] = dev_t if dev_t is not None else r[name + "call_ms"]
            r[name + "timing"] = "profiler" if dev_t is not None else "events"
        shown = " ".join(f"{k} {v:.4g}" for k, v in r.items() if isinstance(v, float))
        print(f"kernel {label}: {shown} ({nbytes / 1e6:.1f} MB)")
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
    del w32, w_odd

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

    # ---- 4. the slice on the card against the CPU, small width -------------
    small = dict(n_features=512, n_classes=128, hidden=32)
    p0 = init_params(XMLMLPConfig(**small), torch.Generator().manual_seed(SEED))
    records = {}
    for where in ("cuda", "cpu"):
        sds = make_xml_dataset(n_samples=1024, n_features=512, n_classes=128, avg_nnz=16,
                               seed=SEED)
        strain, stest = train_test_split(sds, 0.2, seed=SEED)
        sprov = SparseProvider.make(strain, seed=SEED)
        base = make_model(XMLMLPConfig(**small))
        model = TrainableModel(init=lambda generator: {k: v.clone() for k, v in p0.items()},
                               loss_fn=base.loss_fn, sparse_grad_fn=base.sparse_grad_fn,
                               config=base.config)
        tr = ElasticTrainer(model, sprov, ElasticConfig.from_bmax(32, n_replicas=4,
                                                                  mega_batch=10),
                            base_lr=0.5, seed=SEED, device=where)
        state, mlog = tr.run(2, test_batches=sprov.test_batches(stest, 32))
        records[where] = (mlog.records, {k: v.cpu() for k, v in state.global_model.items()})
    (gpu_recs, gpu_model), (cpu_recs, cpu_model) = records["cuda"], records["cpu"]
    for a, b in zip(gpu_recs, cpu_recs):
        for k in ("u", "b", "lr", "alphas", "n_rounds", "virtual_time"):
            if a[k] != b[k]:
                raise RuntimeError(f"slice: {k} differs card vs CPU: {a[k]} vs {b[k]}")
    # tolerance: f32 sums in other orders (kernel, cuBLAS, and index_add_,
    # whose CUDA atomics add in a nondeterministic order)
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(gpu_recs, cpu_recs)
                   for k in ("train_loss", "test_loss"))
    model_err = max((gpu_model[k] - cpu_model[k]).abs().max().item() for k in gpu_model)
    print(f"slice card vs cpu: u/b/lr/alphas identical over {len(gpu_recs)} mega-batches; "
          f"loss rel err {loss_err:.3g} (tol 1e-4), global model max abs err "
          f"{model_err:.3g} (tol 1e-4)")
    if loss_err > 1e-4 or model_err > 1e-4:
        raise RuntimeError("slice: card and CPU runs disagree beyond tolerance")

    # ---- 5. the main path at full width ---------------------------------
    test_batches = provider.test_batches(test, B_MAX, max_samples=2048)
    trainer = ElasticTrainer(
        make_model(XMLMLPConfig(n_features=NF, n_classes=NC, hidden=H)), provider,
        ElasticConfig.from_bmax(B_MAX, n_replicas=R, mega_batch=20),
        base_lr=0.05, seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm_cuda.launches = 0
    merge_cuda.launches = 0
    state, mlog = trainer.run(3, test_batches=test_batches, verbose=True)
    torch.cuda.synchronize()
    launches = {"spmm": spmm_cuda.launches, "weighted_merge": merge_cuda.launches}
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
            "weighted_merge": 4 * len(mlog.records)}
    print(f"main launches: {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"main: launch counts {launches} != expected {want}")
    losses = [r[k] for r in mlog.records for k in ("train_loss", "test_loss")]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"main: non-finite loss {losses}")
    if not all(torch.isfinite(v).all().item() for v in state.global_model.values()):
        raise RuntimeError("main: the global model is not finite")

    # ---- where a warm mega-batch's device time goes ----------------------
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, info = trainer.run_megabatch(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(prof.key_averages(), key=lambda e: -device_us(e))
    busy = sum(device_us(e) for e in per_kernel) / 1e6
    print(f"profile: warm mega-batch ({info['n_rounds']} rounds) {wall:.3f} s wall, "
          f"device busy {busy:.3f} s ({busy / wall:.1%})")
    for e in per_kernel[:12]:
        print(f"profile: {device_us(e) / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")

    sources = {
        "spmm": ("src/repro_torch/csrc/spmm.cu", "src/repro/kernels/spmm/spmm.py:74"),
        "weighted_merge": ("src/repro_torch/csrc/weighted_merge.cu",
                           "src/repro/kernels/weighted_merge/weighted_merge.py:60"),
    }
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
