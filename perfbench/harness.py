"""One run of a cell: ``repro_torch``'s ``ElasticTrainer`` trains the
cell's model under its traffic mix, mega-batch by mega-batch as
``ElasticTrainer.run`` drives it, then the plain reference judges what it
produced.

Nothing here knows the model. The cell's model family
(``perfbench/families/<family>.py``, found by ``spec.family`` from the
configuration's ``"family"``) gives the data pools, the weights, the
program (``build``: the trainer, its provider and the test batches), the
samples of a fetch, the window's model FLOPs, the kernel launches its
rooflines read, and the reference that follows the program. This module
drives what every family shares: the trainer's mega-batches, Algorithm 2's
merge and its weights, the speed model's readings, the spans, the window
and the comparison (``reference/check.py``).

Set-up builds the trainer on the cell's cards from the seed (the data
pools, the weights on the first card) and drives it through the first
``FOLLOWED`` mega-batches with the window's own call
(``run_megabatch(state, prefetch=True)``); those build the kernels, warm
every shape, and are what the reference follows. One evaluation warms the
test set. The window then runs mega-batches in a closed loop, the next
issued as the last is collected, evaluating the global model every
``eval_every`` mega-batches (issued at a boundary, collected at the next,
as ``run`` does), until ``--seconds`` have passed; it ends at the last
completion. After it, the program's state is freed and the family's
reference trains the same first mega-batches from the same weights and
data on the first card, and replays the host decisions of every
mega-batch.

With ``trace`` on, the benchmark's spans wrap the calls into the trainer
(stage, dispatch, collect, merge, eval) and the merge's span closes with a
synchronise of every card; after the window, the profiler traces a stretch
of ``TRACE_MEGABATCHES`` more mega-batches, while wrappers record the
inputs of every ``weighted_merge`` launch and of the family's launches for
the rooflines. The window's own metrics are thus read without the
profiler's cost.
"""
from __future__ import annotations

import functools
import gc
import importlib
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from perfbench import spec, trace
from perfbench.reference import check

FOLLOWED = 3               # mega-batches the reference follows
TRACE_MEGABATCHES = 8      # mega-batches in the traced stretch
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What one run measured: the metric readers' input."""

    config: dict
    devices: tuple
    setup_s: float = float("nan")
    window_s: float = 0.0
    completions: list = field(default_factory=list)    # s from the window's start
    samples: int = 0
    model_flops: float = 0.0
    peak_bytes: Optional[int] = None
    staging: list = field(default_factory=list)        # staging_log entries
    merge_s: list = field(default_factory=list)        # traced merge spans
    shard_windows: list = field(default_factory=list)  # per-shard seconds a mega-batch
    profile: Optional[trace.Profile] = None

    @property
    def chips(self) -> int:
        return len(self.devices)

    @property
    def on_card(self) -> bool:
        return self.devices[0].type == "cuda"


class Recorder:
    """The benchmark's wrappers around the program, and what they saw."""

    def __init__(self, family):
        self.family = family
        self.readings = []     # the measured windows fed to the speed model, in order
        self.fetched = []      # (samples, work units) of every fetch, in order
        self.alphas = []       # each merge's weights, as the program applied them
        self.launches = {name: [] for name in family.launches()}
        self.launches["weighted_merge"] = []
        self.recording = False
        self._undo = []

    def patch(self, owner, name, make):
        old = getattr(owner, name)
        self._undo.append((owner, name, old, name in vars(owner)))
        setattr(owner, name, make(old))

    def restore(self):
        for owner, name, old, own in reversed(self._undo):
            if own:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo = []

    def watch(self, trainer, provider):
        """Record the data fetched, the merge weights and the measured
        windows (every run: the model FLOPs and the reference need them)."""
        samples, work_units = self.family.fetched_samples, provider.work_units

        def fetch(orig, staged):
            @functools.wraps(orig)
            def run(take, b_slots):
                out = orig(take, b_slots)
                payload, work = out if staged else (out, work_units(out))
                self.fetched.append((samples(payload, staged), int(work)))
                return out
            return run

        def merge(orig):
            def run(*args, **kw):
                out = orig(*args, **kw)
                self.alphas.append(np.asarray(out.alphas, np.float64).copy())
                return out
            return run

        self.patch(provider, "fetch_staged", lambda o: fetch(o, True))
        self.patch(provider, "fetch", lambda o: fetch(o, False))
        self.patch(trainer.algo, "merge", merge)
        speed = trainer.speed
        if hasattr(speed, "observe_shards"):
            def shards(orig):
                def run(windows, work, u=None, n_rounds=0):
                    self.readings.append(("shards", np.asarray(windows, np.float64).copy(),
                                          np.asarray(work).copy(), np.asarray(u).copy(),
                                          int(n_rounds)))
                    return orig(windows, work, u=u, n_rounds=n_rounds)
                return run

            def plan(orig):
                def run(work, seconds, u=None, n_rounds=0):
                    self.readings.append(("plan", float(seconds), np.asarray(work).copy(),
                                          np.asarray(u).copy(), int(n_rounds)))
                    return orig(work, seconds, u=u, n_rounds=n_rounds)
                return run

            self.patch(speed, "observe_shards", shards)
            self.patch(speed, "observe_plan", plan)

    def trace(self, trainer, devices, merge_s: list):
        """The traced run's spans, the merge's synchronised span, and the
        kernel launches' inputs while ``recording``: ``weighted_merge``'s,
        which every family merges by, and the family's ``launches``."""
        from repro_torch.kernels.weighted_merge import ops as merge_ops

        for name, attr in (("stage", "_stage_megabatch"), ("dispatch", "_dispatch_rounds"),
                           ("collect", "_finish_metrics")):
            if hasattr(trainer, attr):
                self.patch(trainer, attr, functools.partial(trace.spanned, name))

        def evaluate(orig):
            def run(*args, **kw):
                with torch.profiler.record_function("eval"):
                    collect = orig(*args, **kw)
                return trace.spanned("eval", collect)
            return run

        def merge(orig):
            def run(*args, **kw):
                t0 = time.perf_counter()
                with torch.profiler.record_function("merge"):
                    out = orig(*args, **kw)
                    synchronize(devices)
                merge_s.append(time.perf_counter() - t0)
                return out
            return run

        self.patch(trainer, "evaluate_async", evaluate)
        self.patch(trainer.algo, "merge", merge)

        def weighted_merge(orig):
            @functools.wraps(orig)
            def run(replicas, alphas, g=None, gp=None, gamma=0.0):
                if self.recording:
                    self.launches["weighted_merge"].append(
                        (*replicas.shape, replicas.element_size(), g is not None and gamma != 0.0))
                return orig(replicas, alphas, g, gp, gamma)
            return run

        self.patch(merge_ops, "merge_cuda", weighted_merge)
        for module, attr, wrap in self.family.launches().values():
            self.patch(importlib.import_module(module), attr,
                       functools.partial(wrap, rec=self))


def synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def decision(info: dict, state) -> dict:
    return dict(u=list(info["u"]), n_rounds=int(info["n_rounds"]),
                b=np.asarray(state.b, np.float64).tolist(),
                lr=np.asarray(state.lr, np.float64).tolist(), alphas=list(info["alphas"]))


def power_limit_w() -> Optional[float]:
    """The first card's power limit in W, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(cell: dict, seed: int, seconds: float, traced: bool, devices: tuple,
            t_start: float, fault=None) -> dict:
    """Run ``cell`` (``spec.cell``'s dict) and return the result line.

    ``fault(trainer)``, for the tests only, breaks the program underneath
    before set-up."""
    config, traffic, family = cell["config_data"], cell["traffic_data"], cell["family"]
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])
    run = Run(config=config, devices=devices)
    rec = Recorder(family)
    laps = [("imports", time.perf_counter())]
    train_pool, test_pool = family.pools(config, seed, devices[0])
    laps.append(("pools", time.perf_counter()))
    trainer, provider, test_batches = family.build(config, traffic, seed, devices, train_pool,
                                                   test_pool)
    rec.watch(trainer, provider)
    if fault is not None:
        fault(trainer)
    mega_samples = traffic["mega_batch"] * traffic["b_max"]
    try:
        # ---- set-up: the first mega-batches, which the reference follows ----
        state = trainer.init_state()
        laps.append(("program", time.perf_counter()))
        w0 = family.weights(config, seed, devices[0])
        followed = check.Trajectory()
        decisions = []
        for k in range(FOLLOWED):
            state, info = trainer.run_megabatch(state, prefetch=True)
            followed.losses.append(float(info["train_loss"]))
            decisions.append(decision(info, state))
            if k == 0:
                scale = check.weight_sum(rec.alphas[0])
                followed.update1 = check.leaf_norms(state.global_model, w0, scale)
                followed.update1_units = family.update_units(state.global_model, w0, scale)
            laps.append((f"mega-batch {k + 1}", time.perf_counter()))
        followed.change = check.leaf_norms(state.global_model, w0)
        del w0
        trainer.evaluate_async(state.global_model, test_batches)()
        n_readings = len(rec.readings)
        if traced:
            rec.trace(trainer, devices, run.merge_s)
        synchronize(devices)
        laps.append(("evaluation", time.perf_counter()))
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)

        losses, pending = [], None

        def megabatch():
            """One mega-batch as ``run`` drives it; the previous boundary's
            evaluation is collected behind it."""
            nonlocal state, pending
            state, info = trainer.run_megabatch(state, prefetch=True)
            if pending is not None:
                pending()
                pending = None
            losses.append(float(info["train_loss"]))
            decisions.append(decision(info, state))
            if len(decisions) % traffic["eval_every"] == 0:
                pending = trainer.evaluate_async(state.global_model, test_batches)

        # ---- the window ----
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        while True:
            megabatch()
            run.staging.append(dict(trainer.staging_log[-1]))
            run.completions.append(time.perf_counter() - t0)
            if run.completions[-1] >= seconds:
                break
        run.window_s = run.completions[-1]
        n_window = len(losses)
        if pending is not None:
            pending()
            pending = None
        synchronize(devices)
        if run.on_card:
            run.peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in devices)
        print("set-up: " + ", ".join(f"{name} {t - t_prev:.3f} s" for (_, t_prev), (name, t)
                                     in zip([("start", t_start)] + laps, laps))
              + f"; window {run.window_s:.3f} s, {n_window} mega-batches", file=sys.stderr)

        # ---- the traced stretch, after the window ----
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if run.on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                rec.recording = True
                with torch.profiler.record_function(trace.WINDOW_SPAN):
                    for _ in range(TRACE_MEGABATCHES):
                        megabatch()
                    if pending is not None:
                        pending()
                        pending = None
                    synchronize(devices)
                rec.recording = False

        # ---- what the window did ----
        run.samples = n_window * mega_samples
        lo, hi, at, work = FOLLOWED * mega_samples, (FOLLOWED + n_window) * mega_samples, 0, 0
        for n, units in rec.fetched:
            if lo <= at < hi:
                work += units
            at += n
        run.model_flops = family.model_flops(config, run.samples, work)
        run.shard_windows = [r[1] for r in rec.readings[n_readings:] if r[0] == "shards"]
        if traced:
            run.profile = trace.read(prof, devices, rec.launches)
        metrics = {}
        for m in spec.metrics(cell["name"], traced):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        rec.restore()
        trainer.close()
    readings = list(rec.readings)
    del trainer, state, provider, test_batches
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    # ---- the reference ----
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    n_shards = len(devices) if traffic["placement"] == "sharded" else 1
    ref = family.reference(family.weights(config, seed, devices[0]), train_pool, traffic, seed,
                           FOLLOWED, readings=readings, n_shards=n_shards)
    replay = family.replay(train_pool, traffic, seed, len(decisions), readings)
    values = check.readings(followed, ref)
    values["decisions"] = (check.decision_mismatches(decisions, replay)
                           + check.decision_mismatches(decisions[:FOLLOWED], ref.decisions,
                                                       keys=("alphas",)))
    ok, checks = check.judge(values, cell["limits"])
    failed = sum(not np.isfinite(x) for x in losses)

    device = {
        "platform": "gpu" if run.on_card else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if run.on_card else "cpu",
        "count": len(devices),
        "memory_peak_bytes": run.peak_bytes or 0,
        "power_limit_w": power_limit_w() if run.on_card else None,
    }
    result = {"correct": bool(ok and failed == 0), "attempted": len(losses),
              "failed": int(failed), "metrics": metrics, "device": device}
    if run.profile is not None:
        p = run.profile
        device["busy_s"] = float(np.mean([trace.device_busy_s(p, d.index or 0)
                                          for d in devices])) if run.on_card else 0.0
        device["window_s"] = (p.end_us - p.start_us) / 1e6
        result["breakdown"] = {"device_ops": trace.device_ops(p), "idle_gaps": trace.idle_gaps(p)}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
