"""Device heterogeneity model + virtual clock.

Copied from ``repro/core/heterogeneity.py`` (``SpeedModel``,
``MeasuredSpeedModel``, ``ShardWindowTimer``, ``CostModel``,
``VirtualClock``, with their membership and checkpoint methods); the
simulated speeds draw the same numpy random stream, and the measured
model, fed the same timer readings or shard windows, holds the same EMAs
and factors. ``ShardWindowTimer`` marks a shard's window with CUDA events
on the shard's stream where the reference reads the host clock in a
callback.

The paper identifies two sources of heterogeneity (§1):
  1. intrinsic device variance — identical GPUs differ by up to 32% on the
     same batch (paper Fig. 1);
  2. sparse-data variance — per-batch non-zero counts differ, and sparse
     kernels are cardinality-sensitive.

(1) is either simulated with a per-replica speed factor (``SpeedModel``) or
measured from real mega-batch times (``MeasuredSpeedModel``), and (2) is
taken directly from the data (total nnz of each batch).
``CostModel.step_time`` returns the virtual seconds a replica needs for a
batch; the scheduler's discrete-event simulation runs on this clock. The
algorithm only ever sees *relative speeds*, exactly as in the paper.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class SpeedModel:
    """Per-replica multiplicative slowdown factors.

    ``max_gap`` = 0.32 reproduces the paper's observed fastest/slowest gap.
    ``jitter`` adds per-step lognormal noise (clock/memory-latency
    oscillation); ``drift`` lets factors wander over time so the adaptive
    algorithm has something to track.
    """

    n_replicas: int
    max_gap: float = 0.32
    jitter: float = 0.03
    drift: float = 0.0
    seed: int = 0
    factors: np.ndarray = field(init=False)
    _rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.n_replicas == 1:
            self.factors = np.ones(1)
        else:
            # evenly spread in [1, 1+max_gap], randomly permuted
            base = 1.0 + np.linspace(0.0, self.max_gap, self.n_replicas)
            self.factors = self._rng.permutation(base)

    def step_factor(self, i: int) -> float:
        f = self.factors[i]
        if self.jitter > 0:
            f *= float(self._rng.lognormal(0.0, self.jitter))
        return float(f)

    def advance(self) -> None:
        """Random-walk drift of the underlying factors (optional); the
        fastest replica stays pinned at 1.0 and the gap stays within twice
        ``max_gap``."""
        if self.drift > 0:
            self.factors *= np.exp(self._rng.normal(0.0, self.drift, self.n_replicas))
            self.factors /= self.factors.min()  # fastest pinned to 1.0
            self.factors = np.clip(self.factors, 1.0, 1.0 + 2 * self.max_gap)

    def resize(self, new_R: int) -> None:
        """Membership change: survivors keep their current factors, joiners
        start at the homogeneous prior (1.0). After a shrink the surviving
        factors are renormalized so the fastest is again 1.0."""
        keep = min(self.n_replicas, new_R)
        factors = np.ones(new_R)
        factors[:keep] = self.factors[:keep]
        self.factors = factors / factors.min()
        self.n_replicas = new_R

    def permute(self, perm) -> None:
        """Reorder replica slots (targeted eviction moves the evicted slot
        to the tail before a shrink). Pure relabeling: no renormalization."""
        self.factors = self.factors[np.asarray(perm, np.int64)]

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """Factor arrays (``arrays`` -> tensor store) plus the jitter/drift
        RNG (``meta`` -> JSON metadata), so a restored run replays the same
        simulated heterogeneity."""
        return {
            "arrays": {"factors": self.factors.copy()},
            "meta": {"kind": "simulated",
                     "rng": self._rng.bit_generator.state},
        }

    def load_state_dict(self, sd: dict) -> None:
        self.factors = np.asarray(sd["arrays"]["factors"], np.float64).copy()
        self.n_replicas = len(self.factors)
        self._rng.bit_generator.state = sd["meta"]["rng"]


@dataclass
class MeasuredSpeedModel:
    """Relative replica speeds estimated from *measured* round times.

    The simulated ``SpeedModel`` invents heterogeneity; this model closes
    the paper's feedback loop (§3.1) instead: the trainer reports how long
    each replica's share of a mega-batch actually took
    (``observe(replica, work_units, seconds)``), the model keeps an
    exponential moving average of seconds-per-work-unit per replica, and
    ``step_factor`` exposes the *relative* speeds (slowest/fastest ratios,
    fastest normalized to 1.0) — the only thing the scheduler's virtual
    clock ever consumes, exactly as in the paper.

    Measurement sources:
      * the trainer's window — the host clock from just before a
        mega-batch's rounds are issued (the sequential path: before its
        pack and upload) to just after their metrics are collected,
        attributed per replica by its scheduled share of the window
        (``observe_plan``);
      * per-shard windows (``observe_shards``), for a placement whose
        shards time their own programs;
      * tests — ``timer`` is injectable, so a fake clock drives the model
        deterministically (no sleeping in unit tests).

    Until a replica has ``min_obs`` observations its factor stays at the
    prior (1.0 = homogeneous), so cold-start planning is unbiased, and the
    first ``warmup_windows`` mega-batch windows are discarded entirely —
    they carry one-time costs (kernel builds, first allocations), which
    would otherwise be charged only to the replicas that happened to be
    live. The interface is duck-compatible with ``SpeedModel``
    (``step_factor`` / ``advance`` / ``factors``): ``CostModel`` cannot tell
    them apart.
    """

    n_replicas: int
    ema: float = 0.5             # weight of the newest observation
    min_obs: int = 1             # observations before the prior is replaced
    warmup_windows: int = 1      # leading observe_plan windows to discard
    timer: Callable[[], float] = time.perf_counter  # injectable for tests
    t_per_work: np.ndarray = field(init=False)      # EMA seconds/work-unit
    n_obs: np.ndarray = field(init=False)
    n_windows: int = field(init=False, default=0)
    skip_windows: int = field(init=False, default=0)  # see discard_next_window
    _factors: np.ndarray = field(init=False, default=None)  # cache; see factors

    def __post_init__(self):
        self.t_per_work = np.full(self.n_replicas, np.nan)
        self.n_obs = np.zeros(self.n_replicas, np.int64)

    # ---- measurement ingestion ----
    def begin(self) -> float:
        """Start a measurement window (returns a timer handle)."""
        return self.timer()

    def elapsed(self, handle: float) -> float:
        return self.timer() - handle

    def observe(self, replica: int, work_units: float, seconds: float) -> None:
        """One measured (replica, work, wall-seconds) sample."""
        if work_units <= 0 or seconds <= 0:
            return
        tpw = seconds / float(work_units)
        if self.n_obs[replica] == 0:
            self.t_per_work[replica] = tpw
        else:
            self.t_per_work[replica] = (
                self.ema * tpw + (1.0 - self.ema) * self.t_per_work[replica]
            )
        self.n_obs[replica] += 1
        self._factors = None  # invalidate the cached relative factors

    def observe_plan(self, per_replica_work: np.ndarray, seconds: float,
                     u: np.ndarray | None = None, n_rounds: int = 0) -> None:
        """Attribute one mega-batch's wall time across its replicas.

        With the plan's update counts ``u`` (and its round count), each
        replica is charged only its *scheduled share* of the window,
        ``seconds * u_i / n_rounds`` — a replica live in every round owns
        the whole window, one masked out of half the rounds owns half.
        Charging everyone the full window would measure planner asymmetry
        (who got the leftover dispatch) as a speed difference and feed it
        back into the next plan, a self-amplifying loop with no hardware
        cause. With the share normalization, equal per-round throughput
        measures equal speed regardless of how many rounds the planner
        handed out. Without ``u`` the whole window is charged.

        The residual limit is physical, not statistical: lockstep rounds
        end at a global barrier, so a genuinely slow device stretches every
        live round for everyone and this coarse attribution converges
        toward homogeneous factors. True per-replica contrast needs
        per-shard windows (``observe_shards``).

        Degenerate plans (``n_rounds == 0`` or an all-zero ``u``) carry no
        attributable signal: the window is still counted (so the warmup
        discard stays aligned with the trainer's mega-batch sequence) but
        no EMA is charged.
        """
        if not self._admit_window():
            return
        share = self._scheduled_share(u, n_rounds)
        if share is None:
            return  # window counted above; nothing attributable
        work = np.asarray(per_replica_work, np.float64)
        for i, w in enumerate(work):
            if w > 0 and share[i] > 0:
                self.observe(i, w, seconds * share[i])

    def observe_shards(self, windows: np.ndarray,
                       per_replica_work: np.ndarray,
                       u: np.ndarray | None = None,
                       n_rounds: int = 0) -> None:
        """Attribute *per-shard* measured windows across their replicas.

        ``windows`` is one wall-clock window per shard, each bracketing
        that shard's own mega-batch program. Unlike ``observe_plan``'s
        single host window — which a global barrier stretches identically
        for everyone — each shard's window reflects that shard's own device
        time, so a slow shard shows up as a real cross-shard contrast.
        Within a shard the window is split by scheduled share exactly like
        ``observe_plan``.

        Shares the warmup / skip-window gating with ``observe_plan``: a
        mega-batch consumes exactly one window regardless of which
        attribution path it takes. Windows whose shard count does not divide
        the population (stale windows across a resize) charge nothing.
        """
        if not self._admit_window():
            return
        windows = np.asarray(windows, np.float64)
        n_shards = len(windows)
        if n_shards == 0 or self.n_replicas % n_shards != 0:
            return
        share = self._scheduled_share(u, n_rounds)
        if share is None:
            return
        rps = self.n_replicas // n_shards
        work = np.asarray(per_replica_work, np.float64)
        for i, w in enumerate(work):
            seconds = float(windows[i // rps]) * share[i]
            if w > 0 and seconds > 0:
                self.observe(i, w, seconds)

    def _admit_window(self) -> bool:
        """Count one measurement window; False while warmup/skip gating
        discards it (one-time costs must never reach the EMAs)."""
        self.n_windows += 1
        if self.n_windows <= self.warmup_windows:
            return False
        if self.skip_windows > 0:       # e.g. first window after a resize
            self.skip_windows -= 1
            return False
        return True

    def _scheduled_share(self, u, n_rounds: int) -> np.ndarray | None:
        """Per-replica scheduled share of a window; None if unattributable."""
        if u is None:
            return np.ones(self.n_replicas)
        u_arr = np.asarray(u, np.float64)
        if n_rounds <= 0 or not np.any(u_arr > 0):
            return None
        return u_arr / float(n_rounds)

    # ---- the SpeedModel interface the scheduler consumes ----
    @property
    def factors(self) -> np.ndarray:
        """Relative slowdown factors, fastest replica == 1.0.

        Cached between observations: the planner calls ``step_factor`` once
        per dispatch, while the underlying EMAs only change at ``observe``
        time.
        """
        if self._factors is not None:
            return self._factors
        measured = self.n_obs >= self.min_obs
        if not measured.any():
            out = np.ones(self.n_replicas)
        else:
            fastest = np.nanmin(np.where(measured, self.t_per_work, np.nan))
            out = np.ones(self.n_replicas)
            out[measured] = self.t_per_work[measured] / fastest
        self._factors = out
        return out

    def step_factor(self, i: int) -> float:
        # no synthetic jitter: the EMA already carries the real noise
        return float(self.factors[i])

    def advance(self) -> None:
        """Drift is tracked by the EMA itself; nothing to simulate."""

    def discard_next_window(self) -> None:
        """Mark the next window unattributable (still counted in
        ``n_windows``, charged to no EMA). Used after events that put
        non-round work inside the timed window (a resize, a restore), whose
        seconds at EMA weight would corrupt every live replica's factor
        exactly like the cold-start warmup would."""
        self.skip_windows += 1

    def resize(self, new_R: int) -> None:
        """Membership change: surviving replicas keep their measured EMAs
        and observation counts; joiners start unmeasured (NaN
        seconds-per-work, zero observations), so their factor is the
        homogeneous prior until ``min_obs`` real windows land. The warmup
        counter is *not* reset (cold-start warmup happened once), but the
        first post-resize window is discarded."""
        keep = min(self.n_replicas, new_R)
        t_per_work = np.full(new_R, np.nan)
        n_obs = np.zeros(new_R, np.int64)
        t_per_work[:keep] = self.t_per_work[:keep]
        n_obs[:keep] = self.n_obs[:keep]
        self.t_per_work, self.n_obs = t_per_work, n_obs
        self.n_replicas = new_R
        self._factors = None
        self.discard_next_window()

    def permute(self, perm) -> None:
        """Reorder replica slots (targeted eviction): the EMAs and
        observation counts follow their replica."""
        perm = np.asarray(perm, np.int64)
        self.t_per_work = self.t_per_work[perm]
        self.n_obs = self.n_obs[perm]
        self._factors = None

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """EMAs, observation counts and the warmup/skip counters — enough
        that a restored run keeps attributing windows exactly where the
        killed run left off (the trainer additionally discards the first
        post-restore window)."""
        return {
            "arrays": {"t_per_work": self.t_per_work.copy(),
                       "n_obs": self.n_obs.copy()},
            "meta": {"kind": "measured", "n_windows": int(self.n_windows),
                     "skip_windows": int(self.skip_windows)},
        }

    def load_state_dict(self, sd: dict) -> None:
        self.t_per_work = np.asarray(sd["arrays"]["t_per_work"],
                                     np.float64).copy()
        self.n_obs = np.asarray(sd["arrays"]["n_obs"], np.int64).copy()
        self.n_replicas = len(self.n_obs)
        self.n_windows = int(sd["meta"]["n_windows"])
        self.skip_windows = int(sd["meta"]["skip_windows"])
        self._factors = None


class ShardWindowTimer:
    """Per-shard windows of one mega-batch: the signal
    ``MeasuredSpeedModel.observe_shards`` takes.

    Under the sharded placement each shard's worker calls
    :meth:`mark_start` before it issues its rounds and :meth:`mark_end`
    after the last of them (before the metric sums are reduced over the
    shards, which would wait for the slowest); the difference is that
    shard's own window. On the card (a stream given and no ``timer``
    injected) a marker is a CUDA event recorded on the shard's stream, and
    :meth:`take` waits for the end events and returns their device
    seconds. Otherwise a marker reads ``timer`` (``time.perf_counter`` when
    none is given), as the reference's callbacks read the host clock.

    The shards mark from their own threads, so the markers and ``take``'s
    swap are lock-guarded, and the first start marker of a shard opens its
    window. ``take`` returns ``None`` whenever the set is incomplete or a
    window is not positive; the trainer then falls back to the whole
    window.
    """

    def __init__(self, timer: Optional[Callable[[], float]] = None):
        self.timer = timer
        self._lock = threading.Lock()
        self._n = 0
        self._t0: dict = {}
        self._t1: dict = {}

    def reset(self, n_shards: int) -> None:
        """Open a measurement window expecting markers from n_shards."""
        with self._lock:
            self._n = int(n_shards)
            self._t0 = {}
            self._t1 = {}

    def _mark(self, stream):
        if stream is not None and self.timer is None:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            return event
        return (self.timer or time.perf_counter)()

    def mark_start(self, shard, stream=None) -> None:
        s = int(shard)
        with self._lock:
            if s not in self._t0:   # the first marker opens the shard's window
                self._t0[s] = self._mark(stream)

    def mark_end(self, shard, stream=None) -> None:
        s = int(shard)
        with self._lock:
            self._t1[s] = self._mark(stream)    # the last marker closes it

    def take(self) -> np.ndarray | None:
        """(n_shards,) window seconds, or None if any marker is missing."""
        with self._lock:
            n, t0, t1 = self._n, self._t0, self._t1
            self._n, self._t0, self._t1 = 0, {}, {}
        if n == 0 or set(t0) != set(range(n)) or set(t1) != set(range(n)):
            return None
        w = []
        for s in range(n):
            start, end = t0[s], t1[s]
            if hasattr(start, "elapsed_time"):   # CUDA events
                end.synchronize()
                w.append(start.elapsed_time(end) / 1e3)
            else:
                w.append(end - start)
        w = np.array(w, np.float64)
        return w if np.all(w > 0) else None


@dataclass
class CostModel:
    """Virtual step time of one batch on one replica.

    time = speed_i * (overhead + work_cost * work_units)

    ``work_units`` is the total nnz of a sparse batch (cuSPARSE-like
    cardinality sensitivity). ``speed`` is either the simulated
    ``SpeedModel`` or a ``MeasuredSpeedModel``: the cost model only
    consumes the shared ``step_factor`` interface.
    """

    speed: SpeedModel | MeasuredSpeedModel
    overhead: float = 1.0e-3
    work_cost: float = 2.0e-6

    def step_time(self, replica: int, work_units: int) -> float:
        return self.speed.step_factor(replica) * (
            self.overhead + self.work_cost * float(work_units)
        )


@dataclass
class VirtualClock:
    """Per-replica virtual timelines; merge barrier = max over replicas."""

    n_replicas: int
    t: np.ndarray = field(init=False)

    def __post_init__(self):
        self.t = np.zeros(self.n_replicas)

    def earliest(self) -> int:
        return int(np.argmin(self.t))

    def resize(self, new_R: int) -> None:
        """Membership change: survivors keep their virtual timelines;
        joiners enter at the latest survivor time (between mega-batches all
        clocks sit at the barrier, so this is the barrier time)."""
        keep = min(self.n_replicas, new_R)
        t = np.full(new_R, float(self.t[:keep].max()) if keep else 0.0)
        t[:keep] = self.t[:keep]
        self.t = t
        self.n_replicas = new_R

    def permute(self, perm) -> None:
        """Reorder replica timelines (targeted eviction)."""
        self.t = self.t[np.asarray(perm, np.int64)]

    def advance(self, i: int, dt: float) -> None:
        self.t[i] += dt

    def barrier(self) -> float:
        """All replicas wait for the slowest (synchronization point)."""
        m = float(self.t.max())
        self.t[:] = m
        return m
