"""The host decisions of Adaptive SGD, worked out again from the inputs.

A frozen copy of what ``repro_torch`` decides on the host, in plain numpy,
with no import of the program: the shuffled sample stream and the padding
rule of ``data/batcher.py``, the speed models, cost model and virtual
clock of ``core/heterogeneity.py``, the availability-driven dispatch of
``core/scheduler.py`` (``plan_megabatch``), and Algorithms 1 and 2's host
halves of ``core/adaptive_sgd.py`` (``batch_size_scaling``,
``merge_weights``, ``apply_perturbation``) with the defaults of
``configs/base.py`` ``ElasticConfig.from_bmax``. :class:`Replay` steps them
in the order the trainer's overlap pipeline does, so the same inputs (the
pool, the seed and, under a measured speed model, the windows the card
measured) give the same update counts, batch sizes, learning rates and
merge weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MERGE_COST = 5e-3      # virtual seconds charged per merge (core/trainer.py)
OVERHEAD, WORK_COST = 1.0e-3, 2.0e-6   # CostModel: speed * (overhead + cost * nnz)
PERT_THR, DELTA, GAMMA = 0.10, 0.10, 0.90   # Algorithm 2


def pad_pow2(x: int) -> int:
    p = 8
    while p < x:
        p *= 2
    return p


def padding(indptr: np.ndarray, label_ptr: np.ndarray) -> tuple[int, int]:
    """(nnz slots, label slots) of a padded batch: the 98th percentile of
    the pool's nnz + 1 rounded up to a power of two (at least 8), and its
    label count's 98th percentile + 1."""
    k = pad_pow2(int(np.quantile(np.diff(indptr), 0.98)) + 1)
    lab = max(1, int(np.quantile(np.diff(label_ptr), 0.98)) + 1)
    return k, lab


class SampleStream:
    """Infinite shuffled cursor over sample ids, reshuffled every epoch."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(n)
        self.pos = 0

    def take(self, k: int) -> np.ndarray:
        out = []
        while k > 0:
            step = min(k, self.n - self.pos)
            out.append(self.order[self.pos:self.pos + step])
            self.pos += step
            k -= step
            if self.pos == self.n:
                self.order = self.rng.permutation(self.n)
                self.pos = 0
        return np.concatenate(out)


class SimulatedSpeed:
    """Per-replica factors evenly spread over [1, 1 + max_gap], permuted,
    with lognormal(0, 0.03) jitter drawn at every dispatch."""

    def __init__(self, n: int, max_gap: float, seed: int):
        self.rng = np.random.default_rng(seed)
        self.factors = (np.ones(1) if n == 1
                        else self.rng.permutation(1.0 + np.linspace(0.0, max_gap, n)))

    def step_factor(self, i: int) -> float:
        return float(self.factors[i] * float(self.rng.lognormal(0.0, 0.03)))


class MeasuredSpeed:
    """Relative speeds from measured windows: an EMA (weight 0.5) of
    seconds per work unit a replica, the first window discarded, each
    window split over the replicas by their scheduled share of the rounds;
    the fastest measured replica is 1.0 and unmeasured ones stay at 1.0."""

    def __init__(self, n: int):
        self.n = n
        self.t_per_work = np.full(n, np.nan)
        self.n_obs = np.zeros(n, np.int64)
        self.n_windows = 0

    def step_factor(self, i: int) -> float:
        measured = self.n_obs >= 1
        if not measured[i]:
            return 1.0
        return float(self.t_per_work[i] / np.nanmin(np.where(measured, self.t_per_work, np.nan)))

    def _charge(self, i: int, work: float, seconds: float) -> None:
        if work <= 0 or seconds <= 0:
            return
        tpw = seconds / float(work)
        self.t_per_work[i] = tpw if self.n_obs[i] == 0 else 0.5 * tpw + 0.5 * self.t_per_work[i]
        self.n_obs[i] += 1

    def observe(self, reading) -> None:
        """``reading``: ("shards", windows, work, u, n_rounds) or
        ("plan", seconds, work, u, n_rounds), as the trainer fed it."""
        kind, value, work, u, n_rounds = reading
        self.n_windows += 1
        if self.n_windows <= 1:
            return
        u = np.asarray(u, np.float64)
        if n_rounds <= 0 or not np.any(u > 0):
            return
        share = u / float(n_rounds)
        work = np.asarray(work, np.float64)
        if kind == "shards":
            windows = np.asarray(value, np.float64)
            if len(windows) == 0 or self.n % len(windows):
                return
            rps = self.n // len(windows)
            for i, w in enumerate(work):
                self._charge(i, w, float(windows[i // rps]) * share[i])
        else:
            for i, w in enumerate(work):
                if w > 0 and share[i] > 0:
                    self._charge(i, w, value * share[i])


@dataclass
class Plan:
    u: np.ndarray              # (R,) update counts
    n_rounds: int
    grid: list                 # (n_rounds, R): sample ids, or None for a masked slot
    work: np.ndarray           # (R,) nnz units dispatched to each replica


def batch_size_scaling(b, lr, u, b_max: int, b_min: int, beta: float):
    """Algorithm 1: replicas above the mean update count grow their batch
    by beta times the excess (within b_max), those below shrink (within
    b_min); the learning rate follows linearly."""
    b = np.asarray(b, np.float64).copy()
    lr = np.asarray(lr, np.float64).copy()
    u = np.asarray(u, np.float64)
    mu = u.mean()
    for i in range(len(b)):
        if u[i] > mu and b[i] + beta * (u[i] - mu) <= b_max:
            new = b[i] + beta * (u[i] - mu)
        elif u[i] < mu and b[i] - beta * (mu - u[i]) >= b_min:
            new = b[i] - beta * (mu - u[i])
        else:
            continue
        lr[i] = lr[i] * new / b[i]
        b[i] = new
    return b, lr


def merge_weights(u, b, norms_per_param) -> np.ndarray:
    """Algorithm 2, lines 1-10: weights from the update counts (from the
    batch sizes where the counts are all equal), then the most-updated
    replica's weight times 1 + delta and the least-updated's times 1 -
    delta when every replica's norm per parameter is under the threshold."""
    u = np.asarray(u, np.float64)
    b = np.asarray(b, np.float64)
    alphas = b / b.sum() if np.all(u == u[0]) else u / u.sum()
    if len(alphas) >= 2 and np.all(np.asarray(norms_per_param) < PERT_THR):
        r, s = int(np.argmax(u)), int(np.argmin(u))
        if r != s:
            alphas[r] *= 1.0 + DELTA
            alphas[s] *= 1.0 - DELTA
    return alphas


class Replay:
    """The host side of a run, mega-batch by mega-batch.

    Each :meth:`step` plans the next mega-batch from the current batch
    sizes, charges its merge to the virtual clock and applies Algorithm 1.
    ``readings`` are the windows a measured speed model was fed, in order;
    under the overlap pipeline the trainer plans mega-batch k + 1 before it
    observes window k, and :meth:`step` feeds them so.
    """

    def __init__(self, traffic: dict, indptr: np.ndarray, label_ptr: np.ndarray, seed: int,
                 readings: list | None = None):
        self.R = int(traffic["replicas"])
        self.b_max = int(traffic["b_max"])
        self.b_min = max(1, self.b_max // 8)
        self.beta = self.b_min / 2
        self.mega = int(traffic["mega_batch"]) * self.b_max
        self.stale = 1 if traffic["overlap"] else 0
        self.indptr = indptr
        self.max_nnz, self.max_labels = padding(indptr, label_ptr)
        self.stream = SampleStream(len(indptr) - 1, seed)
        self.speed = (MeasuredSpeed(self.R) if traffic["speed"] == "measured"
                      else SimulatedSpeed(self.R, traffic["max_gap"], seed))
        self.readings = list(readings or [])
        self.clock = np.zeros(self.R)
        self.b = np.full(self.R, float(self.b_max))
        self.lr = float(traffic["lr"]) * self.b / self.b_max
        self.planned: list[Plan] = []
        self.observed = 0

    def _plan(self) -> Plan:
        b = np.maximum(np.round(self.b).astype(np.int64), 1)
        remaining, u = self.mega, np.zeros(self.R, np.int64)
        cells, work = [], np.zeros(self.R)
        while remaining > 0:
            i = int(np.argmin(self.clock))
            take = int(min(b[i], remaining))
            ids = self.stream.take(min(take, self.b_max))
            w = int(np.minimum(self.indptr[ids + 1] - self.indptr[ids], self.max_nnz).sum())
            self.clock[i] += self.speed.step_factor(i) * (OVERHEAD + WORK_COST * w)
            cells.append((int(u[i]), i, ids))
            work[i] += w
            u[i] += 1
            remaining -= take
        self.clock[:] = self.clock.max()
        n_rounds = int(u.max())
        grid = [[None] * self.R for _ in range(n_rounds)]
        for r, i, ids in cells:
            grid[r][i] = ids
        return Plan(u=u, n_rounds=n_rounds, grid=grid, work=work)

    def _observe_next(self) -> None:
        if isinstance(self.speed, MeasuredSpeed):
            if self.observed >= len(self.readings):
                raise ValueError(f"no measured window {self.observed} to replay")
            self.speed.observe(self.readings[self.observed])
        self.observed += 1

    def step(self):
        """The next mega-batch: (plan, b and lr it ran with, b and lr after
        Algorithm 1). Observes the windows the trainer had observed by the
        time it made this plan."""
        k = len(self.planned)
        while self.observed < k - self.stale:
            self._observe_next()
        plan = self._plan()
        self.planned.append(plan)
        b, lr = self.b.copy(), self.lr.copy()
        self.clock += MERGE_COST
        self.b, self.lr = batch_size_scaling(self.b, self.lr, plan.u, self.b_max, self.b_min,
                                             self.beta)
        return plan, b, lr, self.b.copy(), self.lr.copy()
