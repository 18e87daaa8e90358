"""Dynamic scheduler: the paper's availability-driven batch dispatch,
reformulated as *masked lockstep rounds*.

Copied from ``repro/core/scheduler.py`` (``Dispatch``, ``MegaBatchPlan`` with
``per_replica_work``, ``DynamicScheduler`` with its ``resize``).

Paper (§3.1): batches are dispatched one-by-one to whichever GPU finishes
first, until a mega-batch worth of samples has been consumed; the number of
model updates u_i then differs across GPUs. All replicas here step together,
so a mega-batch is planned as a discrete-event simulation over the virtual
clock:

  while samples remain in the mega-batch:
      i <- replica with the earliest virtual completion time
      dispatch the next b_i samples to i; advance its clock

The plan is then executed as ``max_i u_i`` lockstep rounds; replicas with
fewer dispatches get masked (no-op) rounds. The resulting update counts,
batch contents and merge math are *identical* to the paper's asynchronous
execution — only the wall-clock interleaving differs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import ElasticConfig
from repro_torch.core.heterogeneity import CostModel, VirtualClock


@dataclass
class Dispatch:
    """One batch assignment: replica i processes `n_samples` at round r."""

    replica: int
    round: int
    n_samples: int
    start_t: float
    end_t: float
    payload: object = None  # the actual batch (set when a fetch_fn is given)
    work: int = 0           # work units (nnz) that priced this step


@dataclass
class MegaBatchPlan:
    dispatches: list[Dispatch]
    u: np.ndarray            # (R,) update counts
    n_rounds: int
    barrier_time: float      # virtual time when the merge can start
    samples: int

    def per_replica_work(self, n_replicas: int) -> np.ndarray:
        """(R,) total work units dispatched to each replica — the
        denominator when a MeasuredSpeedModel attributes wall time."""
        out = np.zeros(n_replicas, np.float64)
        for d in self.dispatches:
            out[d.replica] += d.work
        return out

    def payload_grid(self, n_replicas: int) -> list[list]:
        """Dense (n_rounds, R) grid of payloads; ``None`` = masked slot.

        The handoff to the mega-batch engine: the sparse dispatch list
        becomes the rectangular layout a lockstep executor consumes.
        """
        grid: list[list] = [[None] * n_replicas for _ in range(self.n_rounds)]
        for d in self.dispatches:
            grid[d.round][d.replica] = d.payload
        return grid


@dataclass
class DynamicScheduler:
    """Plans mega-batches on the virtual clock; tracks update counts."""

    cfg: ElasticConfig
    cost: CostModel
    clock: VirtualClock = field(init=False)

    def __post_init__(self):
        self.clock = VirtualClock(self.cfg.n_replicas)

    def resize(self, cfg: ElasticConfig) -> None:
        """Adopt a new replica count between mega-batches: the new config
        and a clock of the new width (survivor timelines carry, joiners
        enter at the barrier). The trainer resizes the speed model behind
        ``cost`` first, so the next plan prices every replica."""
        self.cfg = cfg
        self.clock.resize(cfg.n_replicas)

    def plan_megabatch(
        self, b: np.ndarray, mega_samples: int, fetch_fn=None
    ) -> MegaBatchPlan:
        """Simulate dispatch of ``mega_samples`` samples.

        ``b`` — per-replica batch sizes (Algorithm 1 output).
        ``fetch_fn(replica, take) -> (payload, work_units)`` pulls the actual
        batch (so the *real* nnz cardinality feeds the clock — the paper's
        second heterogeneity source). Without it work == n_samples.
        """
        R = self.cfg.n_replicas
        b = np.maximum(np.asarray(b, np.int64), 1)
        remaining = int(mega_samples)
        u = np.zeros(R, np.int64)
        dispatches: list[Dispatch] = []
        while remaining > 0:
            i = self.clock.earliest()
            take = int(min(b[i], remaining))
            payload, work = fetch_fn(i, take) if fetch_fn else (None, take)
            dt = self.cost.step_time(i, work)
            start = float(self.clock.t[i])
            self.clock.advance(i, dt)
            dispatches.append(
                Dispatch(i, int(u[i]), take, start, start + dt, payload, int(work))
            )
            u[i] += 1
            remaining -= take
        barrier = self.clock.barrier()
        self.cost.speed.advance()
        return MegaBatchPlan(
            dispatches=dispatches,
            u=u,
            n_rounds=int(u.max()) if len(dispatches) else 0,
            barrier_time=barrier,
            samples=int(mega_samples),
        )

    def plan_static(self, b: int, n_batches_per_replica: int, fetch_fn=None) -> MegaBatchPlan:
        """Elastic/sync baseline: every replica gets the same fixed share.

        Models the paper's Figure 3: static partitioning means the slowest
        replica dictates the barrier.
        """
        R = self.cfg.n_replicas
        u = np.full(R, n_batches_per_replica, np.int64)
        dispatches = []
        for r in range(n_batches_per_replica):
            for i in range(R):
                payload, work = fetch_fn(i, int(b)) if fetch_fn else (None, int(b))
                dt = self.cost.step_time(i, work)
                start = float(self.clock.t[i])
                self.clock.advance(i, dt)
                dispatches.append(
                    Dispatch(i, r, int(b), start, start + dt, payload, int(work))
                )
        barrier = self.clock.barrier()
        self.cost.speed.advance()
        return MegaBatchPlan(
            dispatches=dispatches,
            u=u,
            n_rounds=n_batches_per_replica,
            barrier_time=barrier,
            samples=int(b) * n_batches_per_replica * R,
        )
