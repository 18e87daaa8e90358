"""Fleet controller + deterministic fault injection, at replica-slot grain.

Port of the slot-grain half of ``repro/core/fleet.py``: ``FAULT_KINDS``,
``FaultEvent``, ``FaultInjector``, ``parse_fault_spec`` and
``FleetController``. Between mega-batches the trainer hands control to a
:class:`FleetController`, which consumes :class:`FaultEvent`s — replica
crashes, preemption notices, join requests, transient stalls, NaN
poisoning — and turns them into targeted membership changes
(``trainer.remove_replicas`` / ``trainer.resize``), quarantine bookkeeping
with exponential-backoff readmission, and eviction of replicas whose
relative speed blows past a timeout factor.

Fault model:

* ``crash`` — gone without notice: its in-flight updates are excluded
  from the final merge (``remove_replicas(..., merge_leavers=False)``
  zeroes its rows and gives it merge weight 0), and the worker enters
  quarantine with exponential-backoff readmission.
* ``preempt`` — gone with notice: its updates fold into the final merge
  like any graceful leaver, and it rejoins after its announced absence.
* ``join`` — capacity appears: ``resize(R + 1)`` (the joiner clones the
  merged global with zero momentum).
* ``stall`` — the simulated speed factor is multiplied by ``severity`` for
  ``duration`` mega-batches; the health detector may evict the straggler.
* ``nan`` — a replica's parameters are poisoned with NaN; the trainer's
  non-finite guard excludes and heals it at the next barrier.

Probabilistic events draw from ``np.random.default_rng((seed, mega_batch))``
— keyed by position, not draw history — and scripted events fire at exact
mega-batch indices, so every run replays the same event sequence as the
reference's. The lease files, ``HeartbeatMonitor`` and process-grain events
wait for the multi-host slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from repro_torch.core.heterogeneity import SpeedModel
from repro_torch.utils import tree as tu
from repro_torch.utils.logging import log

FAULT_KINDS = ("crash", "preempt", "join", "stall", "nan")


@dataclass(frozen=True)
class FaultEvent:
    """One fault at a mega-batch boundary.

    ``replica`` — target slot; None lets the consumer pick (scripted
    events default to the tail slot, probabilistic draws pick uniformly).
    ``duration`` — mega-batches of absence (preempt) / slowdown (stall).
    ``severity`` — stall slowdown multiplier on the simulated speed factor.
    """

    kind: str
    replica: Optional[int] = None
    duration: int = 2
    severity: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.duration < 1:
            raise ValueError(f"fault duration must be >= 1, got {self.duration}")


@dataclass
class FaultInjector:
    """Deterministic fault source: scripted schedule + seeded coin flips.

    ``schedule`` maps a mega-batch index to the events that fire before it;
    the ``p_*`` rates add at most one probabilistic event of each kind per
    boundary, drawn from ``(seed, mega_batch)`` alone, so the event at
    mega-batch 17 is the same whether or not earlier faults fired (and
    identical after a checkpoint restore).
    """

    seed: int = 0
    p_crash: float = 0.0
    p_preempt: float = 0.0
    p_join: float = 0.0
    p_stall: float = 0.0
    p_nan: float = 0.0
    schedule: dict[int, tuple[FaultEvent, ...]] = field(default_factory=dict)

    def events_for(self, mb: int, n_replicas: int) -> list[FaultEvent]:
        events = list(self.schedule.get(int(mb), ()))
        rates = (
            ("crash", self.p_crash), ("preempt", self.p_preempt),
            ("join", self.p_join), ("stall", self.p_stall),
            ("nan", self.p_nan),
        )
        if any(p > 0 for _, p in rates):
            rng = np.random.default_rng((self.seed, int(mb)))
            for kind, p in rates:
                # one draw per kind per boundary, unconditionally: the
                # event stream must not depend on which faults fired
                hit = rng.random() < p
                target = int(rng.integers(max(n_replicas, 1)))
                if p > 0 and hit:
                    events.append(FaultEvent(kind, None if kind == "join" else target))
        return events


def parse_fault_spec(spec: str) -> FaultInjector:
    """Parse the launcher's ``--faults`` string.

    Comma-separated tokens, two shapes::

        seed=7,p_crash=0.02,p_join=0.05     injector parameters
        3:crash:1,5:join,7:nan:0,9:stall:2:4  MB:kind[:replica[:duration]]

    A scripted event's replica may be omitted (consumer picks the tail
    slot). Unknown parameters, kinds, or negative indices fail fast.
    """
    kwargs: dict = {}
    schedule: dict[int, list[FaultEvent]] = {}
    rate_keys = ("p_crash", "p_preempt", "p_join", "p_stall", "p_nan")
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            key, _, value = token.partition("=")
            key = key.strip()
            if key == "seed":
                kwargs["seed"] = int(value)
            elif key in rate_keys:
                kwargs[key] = float(value)
            else:
                raise ValueError(f"unknown fault parameter {key!r} in --faults {spec!r}")
            continue
        parts = token.split(":")
        if len(parts) < 2:
            raise ValueError(f"bad fault token {token!r} (want MB:kind[:replica[:dur]])")
        mb = int(parts[0])
        if mb < 0:
            raise ValueError(f"fault token {token!r} has negative mega-batch")
        replica = int(parts[2]) if len(parts) > 2 and parts[2] != "" else None
        duration = int(parts[3]) if len(parts) > 3 else 2
        schedule.setdefault(mb, []).append(FaultEvent(parts[1], replica, duration))
    return FaultInjector(schedule={k: tuple(v) for k, v in schedule.items()}, **kwargs)


@dataclass
class _Quarantined:
    """One absent worker awaiting readmission."""

    rejoin_at: int      # mega-batch index when readmission is due
    level: int = 0      # backoff escalation level (crashes only)
    graceful: bool = False


@dataclass
class FleetController:
    """Reactive membership control, called by ``ElasticTrainer.run`` as
    ``state = fleet.step(trainer, state, mb)`` at each mega-batch boundary.

    Order of business per tick: expire stalls → readmit quarantined
    workers whose backoff elapsed → apply injected fault events → evict
    unhealthy stragglers. Membership stays within ``[min_replicas,
    max_replicas]``.

    Health detection: a replica whose relative speed factor exceeds
    ``timeout_factor``× the population median is evicted gracefully and
    readmitted after backoff (``timeout_factor=0`` disables it).

    Quarantine: readmission delay is ``backoff * 2**level`` mega-batches
    (capped at ``backoff_cap``); a crash within ``probation`` mega-batches
    of the last readmission escalates the level.

    Every action lands in ``self.events`` (dicts with mega-batch, action,
    replica slot), in the reference's format.
    """

    injector: Optional[FaultInjector] = None
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    timeout_factor: float = 0.0
    backoff: int = 2
    backoff_cap: int = 16
    probation: int = 4
    verbose: bool = False
    events: list = field(default_factory=list)
    _quarantine: list = field(default_factory=list)
    _stalls: dict = field(default_factory=dict)  # slot -> [expire_mb, mult]
    _last_rejoin_mb: Optional[int] = None
    _last_level: int = 0

    # ------------------------------------------------------------------
    def step(self, trainer, state, mb: int):
        # 1. transient stalls that ran their course
        for slot, (expire, mult) in sorted(self._stalls.items()):
            if mb >= expire:
                if slot < trainer.cfg.n_replicas and isinstance(trainer.speed, SpeedModel):
                    # a prefetched plan was costed with the stalled factor
                    trainer.invalidate_prefetch()
                    trainer.speed.factors[slot] /= mult
                del self._stalls[slot]
                self._log(mb, "stall_recovered", slot)

        # 2. quarantined workers whose backoff elapsed
        for q in [q for q in self._quarantine if q.rejoin_at <= mb]:
            cap = self.max_replicas or np.inf
            if trainer.cfg.n_replicas >= cap:
                continue  # stays queued until there is room
            state = trainer.resize(state, trainer.cfg.n_replicas + 1)
            self._quarantine.remove(q)
            self._last_rejoin_mb, self._last_level = mb, q.level
            self._log(mb, "rejoin", trainer.cfg.n_replicas - 1, level=q.level)

        # 3. injected fault events
        if self.injector is not None:
            for ev in self.injector.events_for(mb, trainer.cfg.n_replicas):
                state = self._apply_event(trainer, state, mb, ev)

        # 4. health: evict the straggler if it blew the timeout factor
        if (
            self.timeout_factor > 0
            and trainer.cfg.n_replicas > self.min_replicas
        ):
            factors = np.asarray(trainer.speed.factors, np.float64)
            worst = int(np.argmax(factors))
            median = float(np.median(factors))
            if factors[worst] > self.timeout_factor * max(median, 1e-12):
                state = self._evict(trainer, state, mb, worst, graceful=True, reason="timeout")
        return state

    # ------------------------------------------------------------------
    def _apply_event(self, trainer, state, mb: int, ev: FaultEvent):
        R = trainer.cfg.n_replicas
        slot = ev.replica if ev.replica is not None else R - 1
        if ev.kind != "join" and not 0 <= slot < R:
            self._log(mb, f"{ev.kind}_skipped", slot, reason="no such slot")
            return state

        if ev.kind == "join":
            cap = self.max_replicas or np.inf
            if R >= cap:
                self._log(mb, "join_skipped", None, reason="at max_replicas")
            else:
                state = trainer.resize(state, R + 1)
                self._log(mb, "join", R)
            return state

        if ev.kind in ("crash", "preempt"):
            if R <= self.min_replicas:
                self._log(mb, f"{ev.kind}_skipped", slot, reason="at min_replicas")
            else:
                state = self._evict(
                    trainer, state, mb, slot,
                    graceful=(ev.kind == "preempt"),
                    reason=ev.kind,
                    rejoin_in=ev.duration if ev.kind == "preempt" else None,
                )
            return state

        if ev.kind == "stall":
            if isinstance(trainer.speed, SpeedModel) and slot not in self._stalls:
                # a prefetched plan was costed before the stall: revoke it
                # so the next plan sees the stalled factor
                trainer.invalidate_prefetch()
                trainer.speed.factors[slot] *= ev.severity
                self._stalls[slot] = [mb + ev.duration, ev.severity]
                self._log(mb, "stall", slot, duration=ev.duration, severity=ev.severity)
            else:
                self._log(mb, "stall_skipped", slot, reason="not simulated")
            return state

        # 'nan': poison the slot's parameters (a new tensor a leaf: the
        # state may be held elsewhere); the trainer's non-finite guard
        # excludes it from the merge and heals it
        self._log(mb, "nan", slot)
        return dataclasses.replace(
            state, replicas=tu.tree_fill_rows(state.replicas, [slot], float("nan")))

    def _evict(self, trainer, state, mb, slot, graceful, reason, rejoin_in=None):
        level = 0
        if not graceful and self._last_rejoin_mb is not None and (
            mb - self._last_rejoin_mb <= self.probation
        ):
            level = self._last_level + 1
        if rejoin_in is None:
            rejoin_in = min(self.backoff * (2 ** level), self.backoff_cap)
        state = trainer.remove_replicas(state, [slot], merge_leavers=graceful)
        # survivor slots above the evicted one shift down by one
        self._stalls = {
            (s - 1 if s > slot else s): v
            for s, v in self._stalls.items()
            if s != slot
        }
        self._quarantine.append(
            _Quarantined(rejoin_at=mb + max(1, int(rejoin_in)), level=level, graceful=graceful)
        )
        self._log(mb, "evict", slot, reason=reason, graceful=graceful,
                  level=level, rejoin_in=int(rejoin_in))
        return state

    def _log(self, mb: int, action: str, slot, **extra) -> None:
        entry = {"mb": int(mb), "action": action, "replica": slot, **extra}
        self.events.append(entry)
        if self.verbose:
            log(f"[fleet] mb={mb}", **{k: v for k, v in entry.items() if k != "mb"})
