"""Fleet controller, deterministic fault injection and heartbeat leases.

Port of ``repro/core/fleet.py``: ``FAULT_KINDS``, ``FaultEvent``,
``FaultInjector``, ``parse_fault_spec``, the lease files (``write_lease``,
``read_leases``), ``HeartbeatMonitor`` and ``FleetController``. Between mega-batches the trainer hands control to a
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
reference's.

Process grain (multi-process training, ``launch.multihost``): every process
of a fleet renews a lease file; a :class:`HeartbeatMonitor` turns a peer's
stale lease into a ``crash`` event, an announced departure into a
``preempt`` and a resumed lease into a ``join``, each with ``process`` set.
The controller resolves such an event to the process's whole block of
replica slots (``trainer.process_slots``) and applies one multi-slot
membership change; under a spanning trainer the proposals are agreed over
the exchange first (``MultihostContext.agree_events``), so every survivor
evicts the same processes at the same boundary.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

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
    ``process`` — set by the HeartbeatMonitor: the event targets a whole
    *process* (all of its replica slots at once) rather than one slot.
    """

    kind: str
    replica: Optional[int] = None
    duration: int = 2
    severity: float = 4.0
    process: Optional[int] = None

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


# ---------------------------------------------------------------------------
# heartbeat leases

LEASE_PREFIX = "proc-"
LEASE_STATUSES = ("live", "leaving", "done")


def write_lease(leases_dir: str, process_id: int, counter: int,
                status: str = "live", megabatch: Optional[int] = None) -> str:
    """Atomically publish one process's lease (tmp + rename, so readers
    never see a partial write). Returns the lease path."""
    if status not in LEASE_STATUSES:
        raise ValueError(f"unknown lease status {status!r}")
    payload = {"process": int(process_id), "counter": int(counter), "status": status}
    if megabatch is not None:
        payload["megabatch"] = int(megabatch)
    path = os.path.join(leases_dir, f"{LEASE_PREFIX}{int(process_id)}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def read_leases(leases_dir: str) -> dict[int, dict]:
    """All parseable leases under ``leases_dir``: {process_id: payload}."""
    out: dict[int, dict] = {}
    try:
        names = os.listdir(leases_dir)
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith(LEASE_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(leases_dir, name)) as f:
                payload = json.load(f)
            out[int(payload["process"])] = payload
        except (OSError, ValueError, KeyError):
            continue  # a racing writer or a stray file; the next observe sees it
    return out


class HeartbeatMonitor:
    """Lease-file liveness: the signal source of a multi-process fleet.

    Every process renews ``<fleet_dir>/leases/proc-<id>.json`` (an
    incrementing counter, a status and the last completed mega-batch). The
    monitor watches *content changes*, not embedded timestamps, so liveness
    needs no clock sync between machines sharing the directory: a peer is
    stale when its lease has not changed for ``grace`` seconds of the local
    ``clock`` (injectable, so every timing behavior is testable without
    real sleeps).

    ``poll(mb)`` turns observations into the injector's ``FaultEvent``
    stream: stale or tombstoned -> ``crash``; status ``'leaving'`` ->
    ``preempt``; a dead peer whose lease resumes changing -> ``join``, but
    only ``rejoin_backoff`` mega-batches after its eviction; status
    ``'done'`` is a clean exit, never an event. Tombstones
    (``<fleet_dir>/condemned/p<id>``, written by the exchange or through
    :meth:`note_condemned`) are authoritative: a condemned peer is a crash
    even if its lease looks fresh, and a condemned *self* raises.

    ``slot_map`` optionally maps process ids to replica slots for
    consumers whose trainer has no spanning context of its own.
    """

    def __init__(self, fleet_dir: str, process_id: Optional[int] = None,
                 interval: float = 0.5, grace: float = 3.0,
                 rejoin_backoff: int = 2, clock=time.monotonic,
                 slot_map: Optional[dict[int, list[int]]] = None):
        self.fleet_dir = fleet_dir
        self.leases_dir = os.path.join(fleet_dir, "leases")
        self.tombs_dir = os.path.join(fleet_dir, "condemned")
        os.makedirs(self.leases_dir, exist_ok=True)
        os.makedirs(self.tombs_dir, exist_ok=True)
        self.process_id = process_id
        self.interval = float(interval)
        self.grace = float(grace)
        self.rejoin_backoff = int(rejoin_backoff)
        self.clock = clock
        self.slot_map = slot_map
        self._counter = 0
        self._megabatch = 0
        self._status = "live"
        self._lock = threading.Lock()
        # pid -> [counter, status, changed_at (local clock), payload]
        self._seen: dict[int, list] = {}
        self._dead: dict[int, int] = {}      # pid -> eviction mega-batch
        self._finished: set[int] = set()
        self._condemned_cache: set[int] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- own lease -----------------------------------------------------
    def renew(self, megabatch: Optional[int] = None, status: Optional[str] = None) -> None:
        """Publish a fresh lease. ``status`` is *sticky*: once a caller
        announces ``'leaving'``/``'done'``, the daemon renewals (which pass
        no status) keep republishing it."""
        if self.process_id is None:
            return
        with self._lock:
            self._counter += 1
            if megabatch is not None:
                self._megabatch = int(megabatch)
            if status is not None:
                self._status = str(status)
            # the write stays inside the lock, ordered with the counter it
            # stamps: out-of-order counters would make a fresh lease look stale
            write_lease(self.leases_dir, self.process_id, self._counter,  # jaxlint: disable=JL104 — lease publish must stay ordered with the counter it stamps
                        status=self._status, megabatch=self._megabatch)

    def start(self) -> None:
        """Renew in a daemon thread every ``interval`` seconds, so a long
        mega-batch (the first one builds kernels) cannot starve liveness."""
        if self._thread is not None:
            return

        def _loop():
            while not self._stop.wait(self.interval):
                self.renew()

        self._thread = threading.Thread(target=_loop, name="heartbeat-renew", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- observation ---------------------------------------------------
    def observe(self) -> None:
        """Refresh the lease table; a content change resets the peer's
        staleness clock (at *this* process's clock)."""
        now = self.clock()
        for pid, payload in read_leases(self.leases_dir).items():
            rec = self._seen.get(pid)
            counter = payload.get("counter")
            status = payload.get("status", "live")
            if rec is None or rec[0] != counter or rec[1] != status:
                self._seen[pid] = [counter, status, now, payload]

    def condemned_ids(self) -> set[int]:
        try:
            names = os.listdir(self.tombs_dir)
        except FileNotFoundError:
            names = []
        self._condemned_cache = {int(n[1:]) for n in names if n.startswith("p")} \
            | self._condemned_cache
        return set(self._condemned_cache)

    def note_condemned(self, pid: int) -> None:
        self._condemned_cache.add(int(pid))

    def peer_fresh(self, pid: int) -> bool:
        """Is this peer's lease still changing? (The exchange's wait
        predicate: False means stop waiting for its contributions.)"""
        self.observe()
        rec = self._seen.get(pid)
        if rec is None or rec[1] == "done":
            return False
        return (self.clock() - rec[2]) <= self.grace

    def live_processes(self) -> set[int]:
        self.observe()
        now = self.clock()
        condemned = self.condemned_ids()
        return {
            pid for pid, rec in self._seen.items()
            if rec[1] != "done" and pid not in condemned and (now - rec[2]) <= self.grace
        }

    def mark_dead(self, pid: int, mb: int) -> None:
        """Record an eviction decided elsewhere (the exchange-agreed events)
        so ``poll`` does not report it again."""
        self._dead.setdefault(int(pid), int(mb))

    def last_megabatch(self, pid: int) -> Optional[int]:
        rec = self._seen.get(pid)
        return None if rec is None else rec[3].get("megabatch")

    # -- the event source ----------------------------------------------
    def poll(self, mb: int) -> list[FaultEvent]:
        """Observations -> the injector's events for this boundary."""
        self.observe()
        now = self.clock()
        condemned = self.condemned_ids()
        if self.process_id is not None and self.process_id in condemned:
            raise RuntimeError(
                f"process {self.process_id} was condemned by a fleet peer "
                "(heartbeat lease went stale); restart to rejoin"
            )
        events: list[FaultEvent] = []
        for pid in sorted(self._seen):
            if pid == self.process_id or pid in self._finished:
                continue
            rec = self._seen[pid]
            status = rec[1]
            if pid in self._dead:
                # rejoin after the backoff: the lease must be changing again
                if (pid not in condemned and status == "live"
                        and (now - rec[2]) <= self.grace
                        and mb - self._dead[pid] >= self.rejoin_backoff):
                    del self._dead[pid]
                    events.append(FaultEvent("join", process=pid))
                continue
            if status == "done":
                self._finished.add(pid)
                continue
            stale = (now - rec[2]) > self.grace
            if pid in condemned or stale:
                events.append(FaultEvent("crash", process=pid))
                self._dead[pid] = int(mb)
            elif status == "leaving":
                events.append(FaultEvent("preempt", process=pid,
                                         duration=rec[3].get("duration", 2)))
                self._dead[pid] = int(mb)
        return events


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

    ``monitor`` — a :class:`HeartbeatMonitor`: each tick first renews the
    process's lease and applies the process-grain events it reports (agreed
    over the exchange under a spanning trainer). Under a spanning trainer
    the injector and the health detector stay off: membership changes at
    process grain only.

    Every action lands in ``self.events`` (dicts with mega-batch, action,
    replica slot), in the reference's format.
    """

    injector: Optional[FaultInjector] = None
    monitor: Optional[Any] = None
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
        span = getattr(trainer, "_span", None)

        # 0. heartbeat liveness: renew our lease with the progress peers and
        # the spawner key off, then turn peer observations into the
        # injector's event stream; under a spanning trainer the proposals
        # are agreed over the exchange first, so every survivor applies the
        # same evictions at this boundary
        if self.monitor is not None:
            self.monitor.renew(megabatch=mb)
            observed = self.monitor.poll(mb)
            if span is not None:
                observed = span.agree_events(observed)
                for ev in observed:
                    if ev.kind in ("crash", "preempt"):
                        self.monitor.mark_dead(ev.process, mb)
            for ev in observed:
                state = self._apply_event(trainer, state, mb, ev)

        # 1. transient stalls that ran their course
        for slot, (expire, mult) in sorted(self._stalls.items()):
            if mb >= expire:
                if slot < trainer.cfg.n_replicas and isinstance(trainer.speed, SpeedModel):
                    # a prefetched plan was costed with the stalled factor
                    trainer.invalidate_prefetch()
                    trainer.speed.factors[slot] /= mult
                del self._stalls[slot]
                self._log(mb, "stall_recovered", slot)

        # 2. quarantined workers whose backoff elapsed (injector evictions
        # only: monitor evictions rejoin through the lease signal)
        for q in [q for q in self._quarantine if q.rejoin_at <= mb]:
            cap = self.max_replicas or np.inf
            if trainer.cfg.n_replicas >= cap:
                continue  # stays queued until there is room
            state = trainer.resize(state, trainer.cfg.n_replicas + 1)
            self._quarantine.remove(q)
            self._last_rejoin_mb, self._last_level = mb, q.level
            self._log(mb, "rejoin", trainer.cfg.n_replicas - 1, level=q.level)

        # 3. injected fault events (slot grain: not under a spanning trainer)
        if self.injector is not None and span is None:
            for ev in self.injector.events_for(mb, trainer.cfg.n_replicas):
                state = self._apply_event(trainer, state, mb, ev)

        # 4. health: evict the straggler if it blew the timeout factor
        if (
            self.timeout_factor > 0
            and span is None
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
        if ev.process is not None:
            return self._apply_process_event(trainer, state, mb, ev)
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

    def _apply_process_event(self, trainer, state, mb: int, ev: FaultEvent):
        """A monitor event that targets a whole process: resolve its replica
        slots (the trainer's spanning context, else the monitor's
        ``slot_map``) and apply one multi-slot membership change. No
        quarantine entry is queued: a process the monitor evicted rejoins
        only when its lease resumes (the monitor's ``join``)."""
        pid = ev.process
        R = trainer.cfg.n_replicas
        spanning = getattr(trainer, "_span", None) is not None
        slots = None
        if hasattr(trainer, "process_slots"):
            slots = trainer.process_slots(pid)
        if slots is None and self.monitor is not None and self.monitor.slot_map:
            slots = self.monitor.slot_map.get(pid)

        if ev.kind == "join":
            n = len(slots) if slots else 1
            cap = self.max_replicas or np.inf
            if spanning:
                # a spanning fleet cannot re-split live device state onto a
                # returning process: it rejoins on restart instead
                self._log(mb, "join_skipped", None, process=pid,
                          reason="spanning rejoin needs restart")
            elif R + n > cap:
                self._log(mb, "join_skipped", None, process=pid, reason="at max_replicas")
            else:
                state = trainer.resize(state, R + n)
                self._log(mb, "join", list(range(R, R + n)), process=pid)
            return state

        if ev.kind not in ("crash", "preempt"):
            self._log(mb, f"{ev.kind}_skipped", None, process=pid,
                      reason="process events are crash/preempt/join")
            return state
        if slots is None:
            self._log(mb, f"{ev.kind}_skipped", None, process=pid,
                      reason="no slot mapping for process")
            return state
        if R - len(slots) < self.min_replicas:
            self._log(mb, f"{ev.kind}_skipped", list(slots), process=pid,
                      reason="at min_replicas")
            return state

        graceful = ev.kind == "preempt"
        slots = sorted(int(s) for s in slots)
        state = trainer.remove_replicas(state, slots, merge_leavers=graceful)
        dropset = set(slots)
        self._stalls = {
            s - sum(1 for d in slots if d < s): v
            for s, v in self._stalls.items()
            if s not in dropset
        }
        self._log(mb, "evict", slots, reason=ev.kind, graceful=graceful, process=pid)
        return state

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
