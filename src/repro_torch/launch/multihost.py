"""Multi-process spanning: bootstrap, rendezvous, and the exchange that lets
one elastic trainer span N processes.

Port of ``repro/launch/multihost.py``. Every process runs the identical
deterministic host loop at the *global* replica count R (same seeds: the
same plans, batch-size and lr adaptation, speed model and fleet
decisions), holds only its own contiguous block of replica slots on a
process-local replica mesh (``core/trainer.py``), and completes the
cross-process reductions through this context. Two spanning modes, picked
by :func:`bootstrap`:

* ``'host'`` — the file exchange plus heartbeat leases, on the CPU and on
  the card. Merge partials, metric sums, replica norms, finite masks,
  checkpoint rows and the fleet's event proposals are written as one
  ``.npz`` a process and sequence number under ``<fleet_dir>/xchg`` and
  summed or gathered by every process. Liveness comes from
  ``core/fleet.py::HeartbeatMonitor`` lease files: a peer whose lease goes
  stale is dropped mid-exchange (its merge weight renormalized over the
  contributors), *condemned* through a tombstone so every survivor
  converges on the same membership, and evicted through the fleet's crash
  path at the next mega-batch boundary. Algorithms that reduce across
  replicas inside every round (``round_collectives``) are refused: the
  exchange runs between rounds only.

* ``'device'`` — ``torch.distributed`` (the counterpart of the reference's
  ``jax.distributed.initialize``): one process group over a FileStore in
  the fleet dir (or ``REPRO_MH_COORDINATOR`` given as ``tcp://host:port``).
  The backend is NCCL when every process holds cards of its own and gloo on
  the CPU or when processes share a card (NCCL refuses two ranks on one
  GPU); gloo's collectives take host tensors, so tensors on a card are
  copied to the CPU and back around each one. :meth:`allreduce_sum` and
  :meth:`allgather` run over the group, and the sharded placement's replica
  axis (``sharding/executor.py::ReplicaAxis``) completes each in-round
  collective with one ``all_reduce``, so ``sync``, ``delayed_sync`` and
  ``crossbow`` span processes. The group fate-shares: a failed process
  ends the job, and recovery is a restart from the newest checkpoint.

Exchange correctness under fail-stop (host span): files land through an
atomic rename, so a partial write is never visible; a peer's contribution
to sequence n either was published before it died (every survivor sees
it: survivors stop waiting only after the peer's lease has been stale for
a whole grace period) or was not (no survivor sees it, all drop the peer).
Tombstones make the earliest staleness observation authoritative, and
``agree_events`` gathers every process's fleet proposals at each boundary,
so all survivors evict the same processes at the same boundary.

The wire format is the reference's: leaves ``l{i}`` of one ``.npz`` in
``xchg/s{seq:08d}-{tag}/p{pid}.npz``, trees numbered in ``jax.tree_util``'s
leaf order (``utils.tree.tree_flatten``), tombstones ``condemned/p{pid}``
and leases ``leases/proc-{pid}.json``: processes of either package read
each other's files.
"""
from __future__ import annotations

import io
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.fleet import FaultEvent, read_leases
from repro_torch.utils import tree as tu
from repro_torch.utils.logging import log

ENV_NUM_PROCESSES = "REPRO_MH_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_MH_PROCESS_ID"
ENV_FLEET_DIR = "REPRO_MH_FLEET_DIR"
ENV_COORDINATOR = "REPRO_MH_COORDINATOR"
ENV_SPANNING = "REPRO_MH_SPANNING"
# the process's local devices, comma-separated (``launch.multihost_launch``
# sets it: K "cpu" entries, or the process's cards)
ENV_LOCAL_DEVICES = "REPRO_MH_LOCAL_DEVICES"

# kinds a process may propose about a *peer* at a boundary, in the wire
# encoding of agree_events (join completes a monitor-side rejoin)
_EVENT_CODES = {"crash": 0, "preempt": 1, "join": 2}
_EVENT_KINDS = {v: k for k, v in _EVENT_CODES.items()}


class ProcessCondemned(RuntimeError):
    """This process was declared dead by a fleet peer (stale lease) and
    must not contribute further updates: restart to rejoin."""


@dataclass(frozen=True)
class MultihostSpec:
    """Bootstrap parameters, usually parsed from the environment
    (``REPRO_MH_*``) that ``launch.multihost_launch`` exports.
    ``local_devices`` names this process's devices (None: the trainer's
    own rule)."""

    num_processes: int
    process_id: int
    fleet_dir: str
    coordinator: Optional[str] = None
    spanning: str = "auto"          # auto | host | device
    local_devices: Optional[tuple] = None

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"{self.num_processes} processes"
            )
        if self.spanning not in ("auto", "host", "device"):
            raise ValueError(f"unknown spanning mode {self.spanning!r}")


def spec_from_env(environ=None) -> Optional[MultihostSpec]:
    """Build a spec from the ``REPRO_MH_*`` variables; None when the
    process was not launched into a fleet."""
    env = os.environ if environ is None else environ
    if ENV_NUM_PROCESSES not in env:
        return None
    local = env.get(ENV_LOCAL_DEVICES) or None
    return MultihostSpec(
        num_processes=int(env[ENV_NUM_PROCESSES]),
        process_id=int(env.get(ENV_PROCESS_ID, "0")),
        fleet_dir=env[ENV_FLEET_DIR],
        coordinator=env.get(ENV_COORDINATOR) or None,
        spanning=env.get(ENV_SPANNING, "auto"),
        local_devices=tuple(local.split(",")) if local else None,
    )


def _resolve_spanning(spec: MultihostSpec, device=None) -> str:
    """``auto``: the device span when this process trains on a card (its
    ``device``, else its first local device), the host span otherwise, as
    the reference picks by backend."""
    if spec.spanning != "auto":
        return spec.spanning
    if device is None and spec.local_devices:
        device = spec.local_devices[0]
    return "device" if torch.device(device or "cpu").type == "cuda" else "host"


def _card_identity(device: torch.device) -> str:
    """A name of the physical card behind ``device``, the same in every
    process that sees it (its UUID; else the visible-device mapping)."""
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    if uuid is not None:
        return str(uuid)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
    index = device.index or 0
    return f"{os.uname().nodename}:{visible[index] if index < len(visible) else index}"


def _init_process_group(spec: MultihostSpec, device: torch.device) -> str:
    """Join the fleet's ``torch.distributed`` group; returns the backend.
    NCCL when every process holds cards no other process holds, gloo on the
    CPU or when processes share a card. The processes compare their cards
    through the store before the group is made."""
    import torch.distributed as dist

    n, rank = spec.num_processes, spec.process_id
    coord = spec.coordinator or ""
    if coord.startswith("tcp://"):
        host, port = coord[len("tcp://"):].rsplit(":", 1)
        store = dist.TCPStore(host, int(port), n, is_master=rank == 0)
    else:
        store = dist.FileStore(os.path.join(spec.fleet_dir, "store"), n)
    ident = "cpu" if device.type != "cuda" else _card_identity(device)
    store.set(f"card/{rank}", ident)
    idents = [store.get(f"card/{r}").decode() for r in range(n)]
    own_cards = "cpu" not in idents and len(set(idents)) == n
    backend = "nccl" if own_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    return backend


def bootstrap(spec: MultihostSpec, device=None) -> "MultihostContext":
    """Initialize this process's membership in the fleet.

    Host span: prepare the shared ``fleet_dir`` layout (the rendezvous
    barrier runs later, :meth:`MultihostContext.rendezvous`, once the
    heartbeat lease is being renewed). Device span: join the
    ``torch.distributed`` group (more than one process), its backend
    stated in the log line.
    """
    spanning = _resolve_spanning(spec, device)
    for sub in ("leases", "condemned", "xchg"):
        os.makedirs(os.path.join(spec.fleet_dir, sub), exist_ok=True)
    ctx = MultihostContext(spec=spec, spanning=spanning)
    if spanning == "device" and spec.num_processes > 1:
        home = torch.device(device or (spec.local_devices or ("cpu",))[0])
        ctx.backend = _init_process_group(spec, home)
        why = ("every process holds cards of its own" if ctx.backend == "nccl"
               else "processes share a card or run on the CPU: NCCL refuses two ranks on "
                    "one GPU; tensors on a card are copied to the CPU around each collective")
        log("multihost process group", backend=ctx.backend, world=spec.num_processes,
            rank=spec.process_id, reason=why)
    return ctx


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _save_tree(path: str, leaves: list) -> int:
    """Write ``leaves`` as ``l0, l1, ...`` of one ``.npz``; returns the
    bytes written."""
    buf = io.BytesIO()
    np.savez(buf, **{f"l{i}": np.asarray(x) for i, x in enumerate(leaves)})
    data = buf.getvalue()
    _atomic_write(path, data)
    return len(data)


def _load_tree(path: str, n_leaves: int) -> list:
    with np.load(path) as z:
        return [z[f"l{i}"] for i in range(n_leaves)]


def _host(x) -> np.ndarray:
    """A leaf as a host array (tensors copied off their device; bf16,
    which numpy has no type for, widened to f32 exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


class MultihostContext:
    """One process's view of the fleet: slot bookkeeping shared by the
    trainer and the fleet controller, and the exchange (files under a host
    span, ``torch.distributed`` under a device span).

    Slot model: the global replica axis 0..R-1 is split into equal
    contiguous blocks, one per *active* process in process-id order.
    Eviction removes whole blocks and renumbers survivors first, which
    keeps every block contiguous: a process's replica trees are always rows
    ``lo:hi`` of the conceptual global state.

    ``stats`` counts the exchange's work: calls, seconds and bytes written
    and read, by tag.
    """

    def __init__(self, spec: MultihostSpec, spanning: str):
        self.spec = spec
        self.spanning = spanning
        self.process_id = spec.process_id
        self.n_processes = spec.num_processes
        self.fleet_dir = spec.fleet_dir
        self.local_devices = (
            tuple(torch.device(d) for d in spec.local_devices) if spec.local_devices else None
        )
        self.backend = None             # the device span's process-group backend
        self._active: list[int] = list(range(spec.num_processes))
        self._counts: dict[int, int] = {}
        self._seq = 0
        self._own_files: list[str] = []
        self._liveness: Optional[Any] = None
        self.poll_interval = 0.05
        self.exchange_timeout = 300.0
        self.stats: dict[str, dict] = {}
        # injectable: tests drive the exchange and rendezvous timeouts with
        # a fake clock instead of real 300 s waits
        self._clock = time.monotonic
        self._sleep = time.sleep

    # -- membership bookkeeping ---------------------------------------
    def attach_liveness(self, monitor) -> None:
        """Attach the HeartbeatMonitor whose leases decide whether an
        exchange keeps waiting for a silent peer."""
        self._liveness = monitor

    def active_processes(self) -> list[int]:
        return list(self._active)

    def assign_slots(self, n_replicas: int) -> None:
        n = len(self._active)
        if n_replicas % n != 0:
            raise ValueError(
                f"global replica count {n_replicas} must divide evenly over "
                f"{n} processes (contiguous equal blocks)"
            )
        self._counts = {pid: n_replicas // n for pid in self._active}

    def bounds_of(self, pid: int) -> tuple[int, int]:
        if pid not in self._counts:
            raise KeyError(f"process {pid} is not an active fleet member")
        lo = sum(self._counts[p] for p in self._active if p < pid)
        return lo, lo + self._counts[pid]

    def local_bounds(self) -> tuple[int, int]:
        return self.bounds_of(self.process_id)

    def local_count(self) -> int:
        return self._counts[self.process_id]

    def slots_of(self, pid: int) -> Optional[list[int]]:
        if pid not in self._counts:
            return None
        lo, hi = self.bounds_of(pid)
        return list(range(lo, hi))

    def processes_for_slots(self, slots) -> list[int]:
        """Resolve a drop set to whole peer processes; partial blocks or
        the local process's own block are errors: spanning membership
        changes at process grain only."""
        drop = set(int(s) for s in slots)
        victims = []
        for pid in self._active:
            block = set(self.slots_of(pid) or ())
            if not block & drop:
                continue
            if not block <= drop:
                raise ValueError(
                    f"slots {sorted(drop)} split process {pid}'s block "
                    f"{sorted(block)}; spanning eviction is per-process"
                )
            victims.append(pid)
        covered = set()
        for pid in victims:
            covered |= set(self.slots_of(pid))
        if covered != drop:
            raise ValueError(f"slots {sorted(drop - covered)} map to no process")
        if self.process_id in victims:
            raise ProcessCondemned(f"process {self.process_id} asked to evict itself")
        return victims

    def remove_process(self, pid: int) -> None:
        if pid == self.process_id:
            raise ProcessCondemned(f"process {self.process_id} asked to evict itself")
        self.condemn(pid)  # a removed peer must never silently rejoin
        self._active.remove(pid)
        del self._counts[pid]

    # -- tombstones ----------------------------------------------------
    def _tomb_path(self, pid: int) -> str:
        return os.path.join(self.fleet_dir, "condemned", f"p{pid}")

    def condemn(self, pid: int) -> None:
        path = self._tomb_path(pid)
        if not os.path.exists(path):
            _atomic_write(path, b"condemned\n")
        if self._liveness is not None:
            self._liveness.note_condemned(pid)

    def condemned(self) -> set[int]:
        d = os.path.join(self.fleet_dir, "condemned")
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return set()
        return {int(n[1:]) for n in names if n.startswith("p")}

    def check_condemned(self) -> None:
        if os.path.exists(self._tomb_path(self.process_id)):
            raise ProcessCondemned(
                f"process {self.process_id} was condemned by a fleet peer "
                "(heartbeat lease went stale); restart to rejoin"
            )

    # -- liveness ------------------------------------------------------
    def _peer_alive(self, pid: int) -> bool:
        if pid in self.condemned():
            return False
        if self._liveness is None:
            return True  # no monitor: the exchange's hard timeout decides
        return self._liveness.peer_fresh(pid)

    # -- the exchange --------------------------------------------------
    def _count(self, tag: str, seconds: float, written: int, read: int) -> None:
        st = self.stats.setdefault(tag, {"calls": 0, "seconds": 0.0, "bytes_written": 0,
                                         "bytes_read": 0})
        st["calls"] += 1
        st["seconds"] += seconds
        st["bytes_written"] += written
        st["bytes_read"] += read

    def _exchange(self, tag: str, leaves: list) -> dict[int, list]:
        """Publish this process's leaves for the next sequence number and
        collect every live peer's; returns {pid: leaves} including self.

        Every process runs the identical deterministic host loop, so they
        issue the same exchanges in the same order: the sequence counter
        stays in lockstep without coordination.
        """
        t0 = self._clock()
        self.check_condemned()
        seq = self._seq
        self._seq += 1
        d = os.path.join(self.fleet_dir, "xchg", f"s{seq:08d}-{tag}")
        os.makedirs(d, exist_ok=True)
        own = os.path.join(d, f"p{self.process_id}.npz")
        written = _save_tree(own, leaves)
        self._own_files.append(own)

        n_leaves = len(leaves)
        got: dict[int, list] = {self.process_id: leaves}
        read = 0
        expected = set(self._active) - {self.process_id} - self.condemned()
        deadline = self._clock() + self.exchange_timeout
        while expected - set(got):
            for pid in sorted(expected - set(got)):
                path = os.path.join(d, f"p{pid}.npz")
                if os.path.exists(path):
                    got[pid] = _load_tree(path, n_leaves)
                    read += sum(x.nbytes for x in got[pid])
            missing = expected - set(got)
            if not missing:
                break
            dropped = False
            for pid in sorted(missing):
                if not self._peer_alive(pid):
                    # fail-stop: the peer's lease is stale; had it published
                    # before dying, the rename would be visible by now.
                    # Condemn it, so every survivor converges on the same
                    # contributor set.
                    self.condemn(pid)
                    expected.discard(pid)
                    log(f"[multihost] exchange s{seq} {tag}: dropped process {pid} (stale lease)")
                    dropped = True
            if dropped:
                continue
            if self._clock() > deadline:
                raise RuntimeError(
                    f"exchange s{seq}-{tag} timed out waiting for processes {sorted(missing)}"
                )
            self.check_condemned()
            self._sleep(self.poll_interval)

        # retire own files old enough that every live peer has moved past
        # them (each process deletes only what it wrote: no delete races)
        while len(self._own_files) > 8:
            old = self._own_files.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        self._count(tag, self._clock() - t0, written, read)
        return got

    def _dist_leaf(self, x: np.ndarray):
        """A host leaf as a tensor the group's backend takes."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.backend == "nccl":
            t = t.to(self.local_devices[0] if self.local_devices else torch.device("cuda"))
        return t

    def all_reduce_tensor(self, x, op: str = "sum"):
        """One ``all_reduce`` of a tensor (or host number) over the device
        span's group, in place of its copy; the replica axis's cross-process
        step. Under gloo a tensor on a card is copied to the CPU and back."""
        import torch.distributed as dist

        t0 = self._clock()
        reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        if not isinstance(x, torch.Tensor):
            t = self._dist_leaf(np.asarray(float(x), np.float64))
            dist.all_reduce(t, op=reduce_op)
            out = type(x)(t.item())
        elif self.backend == "nccl" or x.device.type == "cpu":
            out = x.clone()
            dist.all_reduce(out, op=reduce_op)
        else:
            t = x.cpu()
            dist.all_reduce(t, op=reduce_op)
            out = t.to(x.device)
        n = x.nbytes if isinstance(x, torch.Tensor) else 8
        self._count("axis", self._clock() - t0, n, n)
        return out

    def allreduce_sum(self, tag: str, tree) -> tuple[Any, list[int]]:
        """Element-wise sum of ``tree`` over live processes, summed in
        process order. Returns the summed tree (host arrays) and the
        sorted contributor process ids."""
        leaves, treedef = tu.tree_flatten(tree)
        leaves = [_host(x) for x in leaves]
        if self._active == [self.process_id]:
            return tu.tree_unflatten(treedef, leaves), [self.process_id]
        if self.spanning == "device":
            import torch.distributed as dist

            t0 = self._clock()
            total = []
            for x in leaves:
                t = self._dist_leaf(x)
                dist.all_reduce(t)
                total.append(t.cpu().numpy().reshape(np.shape(x)))
            n = sum(x.nbytes for x in leaves)
            self._count(tag, self._clock() - t0, n, n)
            return tu.tree_unflatten(treedef, total), list(self._active)
        got = self._exchange(tag, leaves)
        contributors = sorted(got)
        total = [np.asarray(x).copy() for x in got[contributors[0]]]
        for pid in contributors[1:]:
            for i, leaf in enumerate(got[pid]):
                total[i] += leaf
        return tu.tree_unflatten(treedef, total), contributors

    def allgather(self, tag: str, tree) -> dict[int, Any]:
        """Gather ``tree`` from every live process: {pid: tree}."""
        leaves, treedef = tu.tree_flatten(tree)
        leaves = [_host(x) for x in leaves]
        if self._active == [self.process_id]:
            return {self.process_id: tu.tree_unflatten(treedef, leaves)}
        if self.spanning == "device":
            import torch.distributed as dist

            t0 = self._clock()
            out: list = [None] * self.n_processes
            dist.all_gather_object(out, leaves)
            n = sum(x.nbytes for x in leaves)
            self._count(tag, self._clock() - t0, n, n * (self.n_processes - 1))
            return {pid: tu.tree_unflatten(treedef, out[pid]) for pid in self._active}
        got = self._exchange(tag, leaves)
        return {pid: tu.tree_unflatten(treedef, vals) for pid, vals in got.items()}

    # -- fleet integration --------------------------------------------
    def agree_events(self, events) -> list[FaultEvent]:
        """Agree on this boundary's process-grain fleet events.

        Each process gathers every process's proposals; the union
        (deduplicated, in a fixed order) is applied everywhere, so
        survivors whose grace periods elapse a boundary apart still evict
        identically. Runs every boundary: it *is* the exchange that keeps
        lockstep across membership decisions.
        """
        rows = [
            (_EVENT_CODES[ev.kind], int(ev.process), int(ev.duration))
            for ev in events
            if ev.process is not None and ev.kind in _EVENT_CODES
        ]
        enc = np.asarray(rows, np.int64).reshape(len(rows), 3)
        gathered = self.allgather("fleet", enc)
        merged: dict[tuple[int, int], int] = {}
        for pid in sorted(gathered):
            for kind_c, proc, dur in np.asarray(gathered[pid], np.int64).reshape(-1, 3):
                merged.setdefault((int(proc), int(kind_c)), int(dur))
        out = []
        for (proc, kind_c), dur in sorted(merged.items()):
            kind = _EVENT_KINDS[kind_c]
            if proc == self.process_id and kind in ("crash", "preempt"):
                # a peer proposed evicting *us*: skipping it would desync
                # the exchange sequence, and the fleet goes on without this
                # process, so stop participating now
                raise ProcessCondemned(
                    f"process {self.process_id} evicted by fleet agreement ({kind})"
                )
            if proc in self._active and proc != self.process_id:
                out.append(FaultEvent(kind, process=proc, duration=dur))
        return out

    def rendezvous(self, timeout: float = 180.0) -> None:
        """Startup barrier (host span): wait until every configured
        process has published a heartbeat lease. Call after the local
        lease is being renewed."""
        if self.spanning != "host" or self.n_processes == 1:
            return
        leases_dir = os.path.join(self.fleet_dir, "leases")
        deadline = self._clock() + timeout
        want = set(range(self.n_processes))
        while True:
            if want <= set(read_leases(leases_dir)):
                return
            if self._clock() > deadline:
                missing = sorted(want - set(read_leases(leases_dir)))
                raise RuntimeError(
                    f"multihost rendezvous timed out; processes {missing} "
                    f"never published a lease under {leases_dir}"
                )
            self._sleep(self.poll_interval)

    # -- device span helpers ------------------------------------------
    def global_devices(self) -> list:
        """The fleet's devices, ordered by (process, local index)
        (``sharding.rules.global_replica_devices``)."""
        from repro_torch.sharding.rules import global_replica_devices

        return global_replica_devices(self)

    def shutdown(self) -> None:
        """Leave the device span's process group (a no-op otherwise)."""
        if self.backend is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.backend = None
