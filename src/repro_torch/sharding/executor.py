"""Run a function on every shard of a replica mesh at once, and the
collectives the shards reduce with.

The sharded placement runs in one process. Each shard of the mesh gets a
persistent worker thread, its device and, on a card, a CUDA stream of its
own; ``ShardExecutor.run(fn)`` calls ``fn(shard)`` in every worker at once
and returns the results in shard order. Inside ``fn`` the replica axis is
bound to the worker (:func:`bound_axis`), so code written once for the
vmap placement reduces across shards by naming the axis, as the
reference's traced hooks name theirs inside ``shard_map``: the helpers in
``utils.tree`` take the axis name and call :meth:`ReplicaAxis.all_sum` or
:meth:`ReplicaAxis.all_max`. A collective is a rendezvous at a
``threading.Barrier``: every shard deposits its partial, the partials are
summed in shard order (so every shard gets the same bits on every run), and
a second barrier frees the slots. Shards on one device share one result.

Streams. ``run`` records an event on the caller's current stream of every
mesh device and each shard's stream waits on it before ``fn`` runs; when
the workers return, the caller's current streams wait on an event each
shard recorded after ``fn``. So the work a caller issued before ``run``
comes first on the device, the shards' work next, and what the caller
issues after ``run`` last, with no host sync, and memory freed on either
side is reused only behind the work that read it. A tensor one shard reads
from another inside a collective is waited for by event and marked with
``record_stream``.

Processes. Under a device span (``launch.multihost``) the axis spans every
process's shards: each collective's local sum is completed by one
``all_reduce`` over the process group (:class:`ReplicaAxis`), so the
algorithms' in-round reductions cross processes as the reference's do over
a global mesh.

Spans. A worker adopts the span open on the thread that called ``run``
(``utils.trace``), so the spans it opens name that span as their parent,
and a tensor fetched from another device counts its bytes in the open
span's ``copy_bytes``.

Failures. A shard that raises aborts the barrier, so the others leave any
collective they wait in with ``BrokenBarrierError``; ``run`` raises the
first shard's own error (not a broken barrier) once every worker has
returned, and resets the barrier for the next call. ``close`` stops the
threads (they are daemons, so an interpreter also exits without it).
"""
from __future__ import annotations

import queue
import threading
from contextlib import ExitStack
from typing import Any, Callable, Optional

import torch

from repro_torch.sharding.rules import mesh_devices
from repro_torch.utils import trace

_local = threading.local()   # the worker's shard index and bound axes


def shard_index() -> int:
    """The shard the calling worker thread runs (0 outside a worker)."""
    return getattr(_local, "shard", 0)


def bound_axis(name: str) -> "ReplicaAxis":
    """The axis ``name`` bound to the calling worker; raises outside one."""
    axes = getattr(_local, "axes", {})
    if name not in axes:
        raise RuntimeError(
            f"axis {name!r} is not bound: its collectives run only inside a shard "
            "executor's workers"
        )
    return axes[name]


def _event_on(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _ready(x) -> Optional[torch.cuda.Event]:
    """An event after the work that wrote ``x``, on the current stream."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return _event_on(torch.cuda.current_stream(x.device))
    return None


def _fetch(x, ev, device):
    """``x`` from another shard, on ``device``, ordered behind its writer."""
    if ev is not None:
        src = torch.cuda.current_stream(x.device)
        src.wait_event(ev)
        x.record_stream(src)
    if device is None or x.device == device:
        return x
    trace.add("copy_bytes", x.numel() * x.element_size())
    return x.to(device)


class ReplicaAxis:
    """The collectives over one mesh axis of ``size`` shards.

    ``cross`` — the device span's ``launch.multihost.MultihostContext``:
    the axis then runs over every process's shards (``size`` counts them
    all), and each collective's local sum, in shard order, is followed by
    one ``all_reduce`` over the process group, made by shard 0's worker,
    before any shard takes the result. Without it the path is the one
    process's."""

    def __init__(self, size: int, cross=None):
        self.local_size = int(size)
        self.cross = cross
        self.size = self.local_size * (len(cross.active_processes()) if cross else 1)
        self._barrier = threading.Barrier(self.local_size)
        self._slots: list = [None] * self.local_size
        self._results: dict = {}

    def _reduce(self, x, combine, op: str):
        if self.cross is not None:
            return self._reduce_across(x, combine, op)
        if self.size == 1:
            return x
        s = shard_index()
        device = x.device if isinstance(x, torch.Tensor) else None
        self._slots[s] = (x, _ready(x), device)
        self._barrier.wait()            # every partial deposited
        # the first shard of each device reduces for the shards on it, in
        # shard order
        leader = all(slot[2] != device for slot in self._slots[:s])
        if leader:
            total = None
            for t, ev, _ in self._slots:
                t = _fetch(t, ev, device)
                total = t if total is None else combine(total, t)
            self._results[device] = (total, _ready(total))
        self._barrier.wait()            # every result made, every slot read
        self._slots[s] = None
        total, ev = self._results[device]
        out = _fetch(total, ev, device)
        self._barrier.wait()            # every shard holds its result
        if leader:
            del self._results[device]
        return out

    def _reduce_across(self, x, combine, op: str):
        """The local sum in shard order on shard 0, then the process
        group's ``all_reduce``; every shard fetches the result."""
        if self.local_size == 1:
            return self.cross.all_reduce_tensor(x, op)
        s = shard_index()
        device = x.device if isinstance(x, torch.Tensor) else None
        self._slots[s] = (x, _ready(x), device)
        self._barrier.wait()            # every partial deposited
        if s == 0:
            total = None
            for t, ev, _ in self._slots:
                t = _fetch(t, ev, device)
                total = t if total is None else combine(total, t)
            total = self.cross.all_reduce_tensor(total, op)
            self._results["all"] = (total, _ready(total))
        self._barrier.wait()            # the result made, every slot read
        self._slots[s] = None
        total, ev = self._results["all"]
        out = _fetch(total, ev, device)
        self._barrier.wait()            # every shard holds its result
        if s == 0:
            del self._results["all"]
        return out

    def all_sum(self, x):
        """The sum of ``x`` over the shards, in shard order (tensors, on
        each shard's own device, or host numbers)."""
        return self._reduce(x, lambda a, b: a + b, "sum")

    def all_max(self, x):
        """The maximum of ``x`` over the shards."""
        return self._reduce(
            x, lambda a, b: torch.maximum(a, b) if isinstance(a, torch.Tensor) else max(a, b),
            "max")

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._barrier.reset()
        self._slots = [None] * self.local_size
        self._results = {}


class ShardExecutor:
    """One persistent worker thread per shard of ``mesh`` (module doc);
    ``cross`` extends its replica axis over the device span's processes
    (:class:`ReplicaAxis`)."""

    def __init__(self, mesh, axis_name: str, cross=None):
        self.mesh = mesh_devices(mesh)
        self.axis_name = axis_name
        self.axis = ReplicaAxis(len(self.mesh), cross)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.mesh]
        self._inbox = [queue.SimpleQueue() for _ in self.mesh]
        self._outbox: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = [
            threading.Thread(target=self._work, args=(s,), daemon=True,
                             name=f"shard-{s}-of-{len(self.mesh)}")
            for s in range(len(self.mesh))
        ]
        for t in self._threads:
            t.start()

    @property
    def size(self) -> int:
        return len(self.mesh)

    def run(self, fn: Callable[[int], Any]) -> list:
        """``fn(shard)`` on every shard at once; the results in shard
        order. Raises the first shard's own error."""
        if not self._threads:
            raise RuntimeError("this shard executor is closed")
        forks = {d: _event_on(torch.cuda.current_stream(d)) for d in set(self.mesh)
                 if d.type == "cuda"}
        parent = trace.current()
        for s, d in enumerate(self.mesh):
            self._inbox[s].put((fn, forks.get(d), parent))
        results: list = [None] * self.size
        errors: dict = {}
        for _ in range(self.size):
            s, ok, value = self._outbox.get()
            if ok:
                results[s] = value
            else:
                errors[s] = value
        if errors:
            self.axis.reset()
            first = min(errors, key=lambda s: (
                isinstance(errors[s], threading.BrokenBarrierError), s))
            raise errors[first]
        for s, (_, end) in enumerate(results):
            if end is not None:
                torch.cuda.current_stream(self.mesh[s]).wait_event(end)
        return [out for out, _ in results]

    def _work(self, s: int) -> None:
        _local.shard = s
        _local.axes = {self.axis_name: self.axis}
        device, stream = self.mesh[s], self.streams[s]
        while True:
            item = self._inbox[s].get()
            if item is None:
                return
            fn, fork, parent = item
            try:
                with ExitStack() as ctx:
                    ctx.enter_context(trace.adopt(parent))
                    if stream is not None:
                        ctx.enter_context(torch.cuda.device(device))
                        ctx.enter_context(torch.cuda.stream(stream))
                        stream.wait_event(fork)
                    out = fn(s)
                    end = None
                    if stream is not None:
                        end = _event_on(stream)
                self._outbox.put((s, True, (out, end)))
            except BaseException as e:  # noqa: BLE001 — surfaced by run()
                self.axis.abort()
                self._outbox.put((s, False, e))
            # hold nothing of the call between calls: the function closes
            # over its caller (a trainer and its tensors)
            item = fn = fork = parent = out = end = None

    def close(self) -> None:
        """Stop the worker threads."""
        threads, self._threads = self._threads, []
        for q in self._inbox[: len(threads)]:
            q.put(None)
        for t in threads:
            t.join()
