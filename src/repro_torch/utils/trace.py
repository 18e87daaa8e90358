"""The program's own spans: where the host's time goes inside a run.

A span is one piece of host work: its name, its start and end
(``time.perf_counter_ns``), the id of the span that opened it, the
mega-batch it belongs to (the id every span of one mega-batch shares), the
shard it ran for where there is one, and a small dict of counters and
attributes. Finished spans are kept in memory, in a bounded ring, newest
last; nothing is written unless a caller asks (``launch/train.py
--trace-out``).

Parents come from a per-thread stack of open spans; a span left without a
mega-batch or shard takes its parent's. A worker thread that runs work
another thread issued (``sharding.executor``) adopts the issuing span
(:func:`adopt`), so the spans it opens name that span as their parent.

While a ``torch.profiler`` session records on the calling thread, a span is
also entered as ``torch.profiler.record_function(name)``: it then lands on
the profiler's timeline, the clock of the device trace, so an exported
trace shows each gap on the device under the span the host was in. With no
session a span costs two clock reads and an append. The profiler records
per thread, so spans of the executor's workers stay off its timeline.

Tallies are counts a layer adds up on the device, with no host sync
(:func:`tally`: the MoE layer's assignments a held expert); the trainer
copies them to the host once a mega-batch, at its barrier, where it has
already waited for the device, and files them as counters of the
``trainer.barrier`` span (:func:`file_tallies`).

One recorder serves the process (``RECORDER``; the module's functions use
it): whoever reads after a run, the launcher or a benchmark, finds every
trainer's spans without a handle on the trainer.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

CAPACITY = 16384   # spans the ring keeps (about 16 a mega-batch)


class Span:
    """One span: a context manager that opens it on the calling thread and,
    on exit, files it in its recorder's ring; also a finished span as
    ``Recorder.spans`` returns it."""

    __slots__ = ("id", "name", "parent", "megabatch", "shard", "start_ns", "end_ns",
                 "counters", "_rec", "_rf")

    def __init__(self, rec: Optional["Recorder"], name: str, megabatch: Optional[int] = None,
                 shard: Optional[int] = None, counters: Optional[dict] = None):
        self._rec = rec
        self._rf = None
        self.id = next(rec._ids) if rec is not None else 0
        self.name = name
        self.parent = None
        self.megabatch = megabatch
        self.shard = shard
        self.counters = counters if counters is not None else {}
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.megabatch is None:
                self.megabatch = top.megabatch
            if self.shard is None:
                self.shard = top.shard
        stack.append(self)
        # the span holds its profiler range, and the clock is read before
        # the range's own cost
        self.start_ns = time.perf_counter_ns()
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.perf_counter_ns()
        self._rec._stack().pop()
        self._rec._file(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "megabatch": self.megabatch, "shard": self.shard,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "counters": dict(self.counters)}


# the ring's columns, one slot a finished span
_FIELDS = ("id", "name", "parent", "megabatch", "shard", "start_ns", "end_ns", "counters")


class Recorder:
    """A bounded ring of finished spans and each thread's stack of open
    ones.

    The ring is columns of plain values, not one object a span: a run then
    keeps no new object alive a span but its counters, so the garbage
    collector's youngest generation fills no faster than without spans
    (each of its passes walks the young objects, the staged mega-batch's
    cursor snapshot among them)."""

    def __init__(self):
        self._cols = {f: [None] * CAPACITY for f in _FIELDS}
        self._filed = 0                  # spans filed since the last clear
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()    # the ring's cursor and counters, from several threads
        self._tallies: dict = {}         # (name, device) -> [accumulator, summary]

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _file(self, span: Span) -> None:
        cols = self._cols
        with self._lock:     # a reader never sees a slot half written
            slot = self._filed % CAPACITY
            self._filed += 1
            for f in _FIELDS:
                cols[f][slot] = getattr(span, f)
            cols["counters"][slot] = span.counters or None

    def span(self, name: str, megabatch: Optional[int] = None, shard: Optional[int] = None,
             **counters) -> Span:
        """A span to enter with ``with``; ``counters`` start its dict."""
        return Span(self, name, megabatch, shard, counters)

    def current(self) -> Optional[Span]:
        """The innermost span open on the calling thread (or adopted)."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def adopt(self, span: Optional[Span]):
        """Open nothing, but make ``span`` (another thread's) the parent of
        what the calling thread opens inside."""
        if span is None:
            yield
            return
        stack = self._stack()
        stack.append(span)
        try:
            yield
        finally:
            stack.pop()

    def add(self, key: str, value) -> None:
        """Add ``value`` to counter ``key`` of the innermost open span (none
        open: dropped)."""
        top = self.current()
        if top is not None:
            with self._lock:
                top.counters[key] = top.counters.get(key, 0) + value

    def tally(self, name: str, counts: torch.Tensor, summary=None) -> None:
        """Add ``counts`` into the accumulator ``name`` on their device,
        with no host sync. ``summary(array) -> {counter: value}`` turns the
        sum into the counters :meth:`file_tallies` files (else one counter,
        ``name``, the total)."""
        key = (name, counts.device)
        with self._lock:
            slot = self._tallies.get(key)
            if slot is None or slot[0].shape != counts.shape:
                self._tallies[key] = [counts.detach().clone(), summary]
            else:
                slot[0].add_(counts.detach())

    def file_tallies(self) -> None:
        """Copy each accumulator to the host once (the caller has waited
        for the device, as the trainer has at its barrier), sum a name's
        over its devices, add its summary's counters to the innermost open
        span and start again from zero."""
        with self._lock:
            slots, self._tallies = self._tallies, {}
        sums: dict = {}
        for (name, _), (acc, summary) in slots.items():
            host = acc.cpu().numpy()
            sums[name] = [sums[name][0] + host if name in sums else host, summary]
        for name, (total, summary) in sums.items():
            counters = summary(total) if summary is not None else {name: total.sum().item()}
            for k, v in counters.items():
                self.add(k, v)

    def spans(self) -> list[Span]:
        """The finished spans the ring holds, in the order they ended."""
        cols = self._cols
        with self._lock:
            filed = self._filed
            rows = [[cols[f][i % CAPACITY] for f in _FIELDS]
                    for i in range(max(0, filed - CAPACITY), filed)]
        out = []
        for span_id, name, parent, megabatch, shard, start_ns, end_ns, counters in rows:
            s = Span(None, name, megabatch, shard, counters)
            s.id, s.parent, s.start_ns, s.end_ns = span_id, parent, start_ns, end_ns
            out.append(s)
        return out

    def clear(self) -> None:
        with self._lock:
            self._filed = 0

    def write_jsonl(self, path: str) -> int:
        """The ring as one JSON object a line; returns the count written."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict()) + "\n")
        return len(spans)


RECORDER = Recorder()
span = RECORDER.span
current = RECORDER.current
adopt = RECORDER.adopt
add = RECORDER.add
tally = RECORDER.tally
file_tallies = RECORDER.file_tallies
spans = RECORDER.spans
clear = RECORDER.clear
write_jsonl = RECORDER.write_jsonl
