"""The traced stretch of a ``--trace 1`` run: the profiler's device
operations, the benchmark's host spans, and the launches its wrappers
recorded, reduced to what the per-layer metrics read.

``device_busy_s`` is copied from ``chip_smoke.py``: busy time is the union
of the device operations' intervals, since kernels of several streams
overlap.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

SPAN_NAMES = ("stage", "dispatch", "collect", "merge", "eval")
WINDOW_SPAN = "traced_window"


@dataclass
class Profile:
    """What one traced stretch saw. Times in microseconds of the
    profiler's clock."""

    start_us: float = 0.0
    end_us: float = 0.0
    devices: tuple = ()
    ops: list = field(default_factory=list)      # (name, device index, start, end)
    spans: list = field(default_factory=list)    # (name, start, end) on the host
    launches: dict = field(default_factory=dict)  # kernel -> recorded calls


def union_us(intervals) -> tuple[float, list]:
    """(length of the union, its merged intervals) of (start, end) pairs."""
    spans = sorted((a, b) for a, b in intervals if b > a)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def device_busy_s(profile: Profile, device: int) -> float:
    """Seconds in which an operation ran on ``device`` in the stretch."""
    busy, _ = union_us((a, b) for _, d, a, b in profile.ops if d == device)
    return busy / 1e6


def read(prof, devices: tuple, launches: dict) -> Profile:
    """Reduce a stopped ``torch.profiler.profile`` to a :class:`Profile`."""
    return reduce(prof.events(), devices, launches)


def reduce(events, devices: tuple, launches: dict) -> Profile:
    """A :class:`Profile` of the profiler's events.

    The profiler copies every ``record_function`` range, the benchmark's
    and any the program opens, onto the device's timeline as a GPU user
    annotation. Such a copy is a span and no operation: it is left out by
    its kind, and by the name of a host range where the event does not
    say its kind."""
    from torch.autograd import DeviceType

    events = list(events)
    on_card = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    on_host = [e for e in events if getattr(e, "device_type", None) != DeviceType.CUDA]
    ranges = set(SPAN_NAMES) | {WINDOW_SPAN} | {
        e.name for e in on_host if getattr(e, "is_user_annotation", False)}
    out = Profile(devices=devices, launches=launches)
    for e in on_host:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name == WINDOW_SPAN:
            out.start_us, out.end_us = t0, t1
        elif e.name in SPAN_NAMES:
            out.spans.append((e.name, t0, t1))
    for e in on_card:
        if not (getattr(e, "is_user_annotation", False) or e.name in ranges):
            out.ops.append((e.name, int(e.device_index), e.time_range.start, e.time_range.end))
    return out


def device_ops(profile: Profile, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    total: dict = {}
    for name, _, a, b in profile.ops:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[n[:160], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(profile: Profile, top: int = 10) -> list:
    """[[span, seconds]]: the time no device ran an operation, by the host
    span that was open meanwhile (the innermost, else ``host``)."""
    _, busy = union_us((a, b) for _, _, a, b in profile.ops)
    gaps, t = [], profile.start_us
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, profile.end_us)))
        t = max(t, b)
    if t < profile.end_us:
        gaps.append((t, profile.end_us))
    by: dict = {}
    for g0, g1 in gaps:
        cut = sorted({g0, g1} | {x for _, a, b in profile.spans for x in (a, b) if g0 < x < g1})
        for a, b in zip(cut, cut[1:]):
            mid = (a + b) / 2
            open_ = [(s1 - s0, n) for n, s0, s1 in profile.spans if s0 <= mid < s1]
            name = min(open_)[1] if open_ else "host"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def spanned(name: str, fn):
    """``fn`` inside a profiler span named ``name``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return run
