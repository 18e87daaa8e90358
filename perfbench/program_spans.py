"""The program's own spans (``repro_torch.utils.trace``) placed on a traced
stretch's timeline, for the per-layer metrics that put the device's idle
time down to the host work inside the trainer that caused it.

``run.profile`` keeps the benchmark's spans only, on the profiler's clock;
the program's spans are on ``time.perf_counter_ns``. One offset maps the
one onto the other: the median difference between the starts of the pairs
of spans that wrap the same call (``PAIRS``: the benchmark's wrapper
outside, the program's span just inside), each kind paired from the last,
since the stretch ends the run. A placement is refused (``None``) with
fewer than ``MIN_PAIRS`` pairs, or where any pair's difference lies more
than ``MAX_RESIDUAL_US`` from the offset: a misaligned trace gives no
number rather than a wrong one. It is also refused where the stretch saw
no device operation, since there is no device timeline to place them on,
and where the program keeps no spans (an older program).

The device's idle time is the stretch less the union of its operations
over every card, as ``trace.idle_gaps`` takes it; each idle instant goes
to the innermost open span of ``IDLE_SPANS`` (the mega-batch's root, its
top-level layers and the evaluation), else to ``NONE``: the host outside
the trainer.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Optional

from perfbench import trace

PAIRS = {"stage": "trainer.stage", "dispatch": "trainer.dispatch",
         "collect": "trainer.collect"}
MIN_PAIRS = 8
MAX_RESIDUAL_US = 50.0
ROOT = "trainer.megabatch"
IDLE_SPANS = (ROOT, "trainer.stage", "trainer.dispatch", "trainer.adapt", "trainer.collect",
              "trainer.barrier", "trainer.eval", "trainer.eval.collect")
NONE = "none"


@dataclass
class Placed:
    """The program's spans that overlap the stretch, on the profiler's
    clock."""

    spans: list                 # (name, start_us, end_us, counters)
    offset_us: float
    worst_residual_us: float
    n_pairs: int
    stretch_start_us: float

    def started(self, name: str) -> list:
        """The counters of each ``name`` span that starts in the stretch
        (one open as it begins belongs to the mega-batch before)."""
        return [c for n, a, _, c in self.spans if n == name and a >= self.stretch_start_us]

    def megabatches(self) -> int:
        return len(self.started(ROOT))


def recorded() -> list:
    """The program's finished spans; none where it has no recorder."""
    try:
        from repro_torch.utils import trace as program_trace
    except ImportError:
        return []
    return program_trace.spans()


def pair_differences(profile: trace.Profile, spans: list) -> list:
    """Microseconds from each program span of ``PAIRS`` (its start on
    ``perf_counter``) to the start of the benchmark's span around it (on
    the profiler's clock), paired from the last."""
    diffs = []
    for bench, ours in PAIRS.items():
        outside = sorted(a for name, a, _ in profile.spans if name == bench)
        inside = sorted(s.start_ns for s in spans if s.name == ours)
        if outside and len(inside) >= len(outside):
            diffs += [a - b / 1e3 for a, b in zip(outside, inside[-len(outside):])]
    return diffs


def place(profile: Optional[trace.Profile], spans: list) -> Optional[Placed]:
    """``spans`` (the program's) on ``profile``'s clock, those that overlap
    the stretch; ``None`` where the module doc refuses."""
    if profile is None or not profile.ops:
        return None
    diffs = pair_differences(profile, spans)
    if len(diffs) < MIN_PAIRS:
        return None
    offset = statistics.median(diffs)
    worst = max(abs(d - offset) for d in diffs)
    if worst > MAX_RESIDUAL_US:
        return None
    placed = [(s.name, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset, s.counters)
              for s in spans]
    placed = [p for p in placed if p[1] < profile.end_us and p[2] > profile.start_us]
    return Placed(placed, offset, worst, len(diffs), profile.start_us)


def idle_split_us(profile: trace.Profile, placed: Placed) -> dict:
    """{span name or ``NONE``: device-idle microseconds under it}."""
    _, busy = trace.union_us((a, b) for _, _, a, b in profile.ops)
    gaps, t = [], profile.start_us
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, profile.end_us)))
        t = max(t, b)
    if t < profile.end_us:
        gaps.append((t, profile.end_us))
    opened = [(a, b, name) for name, a, b, _ in placed.spans if name in IDLE_SPANS]
    out = dict.fromkeys(IDLE_SPANS + (NONE,), 0.0)
    for g0, g1 in gaps:
        cut = sorted({g0, g1} | {x for a, b, _ in opened for x in (a, b) if g0 < x < g1})
        for a, b in zip(cut, cut[1:]):
            mid = (a + b) / 2
            inner = [(s1 - s0, name) for s0, s1, name in opened if s0 <= mid < s1]
            out[min(inner)[1] if inner else NONE] += b - a
    return out


def idle_ms(run, name: str, spans: Optional[list] = None) -> Optional[float]:
    """Device-idle milliseconds a mega-batch under the program's span
    ``name`` in ``run``'s traced stretch: the idle while ``name`` is the
    innermost open span of ``IDLE_SPANS``, so a child of it that is a
    member itself (``trainer.adapt`` under the sequential path's
    ``trainer.barrier``) keeps its own idle."""
    placed = place(run.profile, recorded() if spans is None else spans)
    if placed is None or not placed.megabatches():
        return None
    return idle_split_us(run.profile, placed)[name] / 1e3 / placed.megabatches()


def row_use_pct(run, spans: Optional[list] = None) -> Optional[float]:
    """100 x the rows the stretch's rounds computed that held a sample,
    over the rows they computed (``trainer.dispatch``'s counters)."""
    placed = place(run.profile, recorded() if spans is None else spans)
    if placed is None:
        return None
    counts = placed.started("trainer.dispatch")
    rows = sum(c.get("rows", 0) for c in counts)
    return 100.0 * sum(c.get("live_rows", 0) for c in counts) / rows if rows else None
