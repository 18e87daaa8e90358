"""The readers that place the program's spans on the traced stretch
(``perfbench/program_spans.py``): a synthetic profile and synthetic program
spans with a known offset give back the offset and the idle split; a
misaligned trace, too few pairs or no device give no number; and in a CPU
traced run each benchmark span pairs with the program span it wraps."""
import time
from dataclasses import dataclass, field

import pytest
import torch
from conftest import tiny_cell

from perfbench import harness, program_spans, spec, trace
from perfbench.harness import Run

OFFSET_US = 5_000_000.0    # the profiler's clock minus the program's
MB_US = 1100.0             # one mega-batch and the host's 100 us after it
N_MB = 8


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    counters: dict = field(default_factory=dict)


def _program(n_mb=N_MB, adapt=(60, 70)):
    """Program spans of ``n_mb`` mega-batches, on the program's clock:
    from a mega-batch's start t (us, the profiler's), dispatch [10, 60),
    adapt [60, 70) (or ``adapt``), stage [70, 300), collect [300, 700),
    barrier [700, 950), the root [0, 1000)."""
    spans = []
    for k in range(n_mb):
        t = k * MB_US
        for name, a, b in (("trainer.megabatch", 0, 1000), ("trainer.dispatch", 10, 60),
                           ("trainer.adapt", *adapt), ("trainer.stage", 70, 300),
                           ("trainer.plan", 70, 120), ("trainer.collect", 300, 700),
                           ("trainer.barrier", 700, 950), ("trainer.merge", 720, 900)):
            counters = {"rows": 100, "live_rows": 83} if name == "trainer.dispatch" else {}
            spans.append(Span(name, int((t + a - OFFSET_US) * 1e3 + 1e12),
                              int((t + b - OFFSET_US) * 1e3 + 1e12), counters))
    return spans


def _profile(n_mb=N_MB, jitter=(-3.0, 0.0, 3.0), late=None):
    """The benchmark's spans around the program's (``jitter`` us early or
    late, one pair ``late`` us more), and the device busy on [50, 200),
    [250, 690) and [800, 900) of every mega-batch: idle under dispatch 40,
    stage 50, collect 10, barrier 150 (of them 100 under the merge), the
    root's own time 60, and 100 outside the trainer."""
    spans, ops = [], []
    i = 0
    for k in range(n_mb):
        t = k * MB_US - 1e6
        for name, a in (("dispatch", 10), ("stage", 70), ("collect", 300)):
            shift = jitter[i % len(jitter)] + (late if late is not None and i == 5 else 0.0)
            spans.append((name, t + a + shift, t + a + 100))
            i += 1
        for a, b in ((50, 200), (250, 690), (800, 900)):
            ops.append(("kernel", 0, t + a, t + b))
    start = -1e6
    return trace.Profile(start_us=start, end_us=start + n_mb * MB_US,
                         devices=(torch.device("cuda", 0),), ops=ops, spans=spans)


def _run(profile):
    return Run(config={}, devices=(torch.device("cuda", 0),), profile=profile)


def test_the_offset_and_the_idle_split_come_back():
    profile = _profile()
    placed = program_spans.place(profile, _program())
    # the offset maps the program's clock (1e12 ns ahead) onto the stretch's
    assert placed.offset_us == pytest.approx(OFFSET_US - 1e9 - 1e6)
    assert placed.worst_residual_us == pytest.approx(3.0)
    assert placed.n_pairs == 3 * N_MB and placed.megabatches() == N_MB
    split = program_spans.idle_split_us(profile, placed)
    assert split == pytest.approx({k: v * N_MB for k, v in WANT.items()})
    # the terms add up to the stretch's idle time
    busy = trace.device_busy_s(profile, 0) * 1e6
    assert sum(split.values()) == pytest.approx(profile.end_us - profile.start_us - busy)


WANT = {"trainer.dispatch": 40, "trainer.stage": 50, "trainer.collect": 10,
        "trainer.barrier": 150, "trainer.megabatch": 60, "none": 100,
        "trainer.adapt": 0, "trainer.eval": 0, "trainer.eval.collect": 0}


def test_a_member_inside_another_keeps_its_own_idle():
    """The sequential path opens ``trainer.adapt`` inside
    ``trainer.barrier``: the idle under adapt is adapt's, the rest of the
    barrier's idle the barrier's."""
    profile = _profile()
    placed = program_spans.place(profile, _program(adapt=(720, 790)))
    split = program_spans.idle_split_us(profile, placed)
    want = dict(WANT, **{"trainer.adapt": 70, "trainer.barrier": 80})
    assert split == pytest.approx({k: v * N_MB for k, v in want.items()})


def test_a_span_open_as_the_stretch_begins_keeps_its_idle():
    """A stretch that begins inside the first mega-batch's barrier: that
    barrier's idle after the start counts, and so does its root's; the
    divisor counts the mega-batches that start in the stretch."""
    profile = _profile()
    profile.start_us += 750.0
    placed = program_spans.place(profile, _program())
    assert placed.megabatches() == N_MB - 1
    split = program_spans.idle_split_us(profile, placed)
    # the first mega-batch from 750: the barrier idle on [750, 800) and
    # [900, 950), the root's own [950, 1000), the host's [1000, 1100)
    first = {"trainer.barrier": 100, "trainer.megabatch": 50, "none": 100}
    want = {k: v * (N_MB - 1) + first.get(k, 0) for k, v in WANT.items()}
    assert split == pytest.approx(want)
    run = _run(profile)
    assert program_spans.idle_ms(run, "trainer.barrier", _program()) == pytest.approx(
        want["trainer.barrier"] / 1e3 / (N_MB - 1))
    assert program_spans.row_use_pct(run, _program()) == pytest.approx(83.0)


def test_the_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", _program)
    run = _run(_profile())
    assert spec.reader("idle_ms.staging")(run) == pytest.approx(0.050)
    assert spec.reader("idle_ms.dispatch")(run) == pytest.approx(0.040)
    assert spec.reader("idle_ms.barrier")(run) == pytest.approx(0.150)
    assert spec.reader("row_use_pct")(run) == pytest.approx(83.0)


@pytest.mark.parametrize("case", ["late_pair", "too_few_pairs", "no_device", "no_spans",
                                  "no_profile"])
def test_no_number_rather_than_a_wrong_one(case, monkeypatch):
    spans, profile = _program(), _profile()
    if case == "late_pair":
        profile = _profile(late=60.0)
    elif case == "too_few_pairs":
        spans, profile = _program(2), _profile(2)      # 6 pairs
    elif case == "no_device":
        profile.ops = []
    elif case == "no_spans":
        spans = []
    else:
        profile = None
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    run = _run(profile)
    assert program_spans.place(profile, spans) is None
    for name in ("idle_ms.staging", "idle_ms.dispatch", "idle_ms.barrier", "row_use_pct"):
        assert spec.reader(name)(run) is None


def test_a_late_pair_just_inside_the_limit_still_places():
    assert program_spans.place(_profile(late=45.0), _program()) is not None


def test_the_program_span_names_are_not_the_benchmarks():
    ours = set(program_spans.IDLE_SPANS) | set(program_spans.PAIRS.values())
    assert not ours & (set(trace.SPAN_NAMES) | {trace.WINDOW_SPAN})
    assert all(name.startswith("trainer.") for name in ours)


def test_a_real_profilers_spans_pair_with_the_programs(monkeypatch):
    """A CPU traced run: each benchmark span of ``PAIRS`` is paired with the
    program span it wraps, from the last: the gaps between consecutive
    starts agree on both clocks (to 1% and 50 us: a loaded CPU may set the
    profiler's clock rate a little off, which a card's run did not show)."""
    runs = []
    reader = spec.reader

    def capture(name, root=spec.ROOT):
        read = reader(name, root)

        def run(r):
            runs.append(r)
            return read(r)
        return run

    monkeypatch.setattr(spec, "reader", capture)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny_cell("adaptive-1gpu")
        harness.execute(cell, 2**31 + 5, 0.5, True, (torch.device("cpu"),),
                        time.perf_counter())
    finally:
        torch.set_num_threads(n)
    profile, spans = runs[0].profile, program_spans.recorded()
    assert len(program_spans.pair_differences(profile, spans)) == 3 * harness.TRACE_MEGABATCHES
    for bench, ours in program_spans.PAIRS.items():
        outside = sorted(a for name, a, _ in profile.spans if name == bench)
        inside = sorted(s.start_ns / 1e3 for s in spans if s.name == ours)[-len(outside):]
        for (a0, a1), (b0, b1) in zip(zip(outside, outside[1:]), zip(inside, inside[1:])):
            assert abs((a1 - a0) - (b1 - b0)) < 0.01 * (a1 - a0) + 50.0, bench
