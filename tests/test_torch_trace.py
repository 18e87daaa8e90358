"""The span recorder (``repro_torch.utils.trace``) and the trainer's spans.

* the recorder — parents from a per-thread stack, a worker thread adopting
  the issuing span, counters added from many threads, the bounded ring,
  ``record_function`` entered only while a profiler records;
* the trainer — on a tiny XML trainer, every mega-batch gives one of each
  span, on the overlap and the sequential paths, under vmap and on four CPU
  shards; children lie inside their parents and name them, worker spans
  carry their shard and the dispatch span; all spans of a mega-batch share
  its index;
* the counters — ``staging_log`` is the snapshot/plan/pack/upload spans'
  durations to the bit (the snapshot's only on a prefetch, else 0.0), and the sequential path holds one staging slot at a time,
  ``rows``/``live_rows`` the rounds' rows and the plan's samples,
  ``copy_bytes`` what crossed devices;
* the launcher's ``--trace-out``.
"""
from __future__ import annotations

import json
import sys
import threading

import pytest
import torch

from repro_torch.configs.base import ElasticConfig
from repro_torch.core.heterogeneity import SpeedModel
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset
from repro_torch.launch import train as launcher
from repro_torch.models.xml_mlp import XMLMLPConfig, make_model
from repro_torch.sharding import executor
from repro_torch.utils import trace

R, B_MAX, MEGA, N_MB = 4, 16, 6, 3
CPU4 = ("cpu",) * 4

# the spans every mega-batch opens once, those it opens once a shard, and
# the one a staging ahead of its mega-batch (the prefetch) opens
ONCE = {"trainer.megabatch", "trainer.stage", "trainer.plan", "trainer.pack",
        "trainer.upload", "trainer.dispatch", "trainer.adapt", "trainer.collect",
        "trainer.barrier", "trainer.guard", "trainer.merge", "trainer.merge.norms",
        "trainer.result"}
PER_SHARD = {"trainer.pack.shard", "trainer.dispatch.shard"}
AHEAD = {"trainer.snapshot"}

PARENT = {
    "trainer.stage": "trainer.megabatch", "trainer.snapshot": "trainer.stage",
    "trainer.plan": "trainer.stage",
    "trainer.pack": "trainer.stage", "trainer.upload": "trainer.stage",
    "trainer.pack.shard": "trainer.pack", "trainer.dispatch": "trainer.megabatch",
    "trainer.dispatch.shard": "trainer.dispatch", "trainer.collect": "trainer.megabatch",
    "trainer.barrier": "trainer.megabatch", "trainer.guard": "trainer.barrier",
    "trainer.merge": "trainer.barrier", "trainer.merge.norms": "trainer.merge",
    "trainer.result": "trainer.barrier",
}

PATHS = [
    pytest.param(True, None, id="overlap-vmap"),
    pytest.param(False, None, id="sync-vmap"),
    pytest.param(True, CPU4, id="overlap-sharded"),
    pytest.param(False, CPU4, id="sync-sharded"),
]


@pytest.fixture(autouse=True)
def _fresh_ring():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def _trainer(overlap=True, mesh=None):
    ds = make_xml_dataset(n_samples=768, n_features=128, n_classes=32, avg_nnz=8, seed=0)
    train, test = train_test_split(ds, 0.2, seed=0)
    provider = SparseProvider.make(train, seed=0)
    model = make_model(XMLMLPConfig(n_features=128, n_classes=32, hidden=16))
    cfg = ElasticConfig.from_bmax(B_MAX, algorithm="adaptive", n_replicas=R, mega_batch=MEGA,
                                  placement="vmap" if mesh is None else "sharded")
    tr = ElasticTrainer(model, provider, cfg, seed=0, speed=SpeedModel(R, max_gap=0.32, seed=0),
                        device="cpu" if mesh is None else None, mesh=mesh, overlap=overlap)
    return tr, provider.test_batches(test, B_MAX)


def _run(overlap=True, mesh=None):
    tr, test = _trainer(overlap, mesh)
    try:
        _, mlog = tr.run(N_MB, test_batches=test, eval_every=1)
    finally:
        tr.close()
    return tr, mlog.records, trace.spans()


def _by_megabatch(spans):
    out: dict = {}
    for s in spans:
        if s.name.startswith("trainer.eval"):
            continue
        out.setdefault(s.megabatch, []).append(s)
    return out


@pytest.mark.parametrize("overlap,mesh", PATHS)
def test_every_megabatch_gives_one_of_each_span(overlap, mesh):
    tr, records, spans = _run(overlap, mesh)
    n_shards = 1 if mesh is None else len(mesh)
    groups = _by_megabatch(spans)
    assert sorted(groups) == list(range(N_MB))
    for mb, group in groups.items():
        names = [s.name for s in group]
        assert {n: names.count(n) for n in ONCE} == dict.fromkeys(ONCE, 1), mb
        assert {n: names.count(n) for n in PER_SHARD} == dict.fromkeys(PER_SHARD, n_shards)
        # mega-batch 0 is staged when it runs; the pipeline stages the rest ahead
        ahead = overlap and mb > 0
        assert {n: names.count(n) for n in AHEAD} == dict.fromkeys(AHEAD, int(ahead))
        assert set(names) == ONCE | PER_SHARD | (AHEAD if ahead else set())
    evals = [s for s in spans if s.name == "trainer.eval"]
    collects = [s for s in spans if s.name == "trainer.eval.collect"]
    assert len(evals) == len(collects) == N_MB


@pytest.mark.parametrize("overlap,mesh", PATHS)
def test_children_lie_inside_their_parents_and_name_them(overlap, mesh):
    _, _, spans = _run(overlap, mesh)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("trainer.megabatch", "trainer.eval", "trainer.eval.collect"):
            assert s.parent is None, s.name
            continue
        p = by_id[s.parent]
        want = PARENT.get(s.name) or ("trainer.megabatch" if overlap else "trainer.barrier")
        assert p.name == want, (s.name, p.name)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
        # a staging ahead of its mega-batch is the next one's
        ahead = overlap and s.name == "trainer.stage" and s.megabatch != p.megabatch
        assert s.megabatch == p.megabatch + (1 if ahead else 0), s.name
    for name in PER_SHARD & {s.name for s in spans}:
        shards = sorted(s.shard for s in spans if s.name == name and s.megabatch == 0)
        assert shards == list(range(1 if mesh is None else len(mesh))), name
    # the spans the shards' workers opened under sharded name the dispatch
    # span the main thread issued them from, across threads
    for s in spans:
        if s.name == "trainer.dispatch.shard":
            assert by_id[s.parent].name == "trainer.dispatch" and s.shard is not None


def _assert_log_is_the_spans(log, spans, n_mb):
    assert [e["megabatch"] for e in log] == list(range(n_mb))
    for e in log:
        group = [s for s in spans if s.megabatch == e["megabatch"]]
        one = {s.name: s for s in group}
        assert e["plan_s"] == one["trainer.plan"].seconds
        assert e["pack_s"] == one["trainer.pack"].seconds
        assert e["upload_s"] == one["trainer.upload"].seconds
        snap = one.get("trainer.snapshot")
        assert e["snapshot_s"] == (0.0 if snap is None else snap.seconds)
        assert e["bytes"] > 0


@pytest.mark.parametrize("overlap,mesh", [(True, None), (False, None), (True, CPU4),
                                          (False, CPU4)])
def test_staging_log_is_the_staging_spans(overlap, mesh):
    tr, _, spans = _run(overlap, mesh)
    _assert_log_is_the_spans(list(tr.staging_log), spans, N_MB)


@pytest.mark.parametrize("overlap,mesh", PATHS)
def test_a_snapshot_span_opens_once_a_prefetch(overlap, mesh):
    """The cursor snapshot is a ``trainer.snapshot`` span inside the
    ``trainer.stage`` of each staging ahead of its mega-batch, and of no
    other; its seconds are the log entry's ``snapshot_s``, 0.0 for a
    staging that took none. A prefetch revoked by a stale (b, lr) is staged
    again without one."""
    tr, _, spans = _run(overlap, mesh)
    by_id = {s.id: s for s in spans}
    stages = [s for s in spans if s.name == "trainer.stage"]
    snaps = [s for s in spans if s.name == "trainer.snapshot"]
    ahead = [s for s in stages if s.megabatch != by_id[s.parent].megabatch]
    assert len(ahead) == (N_MB - 1 if overlap else 0)
    assert sorted(by_id[s.parent].id for s in snaps) == sorted(s.id for s in ahead)
    log = {e["megabatch"]: e["snapshot_s"] for e in tr.staging_log}
    for s in snaps:
        assert log[s.megabatch] == s.seconds > 0
    assert [log[s.megabatch] for s in stages if s not in ahead] == \
        [0.0] * (N_MB - len(ahead))
    if not overlap:
        return
    tr, _ = _trainer(overlap, mesh)
    try:
        state, _ = tr.run_megabatch(tr.init_state(), prefetch=True)
        state.lr = state.lr * 0.5                     # the staged plan goes stale
        trace.clear()
        tr.run_megabatch(state)
    finally:
        tr.close()
    assert [s.name for s in trace.spans()].count("trainer.snapshot") == 0
    assert tr.staging_log[-1]["snapshot_s"] == 0.0


@pytest.mark.parametrize("mesh", [None, CPU4], ids=["vmap", "sharded"])
def test_the_sequential_path_reuses_its_staging_slots(mesh):
    """Overlap off, six mega-batches: each staging finds no other slot in
    flight (the barrier released the last), no slot is allocated after the
    first two mega-batches, and each mega-batch logs one staging entry."""
    n_mb, held, allocations = 6, [], []
    tr, test = _trainer(False, mesh)
    acquire = tr._staging.acquire

    def counted(spec):
        out = acquire(spec)
        held.append(tr._staging._busy.count(True))
        return out

    class Probe:
        def maybe_save(self, trainer, state):
            allocations.append(trainer._staging.allocations)

        def wait(self):
            pass

    tr._staging.acquire = counted
    try:
        tr.run(n_mb, test_batches=test, checkpoint=Probe())
    finally:
        tr.close()
    assert held == [1] * n_mb
    assert tr._staging._busy == [False, False]
    assert allocations[1] == allocations[-1] == 2
    _assert_log_is_the_spans(list(tr.staging_log), trace.spans(), n_mb)


@pytest.mark.parametrize("overlap,mesh", PATHS)
def test_rows_live_rows_and_the_plan_counts(overlap, mesh):
    _, records, spans = _run(overlap, mesh)
    groups = _by_megabatch(spans)
    for mb, rec in enumerate(records):
        one = {s.name: s for s in groups[mb]}
        dispatch = one["trainer.dispatch"].counters
        assert dispatch["rows"] == rec["n_rounds"] * R * B_MAX
        # every sample of the mega-batch's plan sits in one live row
        assert dispatch["live_rows"] == MEGA * B_MAX < dispatch["rows"]


@pytest.mark.parametrize("mesh", [None, CPU4])
def test_a_merge_on_one_device_copies_nothing_between_devices(mesh):
    _, _, spans = _run(True, mesh)
    merges = [s for s in spans if s.name == "trainer.merge"]
    assert len(merges) == N_MB
    # one device (four CPU shards share it): nothing crosses between cards
    assert [s.counters for s in merges] == [{"copy_bytes": 0}] * N_MB


def test_a_fetch_from_another_device_counts_its_bytes():
    x = torch.ones(10)
    with trace.span("outer", copy_bytes=0) as s:
        executor._fetch(x, None, torch.device("cpu"))
        assert s.counters["copy_bytes"] == 0
        executor._fetch(x, None, torch.device("meta"))
    assert s.counters["copy_bytes"] == 40


def test_each_span_is_a_profiler_range_while_one_records():
    tr, test = _trainer()
    try:
        state = tr.init_state()
        state, _ = tr.run_megabatch(state, prefetch=True)
        trace.clear()
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            state, _ = tr.run_megabatch(state, prefetch=True)
            tr.evaluate_async(state.global_model, test)()
    finally:
        tr.close()
    ours: dict = {}
    for s in trace.spans():
        ours[s.name] = ours.get(s.name, 0) + 1
    ranges: dict = {}
    for e in prof.events():
        if e.name.startswith("trainer."):
            ranges[e.name] = ranges.get(e.name, 0) + 1
    assert ranges == ours
    assert set(ours) == ONCE | PER_SHARD | AHEAD | {"trainer.eval", "trainer.eval.collect"}


def test_no_profiler_no_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    tr, _ = _trainer()
    try:
        state = tr.init_state()
        tr.run_megabatch(state, prefetch=True)
    finally:
        tr.close()
    assert trace.spans() and calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert calls == ["probe"]


def test_parents_counters_and_megabatch_come_from_the_stack():
    rec = trace.Recorder()
    with rec.span("root", megabatch=7, shard=2, samples=3) as root:
        with rec.span("child", rows=5) as child:
            rec.add("bytes", 4)
            rec.add("bytes", 6)
        with rec.span("ahead", megabatch=8) as ahead:
            pass
    assert root.parent is None and root.counters == {"samples": 3}
    assert (child.parent, child.megabatch, child.shard) == (root.id, 7, 2)
    assert child.counters == {"rows": 5, "bytes": 10}
    assert (ahead.parent, ahead.megabatch) == (root.id, 8)
    # the ring holds finished spans in the order they ended
    assert [s.name for s in rec.spans()] == ["child", "ahead", "root"]
    assert rec.current() is None
    rec.add("dropped", 1)   # no span open: nothing to add to
    assert rec.spans()[-1].as_dict()["counters"] == {"samples": 3}


def test_a_worker_thread_adopts_the_issuing_span():
    rec = trace.Recorder()
    seen = {}

    def work(parent):
        with rec.adopt(parent):
            with rec.span("worker", shard=1) as s:
                seen["span"] = s
        seen["after"] = rec.current()

    with rec.span("issue", megabatch=3) as issue:
        t = threading.Thread(target=work, args=(rec.current(),))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert rec.current() is issue
    s = seen["span"]
    assert (s.parent, s.megabatch, s.shard) == (issue.id, 3, 1)
    assert seen["after"] is None


def test_counters_added_from_many_threads_lose_nothing():
    rec = trace.Recorder()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.span("shared", copy_bytes=0) as shared:
            def work():
                with rec.adopt(shared):
                    for _ in range(n_adds):
                        rec.add("copy_bytes", 1)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert shared.counters["copy_bytes"] == n_threads * n_adds


def test_a_reader_never_sees_a_span_half_filed():
    rec = trace.Recorder()
    n_threads, n_spans = 8, 3000       # past the ring's capacity: slots are reused
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    torn, done = [], threading.Event()

    def file(t):
        for i in range(n_spans):
            k = t * n_spans + i
            with rec.span(f"s{k}", megabatch=k, shard=k, n=k):
                pass

    def read():
        while not done.is_set():
            torn.extend(s.as_dict() for s in rec.spans()
                        if not s.name == f"s{s.megabatch}" == f"s{s.shard}"
                        == f"s{s.counters['n']}" or s.end_ns < s.start_ns)

    try:
        reader = threading.Thread(target=read)
        reader.start()
        threads = [threading.Thread(target=file, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        reader.join(timeout=120)
        assert not reader.is_alive() and not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert torn == []
    assert len(rec.spans()) == min(trace.CAPACITY, n_threads * n_spans)


def test_the_ring_stays_bounded():
    rec = trace.Recorder()
    for i in range(trace.CAPACITY + 10):
        with rec.span("s", megabatch=i):
            pass
    kept = rec.spans()
    assert len(kept) == trace.CAPACITY
    assert [kept[0].megabatch, kept[-1].megabatch] == [10, trace.CAPACITY + 9]
    rec.clear()
    assert rec.spans() == []


def test_the_launcher_writes_the_spans_as_json_lines(tmp_path):
    out = tmp_path / "spans.jsonl"
    launcher.main(["--workload", "xml", "--device", "cpu", "--megabatches", "2",
                   "--samples", "512", "--features", "128", "--classes", "32",
                   "--avg-nnz", "8", "--hidden", "16", "--b-max", "16", "--mega-batch", "4",
                   "--trace-out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == len(trace.spans())
    roots = [x for x in lines if x["name"] == "trainer.megabatch"]
    assert [x["megabatch"] for x in roots] == [0, 1]
    assert all(set(x) == {"id", "name", "parent", "megabatch", "shard", "start_ns", "end_ns",
                          "counters"} for x in lines)
    assert all(x["end_ns"] >= x["start_ns"] for x in lines)
    merge = next(x for x in lines if x["name"] == "trainer.merge")
    assert merge["counters"] == {"copy_bytes": 0}
