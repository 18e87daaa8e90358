"""The port's multi-process units against the reference's own tests
(tests/test_multihost.py), and the two packages on one fleet dir.

* The lease files and :class:`HeartbeatMonitor` under a fake clock: lease
  renewal, missed deadlines, flapping, rejoin backoff, tombstones, sticky
  status, the daemon renewal thread.
* :class:`FleetController` consuming monitor events through a stub trainer
  (the heartbeat -> eviction path, no injector).
* :class:`MultihostContext`: specs, slot blocks, the file exchange between
  two contexts in threads, the stale-peer drop, event agreement, the
  single-process short circuit, the fake-clock timeouts.
* Cross-package: a reference context and a port context on one fleet dir,
  in two threads: ``allreduce_sum``, ``allgather`` and ``agree_events``
  give identical results in both, and each reads the other's leases.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.fleet import (
    FaultEvent,
    FleetController,
    HeartbeatMonitor,
    read_leases,
    write_lease,
)
from repro_torch.launch.multihost import (
    MultihostSpec,
    ProcessCondemned,
    bootstrap,
    spec_from_env,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_monitor(tmp_path, clock, process_id=None, **kw):
    kw.setdefault("grace", 3.0)
    kw.setdefault("rejoin_backoff", 2)
    return HeartbeatMonitor(str(tmp_path), process_id=process_id, clock=clock, **kw)


def pair(tmp_path, **kw):
    """(clock, monitor of process 0, monitor of peer 1)."""
    clock = FakeClock()
    return clock, make_monitor(tmp_path, clock, 0, **kw), make_monitor(tmp_path, clock, 1)


# ---------------------------------------------------------------------------
# lease files


def test_write_and_read_leases(tmp_path):
    d = str(tmp_path)
    write_lease(d, 0, 1, megabatch=7)
    write_lease(d, 1, 4, status="leaving")
    (tmp_path / "junk.json").write_text("{not json")
    (tmp_path / "README").write_text("ignore me")
    leases = read_leases(d)
    assert set(leases) == {0, 1}
    assert leases[0]["megabatch"] == 7
    assert leases[1]["status"] == "leaving"


def test_write_lease_rejects_unknown_status(tmp_path):
    with pytest.raises(ValueError):
        write_lease(str(tmp_path), 0, 1, status="zombie")


# ---------------------------------------------------------------------------
# HeartbeatMonitor under a fake clock


def test_renewing_peer_stays_live(tmp_path):
    clock, mon, peer = pair(tmp_path)
    peer.renew(megabatch=0)
    for mb in range(5):
        mon.renew(megabatch=mb)
        assert mon.poll(mb) == []
        clock.advance(2.0)          # < grace, renewed every boundary
        peer.renew(megabatch=mb)
    assert mon.live_processes() == {0, 1}
    assert mon.last_megabatch(1) == 4


def test_missed_deadline_is_a_crash_reported_once(tmp_path):
    clock, mon, peer = pair(tmp_path)
    peer.renew()
    assert mon.poll(0) == []        # lease observed fresh
    clock.advance(3.5)              # > grace, never renewed
    events = mon.poll(1)
    assert [(e.kind, e.process) for e in events] == [("crash", 1)]
    assert mon.poll(2) == []        # dead peers are not reported again
    assert not mon.peer_fresh(1)


def test_flap_inside_grace_is_not_an_event(tmp_path):
    clock, mon, peer = pair(tmp_path)
    peer.renew()
    assert mon.poll(0) == []
    clock.advance(2.9)              # one long mega-batch, still in grace
    peer.renew()
    assert mon.poll(1) == []        # the renewal resets the staleness clock
    clock.advance(2.9)
    assert mon.poll(2) == []


def test_rejoin_waits_out_the_backoff(tmp_path):
    clock, mon, peer = pair(tmp_path)
    peer.renew()
    mon.poll(0)
    clock.advance(4.0)
    assert [e.kind for e in mon.poll(2)] == ["crash"]   # evicted at mb=2
    peer.renew()                    # the process is back...
    assert mon.poll(3) == []        # ...but 3 - 2 < rejoin_backoff (2)
    clock.advance(0.5)
    peer.renew()
    events = mon.poll(4)            # 4 - 2 >= backoff -> join
    assert [(e.kind, e.process) for e in events] == [("join", 1)]
    assert mon.poll(5) == []        # live again, nothing to report


@pytest.mark.parametrize("status,want", [("leaving", [("preempt", 1)]), ("done", [])])
def test_announced_status(tmp_path, status, want):
    """'leaving' is a preemption (reported once); 'done' is a clean exit,
    and staleness after it is no crash."""
    clock, mon, peer = pair(tmp_path)
    peer.renew(status=status)
    assert [(e.kind, e.process) for e in mon.poll(0)] == want
    clock.advance(10.0)
    assert mon.poll(1) == []
    if status == "done":
        assert 1 not in mon.live_processes()


def test_tombstone_outranks_a_fresh_lease(tmp_path):
    clock, mon, peer = pair(tmp_path)
    peer.renew()
    mon.poll(0)
    (tmp_path / "condemned" / "p1").write_text("")
    events = mon.poll(1)
    assert [(e.kind, e.process) for e in events] == [("crash", 1)]


def test_condemned_self_raises(tmp_path):
    clock, mon, _ = pair(tmp_path)
    mon.renew()
    (tmp_path / "condemned" / "p0").write_text("")
    with pytest.raises(RuntimeError, match="condemned"):
        mon.poll(0)


def test_background_renewal_thread_uses_real_time(tmp_path):
    mon = HeartbeatMonitor(str(tmp_path), process_id=0, interval=0.01)
    mon.renew(megabatch=0)
    first = read_leases(mon.leases_dir)[0]["counter"]
    mon.start()
    try:
        for _ in range(100):
            if read_leases(mon.leases_dir)[0]["counter"] > first:
                break
            time.sleep(0.02)
        else:
            pytest.fail("renewal thread never renewed")
    finally:
        mon.stop()


def test_renew_status_is_sticky(tmp_path):
    """Once a process announces 'leaving'/'done', later renewals that pass
    no status (the daemon loop's bare ``renew()``) keep republishing it."""
    clock = FakeClock()
    mon = make_monitor(tmp_path, clock, process_id=0)
    mon.renew(megabatch=1)
    assert read_leases(mon.leases_dir)[0]["status"] == "live"
    mon.renew(status="leaving")
    mon.renew(megabatch=2)          # a daemon-style renewal: no status
    lease = read_leases(mon.leases_dir)[0]
    assert lease["status"] == "leaving"
    assert lease["megabatch"] == 2  # liveness itself keeps flowing
    mon.renew(status="done")
    mon.renew()
    assert read_leases(mon.leases_dir)[0]["status"] == "done"


# ---------------------------------------------------------------------------
# FleetController consuming monitor events (stub trainer, no injector)


class _StubAlgo:
    resize_policy = "merge"


class _StubCfg:
    def __init__(self, n):
        self.n_replicas = n


class _StubTrainer:
    """Records membership calls; mimics the trainer's width bookkeeping."""

    def __init__(self, n):
        self.cfg = _StubCfg(n)
        self.algo = _StubAlgo()
        self.calls = []

    def remove_replicas(self, state, slots, merge_leavers=False):
        self.calls.append(("remove", tuple(slots), merge_leavers))
        self.cfg.n_replicas -= len(slots)
        return state

    def resize(self, state, n):
        self.calls.append(("resize", n))
        self.cfg.n_replicas = n
        return state

    def invalidate_prefetch(self):
        pass


SLOTS = {0: [0, 1], 1: [2, 3]}


def test_controller_evicts_dead_process_via_slot_map(tmp_path):
    clock, mon, peer = pair(tmp_path, slot_map=SLOTS)
    peer.renew()
    fleet = FleetController(monitor=mon, verbose=False)
    trainer = _StubTrainer(4)
    fleet.step(trainer, "state", 1)
    assert trainer.calls == []
    clock.advance(4.0)              # the peer dies silently
    fleet.step(trainer, "state", 2)
    assert trainer.calls == [("remove", (2, 3), False)]
    assert trainer.cfg.n_replicas == 2
    assert fleet.events[-1] == {"mb": 2, "action": "evict", "replica": [2, 3],
                                "reason": "crash", "graceful": False, "process": 1}
    # the monitor path queues no quarantine: no injector-style rejoin
    fleet.step(trainer, "state", 3)
    fleet.step(trainer, "state", 10)
    assert trainer.calls == [("remove", (2, 3), False)]


def test_controller_readmits_on_lease_resume(tmp_path):
    clock, mon, peer = pair(tmp_path, slot_map=SLOTS)
    peer.renew()
    fleet = FleetController(monitor=mon, max_replicas=8, verbose=False)
    trainer = _StubTrainer(4)
    fleet.step(trainer, "state", 1)
    clock.advance(4.0)
    fleet.step(trainer, "state", 2)         # evicted at mb=2
    peer.renew()                            # the lease resumes
    fleet.step(trainer, "state", 3)         # inside the backoff: nothing
    clock.advance(0.5)
    peer.renew()
    fleet.step(trainer, "state", 4)         # backoff elapsed: join
    assert trainer.calls == [("remove", (2, 3), False), ("resize", 4)]


def test_controller_preempt_merges_leavers(tmp_path):
    clock = FakeClock()
    mon = make_monitor(tmp_path, clock, process_id=0, slot_map={1: [2, 3]})
    write_lease(mon.leases_dir, 1, 1, status="leaving")
    fleet = FleetController(monitor=mon, verbose=False)
    trainer = _StubTrainer(4)
    fleet.step(trainer, "state", 1)
    assert trainer.calls == [("remove", (2, 3), True)]


def test_controller_respects_min_replicas(tmp_path):
    clock, mon, peer = pair(tmp_path, slot_map={1: [2, 3]})
    peer.renew()
    fleet = FleetController(monitor=mon, min_replicas=3, verbose=False)
    trainer = _StubTrainer(4)
    fleet.step(trainer, "state", 1)
    clock.advance(4.0)
    fleet.step(trainer, "state", 2)   # 4 - 2 < min_replicas: skipped
    assert trainer.calls == []
    assert trainer.cfg.n_replicas == 4
    assert fleet.events[-1]["action"] == "crash_skipped"


def test_controller_spanning_join_needs_restart(tmp_path):
    """A spanning trainer cannot take a returning process back: the join
    is logged as skipped."""
    clock, mon, peer = pair(tmp_path)
    fleet = FleetController(monitor=mon, verbose=False)
    trainer = _StubTrainer(2)
    trainer._span = object()
    trainer.process_slots = lambda pid: [2, 3]
    fleet._apply_event(trainer, "state", 5, FaultEvent("join", process=1))
    assert trainer.calls == []
    assert fleet.events == [{"mb": 5, "action": "join_skipped", "replica": None, "process": 1,
                             "reason": "spanning rejoin needs restart"}]


# ---------------------------------------------------------------------------
# MultihostContext: specs, slots, the file exchange


def test_spec_from_env_roundtrip(tmp_path):
    assert spec_from_env({}) is None
    env = {
        "REPRO_MH_NUM_PROCESSES": "2",
        "REPRO_MH_PROCESS_ID": "1",
        "REPRO_MH_FLEET_DIR": str(tmp_path),
    }
    assert spec_from_env(env) == MultihostSpec(num_processes=2, process_id=1,
                                               fleet_dir=str(tmp_path))
    env["REPRO_MH_LOCAL_DEVICES"] = "cpu,cpu"
    assert spec_from_env(env).local_devices == ("cpu", "cpu")
    with pytest.raises(ValueError):
        MultihostSpec(num_processes=2, process_id=5, fleet_dir=str(tmp_path))


@pytest.mark.parametrize("spanning,devices,want", [
    ("auto", ("cpu",), "host"), ("auto", ("cuda:0", "cuda:0"), "device"),
    ("host", ("cuda:0",), "host"), ("device", ("cpu",), "device")])
def test_auto_spanning_follows_the_device(tmp_path, spanning, devices, want):
    """``auto`` picks the device span for a process on a card and the host
    span on the CPU, as the reference picks by backend."""
    from repro_torch.launch.multihost import _resolve_spanning

    spec = MultihostSpec(2, 0, str(tmp_path), spanning=spanning, local_devices=devices)
    assert _resolve_spanning(spec) == want


def _ctx(tmp_path, pid, n=2):
    return bootstrap(MultihostSpec(num_processes=n, process_id=pid, fleet_dir=str(tmp_path),
                                   spanning="host"))


def test_slot_blocks(tmp_path):
    ctx = _ctx(tmp_path, 0)
    ctx.assign_slots(4)
    assert ctx.local_bounds() == (0, 2)
    assert ctx.bounds_of(1) == (2, 4)
    assert ctx.slots_of(1) == [2, 3]
    assert ctx.processes_for_slots([2, 3]) == [1]
    with pytest.raises(ValueError):
        ctx.processes_for_slots([1, 2])   # tears a block
    with pytest.raises(ValueError):
        ctx.assign_slots(3)               # not divisible
    with pytest.raises(ProcessCondemned):
        ctx.processes_for_slots([0, 1])   # dropping *our* block


def test_remove_process_renumbers_survivors_first(tmp_path):
    ctx = _ctx(tmp_path, 0, n=3)
    ctx.assign_slots(6)
    ctx.remove_process(1)
    assert ctx.active_processes() == [0, 2]
    assert 1 in ctx.condemned()
    ctx.assign_slots(4)
    assert ctx.bounds_of(0) == (0, 2)
    assert ctx.bounds_of(2) == (2, 4)


def _in_threads(*calls):
    """Run ``fn()`` of every call in its own thread; their results (or the
    exception each raised) in order."""
    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — the tests assert on it
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_exchange_allreduce_and_allgather(tmp_path):
    c0, c1 = _ctx(tmp_path, 0), _ctx(tmp_path, 1)

    def run(pid, ctx):
        tree = {"x": np.full(3, float(pid + 1)), "n": np.float64(pid)}
        return ctx.allreduce_sum("t", tree), ctx.allgather("g", np.asarray([pid]))

    results = _in_threads(lambda: run(0, c0), lambda: run(1, c1))
    for pid in (0, 1):
        (tree, contributors), gathered = results[pid]
        assert contributors == [0, 1]
        np.testing.assert_allclose(tree["x"], np.full(3, 3.0))
        assert float(tree["n"]) == 1.0
        assert sorted(gathered) == [0, 1]
        assert int(gathered[1][0]) == 1
    assert c0.stats["t"]["calls"] == 1 and c0.stats["t"]["bytes_written"] > 0


class _DeadPeerLiveness:
    """Exchange wait predicate stub: peer 1 is gone."""

    def __init__(self):
        self.condemned = []

    def peer_fresh(self, pid):
        return pid != 1

    def note_condemned(self, pid):
        self.condemned.append(pid)


def test_exchange_drops_stale_peer_and_condemns_it(tmp_path):
    ctx = _ctx(tmp_path, 0)
    liveness = _DeadPeerLiveness()
    ctx.attach_liveness(liveness)
    tree, contributors = ctx.allreduce_sum("t", {"x": np.ones(2)})
    assert contributors == [0]
    np.testing.assert_allclose(tree["x"], np.ones(2))
    assert liveness.condemned == [1]
    assert os.path.exists(os.path.join(str(tmp_path), "condemned", "p1"))
    # once condemned, a later exchange never waits for it again
    tree, contributors = ctx.allreduce_sum("t2", {"x": np.ones(2)})
    assert contributors == [0]


def test_agree_events_union_and_self_condemnation(tmp_path):
    c0, c1 = _ctx(tmp_path, 0), _ctx(tmp_path, 1)
    # process 0 proposes evicting process 1 (whose own view is clean): the
    # union reaches both; 0 applies it, 1 stops participating
    out = _in_threads(lambda: c0.agree_events([FaultEvent("crash", process=1)]),
                      lambda: c1.agree_events([]))
    assert [(e.kind, e.process) for e in out[0]] == [("crash", 1)]
    assert isinstance(out[1], ProcessCondemned)


def test_single_process_exchange_short_circuits(tmp_path):
    ctx = _ctx(tmp_path, 0, n=1)
    tree, contributors = ctx.allreduce_sum("t", {"x": np.ones(2)})
    assert contributors == [0]
    gathered = ctx.allgather("g", np.ones(1))
    assert list(gathered) == [0]
    assert not os.listdir(os.path.join(str(tmp_path), "xchg"))


def test_global_replica_devices_and_local_mesh(tmp_path):
    """The fleet's devices in (process, local index) order, the same list
    in every process; each process meshes its own devices."""
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.sharding.rules import global_replica_devices

    specs = [MultihostSpec(2, pid, str(tmp_path), spanning="host",
                           local_devices=("cpu",) * (pid + 1)) for pid in (0, 1)]
    ctxs = [bootstrap(spec) for spec in specs]
    got = _in_threads(*[(lambda c=c: global_replica_devices(c)) for c in ctxs])
    cpu = torch.device("cpu")
    assert got[0] == got[1] == [(0, cpu), (1, cpu), (1, cpu)]
    assert make_replica_mesh(2, multihost=ctxs[1]) == (cpu, cpu)
    assert make_replica_mesh(2, multihost=ctxs[0]) == (cpu,)


class _TwinProcess:
    """A device span's context stub: a second process holding the same
    partial, so the group's all_reduce doubles a sum and keeps a max."""

    def __init__(self):
        self.calls = []

    def active_processes(self):
        return [0, 1]

    def all_reduce_tensor(self, x, op="sum"):
        self.calls.append(op)
        return x * 2 if op == "sum" else x


@pytest.mark.parametrize("n_shards", [1, 3])
def test_replica_axis_completes_each_collective_across_processes(n_shards):
    """With ``cross`` the axis sums its shards in shard order, then makes
    one all_reduce (from shard 0) and hands every shard the result; its
    size counts every process's shards (the in-round means divide by it)."""
    from repro_torch.sharding.executor import ShardExecutor, bound_axis
    from repro_torch.utils import tree as tu

    twin = _TwinProcess()
    ex = ShardExecutor(("cpu",) * n_shards, "replica", cross=twin)
    try:
        def one(s):
            ax = bound_axis("replica")
            x = torch.full((2,), float(s + 1))
            mean = tu.tree_replica_mean_keepdims({"w": x.view(1, 2)}, "replica")["w"]
            return ax.size, ax.all_sum(x), ax.all_max(s == 0), mean

        outs = ex.run(one)
    finally:
        ex.close()
    local = sum(range(1, n_shards + 1))
    for size, total, anymax, mean in outs:
        assert size == 2 * n_shards
        torch.testing.assert_close(total, torch.full((2,), 2.0 * local))
        assert anymax is True
        torch.testing.assert_close(mean, torch.full((1, 2), 2.0 * local / (2 * n_shards)))
    assert twin.calls == ["sum", "sum", "max"]


def _fake_time(ctx):
    clock = FakeClock()
    ctx._clock = clock
    ctx._sleep = lambda dt: clock.advance(dt)   # sleeping advances the clock
    return clock


def test_rendezvous_times_out_on_fake_clock(tmp_path):
    """The rendezvous and exchange waits run on the injectable clock: a
    missing peer times out in virtual time, with no real sleeping."""
    ctx = _ctx(tmp_path, 0)
    clock = _fake_time(ctx)
    mon = make_monitor(tmp_path, clock, process_id=0)
    mon.renew()                      # own lease only; peer 1 never appears
    with pytest.raises(RuntimeError, match="rendezvous timed out"):
        ctx.rendezvous(timeout=5.0)
    assert clock.t >= 5.0


def test_exchange_times_out_on_fake_clock(tmp_path):
    ctx = _ctx(tmp_path, 0)
    clock = _fake_time(ctx)
    ctx.exchange_timeout = 5.0
    with pytest.raises(RuntimeError, match="timed out waiting for"):
        ctx.allreduce_sum("t", [np.ones(2)])  # peer 1 never contributes
    assert clock.t >= 5.0


# ---------------------------------------------------------------------------
# the two packages on one fleet dir


def _ref_ctx(tmp_path, pid):
    from repro.launch import multihost as jmh

    return jmh.bootstrap(jmh.MultihostSpec(num_processes=2, process_id=pid,
                                           fleet_dir=str(tmp_path), spanning="host"))


TREE = lambda pid: {  # noqa: E731
    "partial": {"w2": np.full((3, 2), pid + 0.5, np.float32),
                "b1": np.arange(4, dtype=np.float32) * (pid + 1),
                "blocks": [{"wq": np.ones(2, np.float32) * pid}, {"wo": np.zeros(1)}]},
    "mass": np.float64(0.25 * (pid + 1)),
}


@pytest.mark.parametrize("port_pid", [0, 1])
def test_port_and_reference_share_one_exchange(tmp_path, port_pid):
    """A port context and a reference context exchange through one fleet
    dir: ``allreduce_sum``, ``allgather`` and ``agree_events`` give
    identical results in both (the leaves numbered in one order)."""
    ref_pid = 1 - port_pid
    ctxs = {port_pid: _ctx(tmp_path, port_pid), ref_pid: _ref_ctx(tmp_path, ref_pid)}
    proposals = {0: [], 1: [FaultEvent("preempt", process=0, duration=3)]}

    def run(pid):
        ctx = ctxs[pid]
        total, contributors = ctx.allreduce_sum("merge", TREE(pid))
        gathered = ctx.allgather("norms", np.asarray([pid, 10 * pid], np.float64))
        if pid == ref_pid:
            from repro.core.fleet import FaultEvent as JFaultEvent

            events = [JFaultEvent(e.kind, process=e.process, duration=e.duration)
                      for e in proposals[pid]]
        else:
            events = proposals[pid]
        try:
            agreed = [(e.kind, e.process, e.duration) for e in ctx.agree_events(events)]
        except Exception as e:  # noqa: BLE001 — the condemned process raises
            agreed = type(e).__name__
        return total, contributors, gathered, agreed

    out = dict(zip((0, 1), _in_threads(lambda: run(0), lambda: run(1))))
    (t0, c0, g0, a0), (t1, c1, g1, a1) = out[0], out[1]
    assert c0 == c1 == [0, 1]
    want = {"w2": np.full((3, 2), 2.0, np.float32), "b1": np.arange(4, dtype=np.float32) * 3}
    for total in (t0, t1):
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(total["partial"][k]), v)
        np.testing.assert_array_equal(np.asarray(total["partial"]["blocks"][0]["wq"]), [1, 1])
        assert float(total["mass"]) == 0.75
    for g in (g0, g1):
        assert sorted(g) == [0, 1]
        np.testing.assert_array_equal(np.asarray(g[1]), [1.0, 10.0])
    # process 1 proposed evicting process 0: 0 stops, 1 applies it
    assert a0 == "ProcessCondemned"
    assert a1 == [("preempt", 0, 3)]


def test_port_and_reference_read_each_others_leases(tmp_path):
    from repro.core import fleet as jfleet

    clock = FakeClock()
    port_mon = make_monitor(tmp_path, clock, process_id=0)
    ref_mon = jfleet.HeartbeatMonitor(str(tmp_path), process_id=1, clock=clock, grace=3.0)
    port_mon.renew(megabatch=3)
    ref_mon.renew(megabatch=5)
    assert port_mon.poll(0) == [] and ref_mon.poll(0) == []
    assert port_mon.last_megabatch(1) == 5 and ref_mon.last_megabatch(0) == 3
    assert port_mon.live_processes() == ref_mon.live_processes() == {0, 1}
    clock.advance(4.0)
    ref_mon.renew(megabatch=6)       # the reference's process lives on
    assert [(e.kind, e.process) for e in ref_mon.poll(1)] == [("crash", 0)]
    assert port_mon.poll(1) == []
