"""The reference's interleaving regressions (tests/test_interleave.py)
against the port's units, under ``tools.jaxlint.interleave.
InterleaveSentinel`` (stdlib only): a cooperative scheduler that serializes
the threads and picks the next one at every traced line from a seed, so
every seed replays one schedule exactly.

* ``HeartbeatMonitor.renew``: a daemon renewal racing an announced
  ``status="leaving"`` never publishes "live" last (the status is sticky,
  under the monitor's lock).
* ``CheckpointManager._reraise``: a writer-thread error is claimed by
  exactly one caller (the check and the clear are one locked step).
* ``ShardWindowTimer.mark_start``: two start markers for one shard take
  exactly one timestamp (the first wins, atomically).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from tools.jaxlint.interleave import InterleaveSentinel  # noqa: E402

SEEDS = range(8)


def _lease_status(mon):
    from repro_torch.core.fleet import LEASE_PREFIX

    path = os.path.join(mon.leases_dir, f"{LEASE_PREFIX}{mon.process_id}.json")
    with open(path) as f:
        return json.load(f)["status"]


@pytest.mark.parametrize("seed", SEEDS)
def test_daemon_renewal_cannot_resurrect_announced_departure(tmp_path, seed):
    from repro_torch.core.fleet import HeartbeatMonitor

    mon = HeartbeatMonitor(str(tmp_path), process_id=0)
    sent = InterleaveSentinel(seed=seed, trace=("repro_torch/core/fleet.py",))
    mon._lock = sent.lock("monitor")  # cooperative: the scheduler keeps control
    sent.spawn("main", mon.renew, status="leaving")
    sent.spawn("daemon", mon.renew)   # the background loop's bare renew()
    sent.run()
    assert _lease_status(mon) == "leaving"


@pytest.mark.parametrize("seed", SEEDS)
def test_checkpoint_error_claimed_exactly_once(tmp_path, monkeypatch, seed):
    from repro_torch.checkpoint import store as store_mod
    from repro_torch.checkpoint.store import CheckpointError, CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    sent = InterleaveSentinel(seed=seed, trace=("repro_torch/checkpoint/store.py",))
    mgr._lock = sent.lock("store")

    def failing_save(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(store_mod, "save", failing_save)
    caught = []

    def reader(tag):
        try:
            mgr._reraise()
        except CheckpointError:
            caught.append(tag)

    sent.spawn("writer", mgr._write_job, str(tmp_path / "ckpt"), {}, {}, {})
    sent.spawn("r1", reader, "r1")
    sent.spawn("r2", reader, "r2")
    sent.run()
    pending = 1 if mgr._error is not None else 0
    assert len(caught) + pending == 1, (caught, mgr._error)


@pytest.mark.parametrize("seed", SEEDS)
def test_shard_timer_first_start_marker_wins_atomically(seed):
    from repro_torch.core.heterogeneity import ShardWindowTimer

    calls = []

    def fake_timer():
        calls.append(len(calls))
        return float(len(calls))

    t = ShardWindowTimer(timer=fake_timer)
    sent = InterleaveSentinel(seed=seed, trace=("repro_torch/core/heterogeneity.py",))
    t._lock = sent.lock("timer")
    t.reset(1)
    sent.spawn("cb1", t.mark_start, 0)
    sent.spawn("cb2", t.mark_start, 0)
    sent.run()
    assert len(calls) == 1, f"{len(calls)} timestamps for one shard"
    t.mark_end(0)
    w = t.take()
    assert w is not None and np.all(w > 0)
