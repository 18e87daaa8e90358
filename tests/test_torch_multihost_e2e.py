"""Multi-process fleets of the port end to end on the CPU, through the
spawner (``python -m repro_torch.launch.multihost_launch``): two trainer
processes, two CPU shards each, global R = 4, at the reference's e2e
widths (tests/test_multihost.py). Marked ``slow`` like the reference's own
e2e tests; each subprocess has a timeout.

* A host-span fleet against the port's single-process sharded run through
  its launcher: identical u and b, losses within the reference's bound
  (2e-3 relative, tests/test_multihost.py); and u and b identical to the
  reference's single-process sharded run through its launcher (the
  reference's losses start from its own JAX-drawn weights; the trainer
  tests hold the fleet to them from shared weights within 1e-5).
* The heartbeat drill: process 1 SIGKILLed once its lease reports
  mega-batch 2; the survivor evicts its slots through the heartbeat ->
  FleetController path (``action=evict``, ``process=1``, reason crash) and
  finishes at R = 2 with finite losses.
* A device-span fleet over gloo (``torch.distributed``; in-round
  collectives across the processes) of ``sync`` and ``adaptive`` against
  the single-process run: records (``--out``) with identical host
  decisions and losses within 1e-5.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEGABATCHES = 5
LOSS_RE = re.compile(r"\[repro\] \[(\w+)\] mb=(\d+) loss=([^ ]+) acc=[^ ]+ u=(\[[^\]]*\]) "
                     r"b=(\[[^\]]*\])")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.join(ROOT, "src"),
                                                    env.get("PYTHONPATH")) if p)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env.setdefault("OMP_NUM_THREADS", "1")
    for k in [k for k in env if k.startswith("REPRO_MH_")]:
        del env[k]
    env.update(extra)
    return env


def _workload(algo="adaptive", megabatches=MEGABATCHES):
    return ["--workload", "xml", "--samples", "1024", "--features", "256", "--classes", "64",
            "--hidden", "32", "--b-max", "32", "--mega-batch", "6", "--replicas", "4",
            "--algorithm", algo, "--megabatches", str(megabatches), "--seed", "0"]


def _records(text):
    """{mb: (loss, u, b)} of the launcher's progress lines."""
    return {int(m.group(2)): (float(m.group(3)), json.loads(m.group(4)), json.loads(m.group(5)))
            for m in LOSS_RE.finditer(text)}


def _single(args, module="repro_torch.launch.train", **env):
    res = subprocess.run([sys.executable, "-u", "-m", module, *args], capture_output=True,
                         text=True, env=_env(**env), timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _launch(tmp_path, extra, train_args):
    fleet_dir = str(tmp_path / "fleet")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost_launch", "--procs", "2",
         "--devices-per-proc", "2", "--fleet-dir", fleet_dir, "--timeout", "500", *extra,
         "--", *train_args],
        capture_output=True, text=True, env=_env(), timeout=600)
    logs = {}
    for pid in (0, 1):
        path = os.path.join(fleet_dir, "logs", f"proc{pid}.log")
        logs[pid] = open(path).read() if os.path.exists(path) else ""
    return res, logs


@pytest.mark.slow
def test_two_process_run_matches_single_process_trajectory(tmp_path):
    cpu = ["--device", "cpu"]
    port = _records(_single(_workload() + cpu + ["--placement", "sharded"]).stderr)
    ref = _records(_single(_workload() + ["--placement", "sharded", "--multihost", "off"],
                           module="repro.launch.train",
                           XLA_FLAGS="--xla_force_host_platform_device_count=4").stderr)
    assert sorted(port) == sorted(ref) == list(range(1, MEGABATCHES + 1))
    res, logs = _launch(tmp_path, [], _workload() + cpu)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    for pid in (0, 1):
        assert "spanning=host" in logs[pid], logs[pid][-2000:]
        got = _records(logs[pid])
        assert sorted(got) == list(range(1, MEGABATCHES + 1)), logs[pid][-2000:]
        for mb, (loss, u, b) in port.items():
            assert got[mb][1:] == (u, b) == ref[mb][1:], (pid, mb, got[mb], port[mb], ref[mb])
            assert abs(got[mb][0] - loss) <= 2e-3 * (1 + abs(loss)), (pid, mb, got[mb], loss)


@pytest.mark.slow
def test_sigkill_heals_through_heartbeat_path(tmp_path):
    res, logs = _launch(
        tmp_path, ["--kill-proc", "1", "--kill-after-mb", "2"],
        _workload(megabatches=8) + ["--device", "cpu", "--heartbeat-interval", "0.3",
                                    "--heartbeat-grace", "2.0"])
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "proc 1: killed (expected)" in res.stdout
    survivor = logs[0]
    # the eviction came from the heartbeat -> FleetController path
    assert re.search(r"action=evict replica=\[2, 3\] reason=crash .*process=1", survivor), \
        survivor[-3000:]
    got = _records(survivor)
    assert sorted(got) == list(range(1, 9)), survivor[-3000:]
    assert all(math.isfinite(loss) for loss, _, _ in got.values())
    assert len(got[8][1]) == 2            # finished at R = 2
    assert "final" in survivor and "fleet events=1 replicas=2" in survivor


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["sync", "adaptive"])
def test_device_span_over_gloo_matches_single_process(tmp_path, algo):
    args = _workload(algo, megabatches=3) + ["--device", "cpu"]
    single_out = tmp_path / "single.json"
    _single(args + ["--placement", "sharded", "--out", str(single_out)])
    res, logs = _launch(tmp_path, ["--spanning", "device"],
                        args + ["--out", str(tmp_path / "span{pid}.json")])
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    want = json.loads(single_out.read_text())
    exact = ("n_replicas", "u", "b", "lr", "alphas", "n_rounds", "virtual_time", "pert_active")
    for pid in (0, 1):
        assert "spanning=device" in logs[pid] and "backend=gloo" in logs[pid], logs[pid][-2000:]
        got = json.loads((tmp_path / f"span{pid}.json").read_text())
        assert len(got) == len(want) == 3
        for rec, wrec in zip(got, want):
            for k in exact:
                assert rec[k] == wrec[k], (pid, rec["megabatch"], k, rec[k], wrec[k])
            for k in ("train_loss", "train_accuracy", "test_loss", "accuracy"):
                assert abs(rec[k] - wrec[k]) <= 1e-5 * (1 + abs(wrec[k])), (pid, k, rec, wrec)
