"""Spawn an N-process training fleet of the port on one machine.

Port of ``scripts/multihost_launch.py``. Starts N fresh interpreters of
``python -m repro_torch.launch.train`` with the ``REPRO_MH_*`` bootstrap
environment (process id, fleet size, the shared fleet dir, the spanning
mode and each process's local devices). The processes rendezvous through
the fleet dir's heartbeat leases and exchange merge and metric partials
through its file exchange (host span), or join one ``torch.distributed``
group (device span).

Local devices (``REPRO_MH_LOCAL_DEVICES``), ``--devices-per-proc K``:

* with ``--device cpu`` among the train arguments: K ``cpu`` entries, K
  logical shards on the CPU;
* on cards, when at least ``--procs`` are visible: process p gets its own
  block of them through ``CUDA_VISIBLE_DEVICES`` (``min(K, cards //
  procs)`` cards, repeated to K shards);
* otherwise every process gets ``cuda:0``, K times: the processes share
  the card (a device span then runs over gloo).

Each child is a new interpreter (never a fork of a process that touched
CUDA). Every ``{pid}`` in the train arguments becomes the process's id (a
file of its own for ``--out``). A given ``--fleet-dir`` holds one run: the
leases, tombstones, exchange files and store of an earlier one are removed
first. Exit status is 0 iff every process that was
not deliberately killed exited 0. Each process's output goes to
``<fleet-dir>/logs/proc<i>.log`` and the tails are printed at the end.

Fault drill: ``--kill-proc I --kill-after-mb M`` SIGKILLs process I once its
lease reports mega-batch >= M (the FleetController renews the lease's
``megabatch`` each boundary). Survivors must notice the missed heartbeat
deadline, evict process I's replicas and finish.

Example (2 processes x 2 replicas each, global R = 4, on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.multihost_launch \\
      --procs 2 --devices-per-proc 2 -- \\
      --workload xml --device cpu --replicas 4 --megabatches 5
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _read_megabatch(leases_dir: str, pid: int) -> int:
    path = os.path.join(leases_dir, f"proc-{pid}.json")
    try:
        with open(path) as f:
            payload = json.load(f)
        return int(payload.get("megabatch") or 0)
    except (OSError, ValueError):
        return -1


def _tail(path: str, lines: int = 15) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return "<no log>"


def _train_device(train_args: list) -> str:
    """The ``--device`` among the train arguments (the launcher's default,
    ``cuda``, when absent)."""
    for i, a in enumerate(train_args):
        if a == "--device" and i + 1 < len(train_args):
            return train_args[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def _visible_cards() -> list[str]:
    """The ids of the cards this process sees (``CUDA_VISIBLE_DEVICES``'s
    entries, else one per card `nvidia-smi -L` lists)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return [v for v in visible.split(",") if v.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [str(i) for i, line in enumerate(out.splitlines()) if line.startswith("GPU ")]


def device_plan(n_procs: int, per_proc: int, device: str) -> list[dict]:
    """Each process's environment additions: its local devices and, when
    it gets cards of its own, ``CUDA_VISIBLE_DEVICES`` (module doc)."""
    if device.startswith("cpu"):
        return [{"REPRO_MH_LOCAL_DEVICES": ",".join(["cpu"] * per_proc)}] * n_procs
    cards = _visible_cards()
    if len(cards) >= n_procs:
        m = max(1, min(per_proc, len(cards) // n_procs))
        local = ",".join(f"cuda:{i % m}" for i in range(per_proc))
        return [{"CUDA_VISIBLE_DEVICES": ",".join(cards[p * m:(p + 1) * m]),
                 "REPRO_MH_LOCAL_DEVICES": local} for p in range(n_procs)]
    return [{"REPRO_MH_LOCAL_DEVICES": ",".join(["cuda:0"] * per_proc)}] * n_procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--procs", type=int, default=2,
                    help="number of trainer processes to spawn")
    ap.add_argument("--devices-per-proc", type=int, default=2,
                    help="local devices (replica shards) per process")
    ap.add_argument("--spanning", default="auto", choices=["auto", "host", "device"],
                    help="host span (file exchange + leases), device span"
                         " (torch.distributed) or auto (device on cards, host on"
                         " the CPU)")
    ap.add_argument("--fleet-dir", default="",
                    help="shared rendezvous/exchange dir (default: a fresh temporary"
                         " dir, left on disk for post-mortem)")
    ap.add_argument("--kill-proc", type=int, default=-1,
                    help="SIGKILL this process id mid-run (heartbeat drill)")
    ap.add_argument("--kill-after-mb", type=int, default=2,
                    help="kill once the target's lease reports >= this many"
                         " completed mega-batches")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="overall wall-clock budget (seconds)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="arguments after '--' go to repro_torch.launch.train")
    args = ap.parse_args(argv)

    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if args.procs < 1:
        ap.error("--procs must be >= 1")
    if args.devices_per_proc < 1:
        ap.error("--devices-per-proc must be >= 1")
    if args.kill_proc >= args.procs:
        ap.error("--kill-proc out of range")

    fleet_dir = args.fleet_dir or tempfile.mkdtemp(prefix="repro-torch-fleet-")
    logs_dir = os.path.join(fleet_dir, "logs")
    leases_dir = os.path.join(fleet_dir, "leases")
    # a fleet dir holds one run: a reused one's leases, tombstones, exchange
    # files and process-group store would mislead the new fleet
    for name in ("leases", "condemned", "xchg", "store"):
        path = os.path.join(fleet_dir, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    os.makedirs(logs_dir, exist_ok=True)

    base_env = dict(os.environ)
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, base_env.get("PYTHONPATH")) if p)
    base_env["REPRO_MH_NUM_PROCESSES"] = str(args.procs)
    base_env["REPRO_MH_FLEET_DIR"] = fleet_dir
    base_env["REPRO_MH_SPANNING"] = args.spanning
    plan = device_plan(args.procs, args.devices_per_proc, _train_device(train_args))

    procs: list[subprocess.Popen] = []
    logs: list[str] = []
    for pid in range(args.procs):
        env = dict(base_env, **plan[pid])
        env["REPRO_MH_PROCESS_ID"] = str(pid)
        log_path = os.path.join(logs_dir, f"proc{pid}.log")
        logs.append(log_path)
        with open(log_path, "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "repro_torch.launch.train"]
                + [a.replace("{pid}", str(pid)) for a in train_args],
                env=env, stdout=log_f, stderr=subprocess.STDOUT,
            ))
    print(f"[multihost-launch] {args.procs} processes, fleet_dir={fleet_dir}, devices "
          + "; ".join(f"p{p}: {plan[p]}" for p in range(args.procs)), flush=True)

    deadline = time.monotonic() + args.timeout
    killed = timed_out = False
    try:
        while True:
            alive = [p for p in procs if p.poll() is None]
            if not alive:
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            if (args.kill_proc >= 0 and not killed
                    and procs[args.kill_proc].poll() is None
                    and _read_megabatch(leases_dir, args.kill_proc) >= args.kill_after_mb):
                print(f"[multihost-launch] SIGKILL proc {args.kill_proc} "
                      f"(lease mb >= {args.kill_after_mb})", flush=True)
                procs[args.kill_proc].send_signal(signal.SIGKILL)
                killed = True
            time.sleep(0.1)
    finally:
        # every process this spawner started ends with it
        for p in procs:
            if p.poll() is None:
                p.kill()

    failed = False
    for pid, p in enumerate(procs):
        rc = p.wait()
        deliberate = killed and pid == args.kill_proc
        status = "killed (expected)" if deliberate else f"rc={rc}"
        print(f"[multihost-launch] proc {pid}: {status}", flush=True)
        if not deliberate and rc != 0:
            failed = True
    if timed_out:
        print(f"[multihost-launch] TIMEOUT after {args.timeout}s", flush=True)
        failed = True
    if args.kill_proc >= 0 and not killed:
        print("[multihost-launch] kill never triggered (target exited or lease stalled"
              " before --kill-after-mb)", flush=True)
        failed = True
    for pid, path in enumerate(logs):
        print(f"--- proc {pid} tail ({path}) ---\n{_tail(path)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
