"""The readings the correctness limits are set from, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--program]

For each seed it prints one JSON line of compared numbers (``check``'s
``loss``, ``update1``, ``change``):

* ``control``: the reference computed with TF32 on (the nearest precision
  below the configuration's f32), put in the program's place, against the
  f32 reference;
* each planted fault of the cell's model family (its ``FAULTS``, each run
  where the cell has the shards it needs), against the reference; the
  XML MLP's are ``half_batch``, every other sample of each batch left
  out, and ``no_exchange`` (a cell whose replicas are split over cards),
  the merge summing only the first card's replicas;
* with ``--program``: the program itself, as a run of the cell judges it,
  with a window of one mega-batch (the lower readings).

A state left unchanged reads 1 on ``update1`` and ``change`` by their
definition and needs no run. The last line holds each number's largest
reading over the seeds, by source. Each line also gives, under ``correct``,
what ``check.judge`` makes of each source against the cell's limits: the
program has to come out true, the control and every fault false. Runs on
the cell's cards, as the benchmark does; ``tests/test_perfbench_control.py``
runs it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: dict, seed: int, devices: tuple, program: bool) -> dict:
    """{source: {number: reading}} for one seed."""
    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.reference import check

    config, traffic, family = cell["config_data"], cell["traffic_data"], cell["family"]
    out = {}
    if program:
        result = harness.execute(cell, seed, 0.0, False, devices, time.perf_counter())
        out["program"] = {k: c["value"] for k, c in result["checks"].items()}
    pool, _ = family.pools(config, seed, devices[0])
    n_shards = len(devices) if traffic["placement"] == "sharded" else 1
    R = traffic["replicas"]
    # a measured model discards its first window, and the pipeline plans one
    # window stale: the first mega-batches' plans read no window
    windows = [("shards", np.ones(n_shards), np.zeros(R), np.zeros(R), 0)] * harness.FOLLOWED

    def follow(tf32=False, fault=None):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        w0 = family.weights(config, seed, devices[0])
        return family.reference(w0, pool, traffic, seed, harness.FOLLOWED, readings=windows,
                                n_shards=n_shards, fault=fault)

    ref = follow(bool(config["allow_tf32"]))
    out["control"] = check.readings(follow(tf32=True), ref)
    for fault, shards in family.FAULTS.items():
        if n_shards >= shards:
            out[fault] = check.readings(follow(fault=fault), ref)
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import spec
    from perfbench.reference import check

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    devices = tuple(torch.device("cuda", i) for i in range(cell["chips"]))
    worst: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, devices, args.program)
        judged = {source: check.judge(numbers, cell["limits"])[0]
                  for source, numbers in r.items()}
        print(json.dumps({"seed": seed, **r, "correct": judged}), flush=True)
        for source, numbers in r.items():
            for k, v in numbers.items():
                worst.setdefault(source, {})[k] = max(worst.get(source, {}).get(k, 0.0), v)
    print(json.dumps({"largest": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
