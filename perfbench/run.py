"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. Prints each compared number beside its limit as
the last lines of standard error, and the result as one JSON object on the
last line of standard output. The run's libraries compute on one thread
each. Exits 2, with no result, where the cell's cards are missing; 3 where
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one compute thread a library: the host's Python paces this cell, and
    # intra-op pools that spin on the host's shared cores spread its runs
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every build and kernel cache at a fixed path inside the checkout
    # (the port's kernels build into build/repro_torch, kernels/_build.py)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness, spec

    cell = spec.cell(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    devices = tuple(torch.device("cuda", i) for i in range(cell["chips"]))
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
