"""Finds everything by the names in ``BENCHMARK.json``: a cell's entry, its
configuration (``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<traffic>.json``), its correctness limits
(``perfbench/limits/<cell>.json``), the readers of the metrics it
reports (``perfbench/metrics/<metric>.py``), and the model family its
configuration names under ``"family"`` (``perfbench/families/<family>.py``,
which gives the names of :data:`CONTRACT`). A later cell, configuration,
metric or model family is a new file and a new entry; no code changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# what a model family gives the harness and ``control.py``
CONTRACT = ("pools", "weights", "build", "fetched_samples", "model_flops", "launches",
            "update_units", "reference", "replay", "FAULTS")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's ``workloads`` entry, with its configuration, traffic and
    limits loaded under ``config_data``, ``traffic_data`` and ``limits``,
    and its configuration's model family under ``family``."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "perfbench"
    config = _json(root / configs[entry["config"]]["file"])
    return dict(
        entry,
        config_data=config,
        traffic_data=_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(base / "limits" / f"{name}.json"),
        family=family(config["family"], root),
    )


def metrics(name: str, trace: bool, root: Path = ROOT) -> list:
    """The metric entries the cell reports: its end-to-end metrics without
    tracing, its per-layer metrics with; an entry with ``workloads`` only
    in those cells."""
    bench = benchmark(root)
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def _load(path: Path, prefix: str, name: str):
    module_spec = importlib.util.spec_from_file_location(prefix + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
    return _load(root / "perfbench" / "metrics" / f"{metric}.py", "perfbench_metric_",
                 metric).read


def family(name: str, root: Path = ROOT):
    """The module ``perfbench/families/<name>.py``, checked to give every
    name of :data:`CONTRACT`."""
    folder = root / "perfbench" / "families"
    path = folder / f"{name}.py"
    if not path.is_file():
        known = ", ".join(sorted(p.stem for p in folder.glob("*.py")))
        raise KeyError(f"no model family {name!r} in perfbench/families; known: {known}")
    module = _load(path, "perfbench_family_", name)
    missing = [n for n in CONTRACT if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"model family {name!r} lacks {', '.join(missing)}")
    return module
