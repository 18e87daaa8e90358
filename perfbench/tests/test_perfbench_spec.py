"""BENCHMARK.json and the files it names: everything loads by name, keeps
to the benchmark's contract, and a new cell, configuration or metric is
found from new files and entries alone."""
import hashlib
import json
import re
import shutil

import pytest
from conftest import ROOT

from perfbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_configuration_traffic_and_limits(cell):
    c = spec.cell(cell)
    config = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert c["config_data"]["name"] == config["name"]
    assert set(config["reduced"]) <= set(c["config_data"])
    assert c["traffic_data"]["replicas"] % c["chips"] == 0
    assert c["limits"]["decisions"] == 0
    reported = {m["name"] for m in spec.metrics(cell, False) + spec.metrics(cell, True)}
    assert "setup_s" in reported and len(spec.metrics(cell, False)) >= 2
    assert spec.metrics(cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]} \
            if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m and "\n" not in m["layer"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    """A later change adds a traffic mix, a cell's limits and a per-layer
    metric as new files and new BENCHMARK.json entries: the harness finds
    them, and no file it already had changes."""
    for sub in ("configs", "traffic", "limits", "metrics", "families"):
        shutil.copytree(ROOT / "perfbench" / sub, tmp_path / "perfbench" / sub)
    before = _digest(tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    cell = "xml-amazon-670k.homogeneous-1gpu"
    traffic = dict(json.loads((ROOT / "perfbench/traffic/adaptive-1gpu.json").read_text()),
                   max_gap=0.0)
    (tmp_path / "perfbench/traffic/homogeneous-1gpu.json").write_text(json.dumps(traffic))
    (tmp_path / f"perfbench/limits/{cell}.json").write_text(json.dumps({"decisions": 0}))
    (tmp_path / "perfbench/metrics/megabatches_per_s.py").write_text(
        "def read(run):\n    return len(run.completions) / run.window_s\n")
    bench["workloads"].append({"name": cell, "config": "xml-amazon-670k",
                               "traffic": "homogeneous-1gpu", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "megabatches_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "train_samples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell(cell, tmp_path)
    assert c["traffic_data"]["max_gap"] == 0.0 and c["config_data"]["n_classes"] == 670091
    assert "megabatches_per_s" in [m["name"] for m in spec.metrics(cell, True, tmp_path)]
    assert [m["name"] for m in spec.metrics(cell, False, tmp_path)] \
        == [m["name"] for m in BENCH["end_to_end"]]

    class Run:
        completions, window_s = [0.5, 1.0], 1.0

    assert spec.reader("megabatches_per_s", tmp_path)(Run()) == 2.0
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="xml-amazon-670k.adaptive-1gpu"):
        spec.cell("no-such-cell")
