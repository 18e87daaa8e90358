"""A cell's model family is found by the name its configuration gives
(``perfbench/families/<family>.py``): a second family added as new files
runs end to end through the harness and ``control.py``, a wrong name or an
incomplete family fails with the name at fault, and the generic files
import no family and read no key of the XML MLP's configuration."""
import ast
import hashlib
import json
import shutil
import time

import pytest
import torch
from conftest import ROOT, TINY

from perfbench import control, harness, spec
from perfbench.reference import check

GENERIC = ("harness.py", "spec.py", "run.py", "control.py", "trace.py", "reference/check.py")
FORBIDDEN_IMPORTS = ("perfbench.families", "perfbench.reference.mlp",
                     "perfbench.traffic.xml_synth", "perfbench.inputs",
                     "repro_torch.models.xml_mlp")
MLP_KEYS = ("n_features", "n_classes", "hidden")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return _digest(tmp_path / "perfbench")


@pytest.mark.parametrize("traffic", ["adaptive-1gpu", "adaptive-4gpu"])
def test_a_second_family_added_as_files_runs_end_to_end(tmp_path, traffic):
    """The XML module under another name, a configuration naming it, a
    traffic mix, a cell's limits and ``BENCHMARK.json`` entries, all new
    files and entries: the harness and ``control.py`` run the cell through
    the new module, and no file of ``perfbench/`` that was there changes."""
    before = _copy(tmp_path)
    base = tmp_path / "perfbench"
    (base / "families/xml_mlp_copy.py").write_text((base / "families/xml_mlp.py").read_text())
    (base / "configs/tiny-copy.json").write_text(
        json.dumps(dict(TINY, name="tiny-copy", family="xml_mlp_copy")))
    mix = dict(json.loads((base / f"traffic/{traffic}.json").read_text()), b_max=32,
               mega_batch=10)
    (base / f"traffic/tiny-{traffic}.json").write_text(json.dumps(mix))
    name = f"tiny-copy.{traffic}"
    (base / f"limits/{name}.json").write_text(
        (base / f"limits/xml-amazon-670k.{traffic}.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-copy", "source": "test",
                             "file": "perfbench/configs/tiny-copy.json", "reduced": [],
                             "why": "test"})
    chips = mix["replicas"] if mix["placement"] == "sharded" else 1
    bench["workloads"].append({"name": name, "config": "tiny-copy",
                               "traffic": f"tiny-{traffic}", "chips": chips, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(name, tmp_path)
    assert cell["family"].__file__ == str(base / "families/xml_mlp_copy.py")
    devices = (torch.device("cpu"),) * chips
    r = harness.execute(cell, 2**31 + 41, 0.3, False, devices, time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["decisions"] == {"value": 0.0, "limit": 0.0}

    got = control.readings(cell, 2**31 + 43, devices, program=True)
    faults = [f for f, shards in cell["family"].FAULTS.items() if chips >= shards]
    assert set(got) == {"program", "control", *faults}
    assert faults == (["half_batch", "no_exchange"] if chips > 1 else ["half_batch"])
    assert check.judge(got["program"], cell["limits"])[0], got["program"]
    for fault in faults:
        assert not check.judge(got[fault], cell["limits"])[0], (fault, got[fault])
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_family_names_the_known_ones():
    with pytest.raises(KeyError, match="no model family 'no_such_family'.*known: .*xml_mlp"):
        spec.family("no_such_family")


@pytest.mark.parametrize("missing", spec.CONTRACT)
def test_a_family_lacking_a_contract_name_fails_with_that_name(tmp_path, missing):
    folder = tmp_path / "perfbench/families"
    folder.mkdir(parents=True)
    (folder / "partial.py").write_text(
        (ROOT / "perfbench/families/xml_mlp.py").read_text() + f"\ndel {missing}\n")
    with pytest.raises(AttributeError, match=f"model family 'partial' lacks {missing}$"):
        spec.family("partial", tmp_path)


def _imports(path):
    """The modules ``path`` imports, by statement or by a constant given to
    ``importlib.import_module``, and the string constants its code holds."""
    tree = ast.parse(path.read_text())
    package = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    found, strings = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            parent = parts[:len(parts) - node.level + 1] if node.level else []
            module = ".".join(parent + ([node.module] if node.module else []))
            found += [module] + [f"{module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            found += [a.value for a in node.args if isinstance(a, ast.Constant)]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
    return found, strings


def _violations(path):
    found, strings = _imports(path)
    bad = [m for m in found
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN_IMPORTS)]
    return bad + [s for s in strings if s in MLP_KEYS]


@pytest.mark.parametrize("name", GENERIC)
def test_the_generic_files_import_no_family_and_read_no_key_of_the_mlp(name):
    assert _violations(ROOT / "perfbench" / name) == []


def test_the_guard_sees_a_family():
    """The scan finds what the XML family imports and reads."""
    bad = _violations(ROOT / "perfbench/families/xml_mlp.py")
    assert {"perfbench.inputs", "perfbench.reference.mlp", "perfbench.traffic.xml_synth",
            "repro_torch.models.xml_mlp.XMLMLPConfig", "n_features", "hidden"} <= set(bad)
    found, _ = _imports(ROOT / "perfbench/reference/mlp.py")
    assert "perfbench.reference.check.Trajectory" in found
