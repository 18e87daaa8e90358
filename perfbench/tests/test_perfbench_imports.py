"""No module the benchmark runs has the top-level name of JAX or of the
JAX package (``repro``, compared whole: ``repro_torch`` is the port), and
the reference imports nothing of the program."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

RUN = """
import sys, time, json
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from perfbench import harness
for traffic in ("adaptive-1gpu", "adaptive-4gpu"):
    cell = tiny_cell(traffic)
    harness.execute(cell, 7, 0.3, True, (torch.device("cpu"),) * cell["chips"],
                    time.perf_counter())
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import sys, json
sys.path[:0] = [{root!r}]
import perfbench.control, perfbench.inputs
from perfbench.reference import check, host, mlp
from perfbench.traffic import xml_synth
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(ROOT / "src"), root=str(ROOT),
                                           tests=str(ROOT / "perfbench/tests"))],
        capture_output=True, text=True, timeout=600, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    modules = _modules(RUN)
    assert "repro_torch" in modules
    assert [m for m in modules if m.split(".")[0] in FORBIDDEN] == []


def test_the_reference_imports_nothing_of_the_program():
    modules = _modules(REFERENCE)
    assert [m for m in modules if m.split(".")[0] in FORBIDDEN + ("repro_torch",)] == []
