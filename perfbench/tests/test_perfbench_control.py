"""The control and the faults of ``perfbench/control.py`` on a card: at
small widths the program reads within the cell's limits, and the
reference with half of each batch left out, or (on four cards) without the
exchange, reads outside one of them; at each cell's own widths the
reference in TF32 in the program's place comes out not correct by the
cell's limits. At full width the same script gives the readings PERF.md
sets the limits from."""
import json

import pytest
import torch
from conftest import ROOT, tiny_cell

from perfbench import control, spec
from perfbench.reference import check

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _devices(chips):
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    return tuple(torch.device("cuda", i) for i in range(chips))


@pytest.mark.card
@pytest.mark.parametrize("traffic", ["adaptive-1gpu", "adaptive-4gpu"])
def test_control_and_faults_fail_a_limit(card, traffic):
    cell = tiny_cell(traffic)
    devices = _devices(cell["chips"])
    r = control.readings(cell, 2**31 + 17, devices, program=True)
    assert check.judge(r["program"], cell["limits"])[0], r["program"]
    for source in ("half_batch", "no_exchange") if cell["chips"] > 1 else ("half_batch",):
        assert not check.judge(r[source], cell["limits"])[0], (source, r[source])
    assert r["control"]["update1_units"] > 3 * r["program"]["update1_units"], r


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    cell = spec.cell(name)
    r = control.readings(cell, 2**31 + 29, _devices(cell["chips"]), program=False)
    assert not check.judge(r["control"], cell["limits"])[0], r["control"]
    assert not check.judge(r["half_batch"], cell["limits"])[0], r["half_batch"]
