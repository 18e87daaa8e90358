"""The Moonlight-16B-A3B family (``families/moonlight.py``) at small
widths on the CPU: its weights are the program's tree, a run of its cell
through the harness is correct, ``control.py`` judges the program true and
every fault false, its control computes below bf16, and its reference
imports nothing of the program."""
import copy
import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

from perfbench import control, harness, spec
from perfbench.reference import check

NAME = "moonlight-16b-a3b.adaptive-4k-1gpu"
# the configuration at the port's smoke widths (``MLAMoEConfig.reduced``):
# 16 routed experts of which 4 held, from the fifth
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=24,
             intermediate_size=96, vocab_size=256, router_experts=16, n_routed_experts=4,
             first_expert=4, num_experts_per_tok=4, num_hidden_layers=3)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(dtype: str = "float32") -> dict:
    cell = spec.cell(NAME)
    cell["config_data"] = dict(copy.deepcopy(cell["config_data"]), **SMALL, dtype=dtype)
    cell["traffic_data"] = dict(cell["traffic_data"], seq_len=32, mega_batch=6)
    return cell


def test_the_weights_are_the_programs_tree():
    """Keys, shapes and dtypes of the benchmark's draw equal the program's
    init of the same configuration; at the cell's widths, 769 M parameters
    a replica."""
    from repro_torch.models import model as MDL
    from repro_torch.utils import tree as tu

    fam = spec.family("moonlight")
    config = small_cell()["config_data"]
    want = {k: (tuple(v.shape), v.dtype) for k, v in tu.flatten(
        MDL.init(fam.model_config(config), torch.Generator().manual_seed(0))).items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in fam.weights(config, 3, "cpu").items()}
    assert got == want
    n = sum(torch.Size(shape).numel() for shape, _, _ in
            fam.shapes(spec.cell(NAME)["config_data"]).values())
    assert 768e6 < n < 770e6, n


def test_the_cell_is_correct_through_the_harness():
    cell = small_cell()
    r = harness.execute(cell, 2**31 + 5, 0.2, True, (torch.device("cpu"),), time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["decisions"]["value"] == 0.0
    assert r["attempted"] > harness.FOLLOWED


def test_control_judges_the_program_true_and_every_fault_false():
    """In f32 (no precision below to compare with on the CPU), the program
    within the cell's limits and each planted fault outside them."""
    cell = small_cell()
    got = control.readings(cell, 2**31 + 7, (torch.device("cpu"),), program=True)
    assert set(got) == {"program", "control", *cell["family"].FAULTS}
    assert check.judge(got["program"], cell["limits"])[0], got["program"]
    for fault in cell["family"].FAULTS:
        assert not check.judge(got[fault], cell["limits"])[0], (fault, got[fault])


def test_the_control_computes_below_bf16():
    """With the configuration in bf16, ``control.py``'s control is the
    reference with every product's inputs in float8: its loss lies several
    times farther from the f32 reference's than the bf16 program's."""
    cell = small_cell("bfloat16")
    got = control.readings(cell, 2**31 + 7, (torch.device("cpu"),), program=True)
    assert got["control"]["loss"] > 3 * got["program"]["loss"] > 0, got


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import perfbench.reference.moonlight, perfbench.traffic.lm_tokens\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=ROOT)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in ("repro_torch", "repro", "jax")]
