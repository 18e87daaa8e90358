"""The benchmark's own tests, run from the repository root:

    python -m pytest -q perfbench/tests

They run on the CPU at small widths. Tests that need a CUDA card carry the
``card`` marker and skip, with a reason, where there is none; on a
machine with cards, ``python3 -m pytest -q perfbench/tests -m card`` runs
them.
"""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

# a configuration at small widths, with Amazon-670K's data shapes scaled down
TINY = dict(
    name="tiny", family="xml_mlp", n_features=512, n_classes=128, hidden=32, dtype="float32",
    allow_tf32=False, peak_flops=67e12, train_samples=2048, test_samples=256,
    data=dict(nnz_median=16, nnz_sigma=0.5, nnz_clip=[4, 64], zipf=0.8, extra_labels=2),
)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_cell(traffic: str) -> dict:
    """Amazon-670K's cell under ``traffic`` (``perfbench/traffic/``), with
    its configuration swapped for :data:`TINY` and 32-slot batches, 10 a
    mega-batch; the chips its placement needs, the cell's limits as they
    stand in ``perfbench/limits/``, and its model family."""
    from perfbench import spec

    name = f"xml-amazon-670k.{traffic}"
    data = json.loads((ROOT / f"perfbench/traffic/{traffic}.json").read_text())
    return dict(name=name, config="xml-amazon-670k", traffic=traffic,
                chips=data["replicas"] if data["placement"] == "sharded" else 1,
                config_data=copy.deepcopy(TINY),
                traffic_data=dict(data, b_max=32, mega_batch=10),
                limits=json.loads((ROOT / f"perfbench/limits/{name}.json").read_text()),
                family=spec.family(TINY["family"]))
