"""Whole runs of the harness on the CPU at small widths (the look for a
card skipped): the result line's shape, and ``correct`` coming out false
when the timed path is broken underneath."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, tiny_cell

from perfbench import harness

ONE, FOUR = "adaptive-1gpu", "adaptive-4gpu"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, traced=False, seconds=1.0, fault=None):
    cell = tiny_cell(name)
    devices = (torch.device("cpu"),) * cell["chips"]
    return harness.execute(cell, 2**31 + 3, seconds, traced, devices, time.perf_counter(),
                           fault=fault)


@pytest.mark.parametrize("name", [ONE, FOUR])
def test_result_line(name):
    r = run(name)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"train_samples_per_s", "megabatch_p90_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert r["device"]["count"] == (4 if name == FOUR else 1)
    assert r["checks"]["decisions"] == {"value": 0.0, "limit": 0.0}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    json.dumps(r)


def test_traced_result_line():
    r = run(ONE, traced=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert r["correct"] is True
    # the CPU has no kernels: only the host's per-layer metrics read anything
    assert set(r["metrics"]) == {"host_stage_ms", "merge_ms"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    assert {n for n, _ in r["breakdown"]["idle_gaps"]} <= {"stage", "dispatch", "collect",
                                                            "merge", "eval", "host"}


def _unchanged(monkeypatch):
    monkeypatch.setattr("repro_torch.core.trainer.sgd_update",
                        lambda params, grads, lr, cfg, momentum_state=None, update_mask=None:
                        (params, momentum_state))


def _half_batch(trainer):
    base = trainer.model.sparse_grad_fn

    def grads(params, batch):
        keep = torch.arange(batch["sample_mask"].shape[-1]) % 2 == 0
        return base(params, dict(batch, sample_mask=batch["sample_mask"] & keep))

    trainer.model = dataclasses.replace(trainer.model, sparse_grad_fn=grads)


def _no_exchange(monkeypatch):
    from repro_torch.core import adaptive_sgd

    merge = adaptive_sgd.normalized_merge
    monkeypatch.setattr(adaptive_sgd, "normalized_merge",
                        lambda replicas, alphas, g, gp, gamma, axis=None:
                        merge(replicas, alphas, g, gp, gamma))


def _loss_altered(trainer):
    finish = trainer._finish_metrics

    def altered(stats):
        loss, acc = finish(stats)
        return loss * (1 + 1e-4), acc

    trainer._finish_metrics = altered


@pytest.mark.parametrize("name,fault", [
    (ONE, "unchanged"), (ONE, "half_batch"), (ONE, "loss_altered"),
    (FOUR, "unchanged"), (FOUR, "half_batch"), (FOUR, "no_exchange"),
])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    hook = None
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "no_exchange":
        _no_exchange(monkeypatch)
    else:
        hook = {"half_batch": _half_batch, "loss_altered": _loss_altered}[fault]
    r = run(name, seconds=0.3, fault=hook)
    assert r["correct"] is False, r["checks"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "xml-amazon-670k.adaptive-1gpu",
         "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_it_exits_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(ROOT, env)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_with_only_the_benchmark_files_it_exits_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
