"""The port stands alone: importing every module of ``repro_torch`` (the
checkpoint store, the fleet controller, the overlap pipeline's staging
modules, the measured speed model, libSVM I/O and the sharded placement's
mesh rules and executor and the multi-process modules among them) loads
neither JAX nor any module of
the reference package, builds no kernel, and the trainer refuses to fall
back to the CPU when no card is present, under either placement."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
from repro_torch.kernels import _build
print(len(names))
print(",".join(bad))
print(",".join(names))
print(int(_build.loaded()))
"""

# the elastic-membership modules, each imported by the walk above
ELASTIC_MODULES = ("repro_torch.checkpoint.store", "repro_torch.core.fleet",
                   "repro_torch.core.trainer", "repro_torch.launch.train")
# the overlap pipeline's staging modules, likewise
OVERLAP_MODULES = ("repro_torch.data.batcher", "repro_torch.data.providers",
                   "repro_torch.data.tokens")
# the measured speed model, libSVM I/O, the schedules, the SGD options and
# the ten config aliases, likewise
HOST_MODULES = ("repro_torch.core.heterogeneity", "repro_torch.data.libsvm",
                "repro_torch.optim.schedules", "repro_torch.optim.sgd",
                "repro_torch.configs.llama3_2_1b", "repro_torch.configs.seamless_m4t_large_v2")
# the sharded placement's modules, likewise
SHARDED_MODULES = ("repro_torch.sharding.rules", "repro_torch.sharding.executor",
                   "repro_torch.launch.mesh", "repro_torch.utils.tree",
                   "repro_torch.core.algorithms.base")
# multi-process training: the bootstrap and exchange, and the spawner
MULTIHOST_MODULES = ("repro_torch.launch.multihost", "repro_torch.launch.multihost_launch")


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.splitlines()
    n_modules, bad, names, n_loaded = int(out[0]), out[1], out[2].split(","), int(out[3])
    assert n_modules >= 25, n_modules   # the walk really saw the package
    for module in (ELASTIC_MODULES + OVERLAP_MODULES + HOST_MODULES + SHARDED_MODULES
                   + MULTIHOST_MODULES):
        assert module in names, module
    assert bad == "", f"the port imported {bad}"
    assert n_loaded == 0                # nothing was built or loaded


def test_trainer_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.models.xml_mlp import XMLMLPConfig, make_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_model(XMLMLPConfig(n_features=16, n_classes=4, hidden=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(model, provider=None, cfg=ElasticConfig())


def test_serve_launcher_without_device_needs_cuda(monkeypatch):
    """The serving launcher's default device is the card: without one it
    raises instead of running on the CPU."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--gen", "1", "--context", "2"])


@pytest.mark.parametrize("module",
                         ELASTIC_MODULES + OVERLAP_MODULES + HOST_MODULES + SHARDED_MODULES
                         + MULTIHOST_MODULES)
def test_elastic_module_alone_loads_no_jax_and_no_reference(module):
    """Each elastic-membership, staging, host, sharded-placement and
    multi-process module imported on its own, in a fresh interpreter: nothing of JAX or of the
    reference comes in with it."""
    probe = (f"import sys, {module}\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
             " or m.startswith(('jax.', 'jaxlib', 'repro.')))))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "", f"{module} imported {out}"


def test_launcher_without_device_needs_cuda_with_elastic_flags(monkeypatch, tmp_path):
    """The elastic flags change nothing of the device rule: the card, or
    an error."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--workload", "xml", "--samples", "64", "--features", "256", "--avg-nnz", "16",
                    "--classes", "8", "--megabatches", "1", "--elastic-schedule", "0:2,1:3",
                    "--faults", "0:join", "--checkpoint-dir", str(tmp_path)])


@pytest.mark.parametrize("speed", ["simulated", "measured"])
def test_train_launcher_speed_flag_without_device_needs_cuda(monkeypatch, speed):
    """Either speed model runs on the card or raises: the measured loop
    adds a clock, not a CPU path."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--workload", "xml", "--samples", "64", "--features", "256", "--avg-nnz", "16",
                    "--classes", "8", "--megabatches", "1", "--speed", speed])


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_train_launcher_overlap_flag_without_device_needs_cuda(monkeypatch, overlap):
    """Either setting of ``--overlap`` runs on the card or raises: the
    pipeline's staging slots change nothing of the device rule."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--workload", "xml", "--samples", "64", "--features", "256", "--avg-nnz", "16",
                    "--classes", "8", "--megabatches", "1", "--overlap", overlap])


def test_lm_train_launcher_without_device_needs_cuda(monkeypatch):
    """The training launcher's LM workload (its default) runs on the card
    unless asked for the CPU: without one it raises."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "tinyllama-1.1b", "--reduced", "--megabatches", "1"])


@pytest.mark.parametrize("schedule", [[], ["--elastic-schedule", "0:2,1:4"]])
def test_train_launcher_sharded_placement_without_device_needs_cuda(monkeypatch, schedule):
    """``--placement sharded`` spans the visible cards, or raises: the
    replica mesh never falls back to the CPU unless ``--device cpu``."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--workload", "xml", "--samples", "64", "--features", "256", "--avg-nnz", "16",
                    "--classes", "8", "--megabatches", "1", "--placement", "sharded"] + schedule)


def test_sharded_trainer_without_mesh_needs_cuda(monkeypatch):
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.models.xml_mlp import XMLMLPConfig, make_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_model(XMLMLPConfig(n_features=16, n_classes=4, hidden=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(model, provider=None, cfg=ElasticConfig(placement="sharded"))
