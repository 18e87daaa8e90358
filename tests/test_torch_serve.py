"""The port's serving entry points against the reference's, at reduced
size from the same weights: greedy generation must produce the very same
tokens, and the prefill step the same logits (rtol/atol 1e-4, f32
reassociation, as in tests/test_torch_lm_model.py)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import model as JMDL
from repro_torch.configs import archs as torch_archs
from repro_torch.launch import serve, steps
from repro_torch.models import model as MDL

# the decoder-only families and the encoder-decoder and vision-frontend ones
ARCHS = ["llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
         "seamless-m4t-large-v2", "internvl2-2b"]


def _setup(arch, **flags):
    jcfg = dataclasses.replace(jax_archs.ARCHS[arch].reduced(), remat=False, **flags)
    tcfg = dataclasses.replace(torch_archs.ARCHS[arch].reduced(), **flags)
    jparams = JMDL.init(jcfg, jax.random.PRNGKey(1))
    tparams = MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch, window):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, size=(2, 8))
    want, _ = jax_serve.greedy_generate(jcfg, jparams, jnp.asarray(prompts, jnp.int32), 8,
                                        window=window)
    got, steps_per_s = serve.greedy_generate(tcfg, tparams, torch.from_numpy(prompts), 8,
                                             window=window)
    assert got.shape == (2, 8) and steps_per_s > 0
    assert got.tolist() == np.asarray(want).tolist()


def test_prefill_step_matches_reference():
    flags = dict(use_flash_kernel=True, use_ssd_kernel=True, use_gmm_kernel=True)
    jcfg, tcfg, jparams, tparams = _setup("jamba-1.5-large-398b", **flags)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, 64))
    want = jax_steps.make_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = steps.make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch):
    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--context", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert bool(((toks >= 0) & (toks < torch_archs.ARCHS[arch].reduced().vocab_size)).all())
