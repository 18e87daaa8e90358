"""The port's LM (serving side) against the reference at reduced size, from
the same weights (``params_from_jax``) and the same numpy tokens.

Every layer runs in f32 at these sizes, and the two frameworks sum in other
orders (and the flags route through the kernels' plain versions here and
Pallas in interpret mode there), so logits and cache leaves are held to
rtol/atol 1e-4: two orders of magnitude under the reference's own
kernel-vs-jnp integration tolerance of 2e-3, and far above f32 rounding.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import model as JMDL
from repro.models import moe as JMOE
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE

TOL = dict(rtol=1e-4, atol=1e-4)
# every decoder-only architecture of the registry
ARCHS = ["llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
         "tinyllama-1.1b", "stablelm-1.6b", "arctic-480b", "kimi-k2-1t-a32b"]
FLAGS = dict(use_flash_kernel=True, use_ssd_kernel=True, use_gmm_kernel=True)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch: str, kernels: bool):
    flags = FLAGS if kernels else {}
    jcfg = dataclasses.replace(jax_archs.ARCHS[arch].reduced(), remat=False, **flags)
    tcfg = dataclasses.replace(torch_archs.ARCHS[arch].reduced(), **flags)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """The reference's reduced-config weights, as numpy and as the port's."""
    jcfg, _ = _configs(arch, False)
    jparams = JMDL.init(jcfg, jax.random.PRNGKey(0))
    return jparams, MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_configs_equal_the_reference():
    """Every ARCHS entry and its reduced() equal the reference field for
    field; the input shapes too."""
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES

    assert list(torch_archs.ARCHS) == list(jax_archs.ARCHS)
    for name, cfg in torch_archs.ARCHS.items():
        ref = jax_archs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced()), name
    assert torch_archs.XML_WORKLOADS == jax_archs.XML_WORKLOADS
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


ALIASES = ("arctic_480b", "internvl2_2b", "jamba_1_5_large_398b", "kimi_k2_1t_a32b",
           "llama3_2_1b", "mamba2_780m", "moonshot_v1_16b_a3b", "seamless_m4t_large_v2",
           "stablelm_1_6b", "tinyllama_1_1b")


@pytest.mark.parametrize("alias", ALIASES)
def test_config_alias_equals_the_reference(alias):
    """``repro_torch.configs.<alias>.CONFIG`` is the reference module's
    ``CONFIG`` field for field, and the port's ``ARCHS`` entry itself."""
    port = importlib.import_module(f"repro_torch.configs.{alias}").CONFIG
    ref = importlib.import_module(f"repro.configs.{alias}").CONFIG
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port is torch_archs.ARCHS[ref.name]


@pytest.mark.parametrize("arch", list(torch_archs.ARCHS))
def test_init_tree_matches_the_reference(arch):
    """The port's random init has the reference's tree: same leaves, shapes
    and dtypes, for every architecture (reduced), the encoder, the cross
    blocks and the frontend projection among them."""
    jcfg, tcfg = _configs(arch, False)
    want = jax.eval_shape(lambda: JMDL.init(jcfg, jax.random.PRNGKey(0)))
    got = MDL.init(tcfg, torch.Generator().manual_seed(0))
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_mamba2_init_cache_matches_the_reference():
    from repro.models import mamba2 as JM
    from repro_torch.models import mamba2 as TM

    jparams, tparams = _weights("mamba2-780m")
    cfg = torch_archs.ARCHS["mamba2-780m"].reduced()
    kw = dict(head_dim=cfg.ssm_head_dim, state=cfg.ssm_state)
    want = JM.mamba2_init_cache(3, jax.tree_util.tree_map(lambda l: l[0], jparams["blocks"]["pos0"])
                                ["mixer"], dtype=jnp.float32, **kw)
    got = TM.mamba2_init_cache(3, MDL._group(tparams["blocks"]["pos0"], 0)["mixer"],
                               dtype=torch.float32, **kw)
    assert {k: (tuple(v.shape), not v.any()) for k, v in got.items()} == {
        k: (v.shape, not np.asarray(v).any()) for k, v in want.items()}


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel-flags"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, kernels):
    """Last-position logits of prefill, flags off (the model's own paths)
    and on (the kernels' plain versions here, Pallas interpret there)."""
    jcfg, tcfg = _configs(arch, kernels)
    jparams, tparams = _weights(arch)
    tokens = _tokens(tcfg, 2, 64)
    want = JMDL.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = MDL.prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (2, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_prefill_pads_to_the_ssd_chunk(arch):
    """40 tokens against a chunk of 64: the SSD input is padded to the chunk
    and the padding cut off again, on the kernel path as on the plain one."""
    jcfg, tcfg = _configs(arch, True)
    jparams, tparams = _weights(arch)
    tokens = _tokens(tcfg, 2, 40, seed=3)
    want = JMDL.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = MDL.prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """16 decode steps from an empty cache: the logits of every step and
    every cache leaf at the end."""
    jcfg, tcfg = _configs(arch, False)
    jparams, tparams = _weights(arch)
    tokens = _tokens(tcfg, 2, 16, seed=1)
    jcache = JMDL.init_cache(jcfg, 2, 16)
    tcache = MDL.init_cache(tcfg, 2, 16, device="cpu")
    jstep = jax.jit(lambda p, c, t: JMDL.decode_step(jcfg, p, c, t))
    for i in range(16):
        want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]))
        got, tcache = MDL.decode_step(tcfg, tparams, tcache, torch.from_numpy(tokens[:, i : i + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"step {i}")
    assert tcache["cur_len"] == int(jcache["cur_len"]) == 16
    jleaves = jax.tree_util.tree_flatten_with_path({k: v for k, v in jcache.items()
                                                   if k != "cur_len"})[0]
    tleaves = jax.tree_util.tree_flatten({k: v for k, v in tcache.items() if k != "cur_len"})[0]
    assert len(jleaves) == len(tleaves) > 0
    for (path, want), got in zip(jleaves, tleaves):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=str(path))


def test_sliding_window_decode_matches_reference():
    """A rolling-buffer cache of 8 over 12 steps (the slot wraps)."""
    jcfg, tcfg = _configs("llama3.2-1b", False)
    jparams, tparams = _weights("llama3.2-1b")
    tokens = _tokens(tcfg, 2, 12, seed=2)
    jcache, tcache = JMDL.init_cache(jcfg, 2, 12, 8), MDL.init_cache(tcfg, 2, 12, 8, "cpu")
    jstep = jax.jit(lambda p, c, t: JMDL.decode_step(jcfg, p, c, t, window=8))
    for i in range(12):
        want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]))
        got, tcache = MDL.decode_step(tcfg, tparams, tcache,
                                      torch.from_numpy(tokens[:, i : i + 1]), 8)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_layer_matches_reference(use_flash):
    """The layer with a key mask (which keeps even use_flash on the
    blockwise path, as the reference routes it) and shifted positions."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jp = JL.init_attention(jax.random.PRNGKey(2), 64, 4, 2, 16, jnp.float32)
    tp = MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    mask = rng.random((2, 32)) > 0.2
    pos = np.arange(5, 37)
    kw = dict(n_rep=2, rope_theta=10000.0, window=8, q_chunk=16, kv_chunk=16,
              use_flash=use_flash)
    want = JL.attention_layer(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                              kv_seq_mask=jnp.asarray(mask), **kw)
    got = TL.attention_layer(tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                             kv_seq_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# --------------------------------------------------------------------------
# MoE dispatch and combine
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_weights():
    jp = JMOE.init_moe(jax.random.PRNGKey(0), 64, 128, 4, jnp.float32)
    return jp, MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dispatch,force_groups,capacity_factor,combine_dtype", [
    ("global", 0, 1.25, "f32"),
    ("global", 0, 1.25, "bf16"),
    ("sharded", 0, 1.25, "f32"),    # one group on one card: the global path
    ("sharded", 2, 1.25, "bf16"),   # an explicit group dim of 2
    ("global", 0, 0.3, "f32"),      # forced overflow: capacity 5 for ~16 per expert
    ("sharded", 4, 0.3, "bf16"),
])
def test_moe_ffn_matches_reference(dispatch, force_groups, capacity_factor, combine_dtype):
    jp, tp = _moe_weights()
    x = np.random.default_rng(3).normal(size=(4, 8, 64)).astype(np.float32)
    kw = dict(top_k=2, dispatch=dispatch, force_groups=force_groups,
              capacity_factor=capacity_factor, combine_dtype=combine_dtype)
    want, want_aux = JMOE.moe_ffn(jp, jnp.asarray(x), **kw)
    got, got_aux = MOE.moe_ffn(tp, torch.from_numpy(x), **kw)
    # bf16 combine: each framework rounds the k partial sums to bf16
    tol = TOL if combine_dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    kernel, _ = MOE.moe_ffn(tp, torch.from_numpy(x), use_gmm_kernel=True, **kw)
    np.testing.assert_allclose(_np(kernel), _np(got), **TOL)


def test_moe_gather_dispatch_matches_reference():
    jp, tp = _moe_weights()
    x = np.random.default_rng(4).normal(size=(2, 1, 64)).astype(np.float32)
    want, _ = JMOE.moe_layer(jp, jnp.asarray(x), top_k=2, dispatch="gather")
    got, _ = MOE.moe_layer(tp, torch.from_numpy(x), top_k=2, dispatch="gather")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_overflow_clears_the_last_kept_slot_as_the_reference_does():
    """The reference's duplicate-slot scatter: expert 0 gets three of four
    assignments at capacity 2, so both overflow rows land on its slot 1
    with zeros and the last write wins. Rows 1..4 give [1, 0, 4, 0]."""
    ids = np.array([[0], [0], [0], [1]], np.int32)
    rows = np.arange(1, 5, dtype=np.float32)[:, None]
    buf, _ = MOE._dispatch_group(torch.from_numpy(rows), torch.from_numpy(ids).long(), 2, 2)
    assert buf.reshape(-1).tolist() == [1.0, 0.0, 4.0, 0.0]
    sort_idx, slots, keep = JMOE._dispatch_indices(jnp.asarray(ids.reshape(-1)), 2, 2)
    gathered = jnp.asarray(rows)[sort_idx // 1] * keep[:, None]
    ref = jnp.zeros((4, 1)).at[slots].set(gathered, mode="drop")
    assert np.asarray(ref).reshape(-1).tolist() == [1.0, 0.0, 4.0, 0.0]
