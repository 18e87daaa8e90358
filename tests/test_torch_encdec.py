"""The encoder-decoder and vision-frontend families (seamless-m4t-large-v2,
internvl2-2b) of the port against the reference at reduced size, from the
same weights (``params_from_jax``) and the same numpy inputs: tokens, and
``frames`` / ``patch_embeds`` drawn with numpy (the reference draws its
own with ``jax.random``, which torch cannot reproduce).

Every layer runs in f32 at these sizes and the two frameworks sum in other
orders (the flags route the decoder's self-attention through the flash
kernel's plain version here and Pallas in interpret mode there), so logits,
losses, gradients and cache leaves are held to rtol/atol 1e-4, as in
``tests/test_torch_lm_model.py``.

Also ``launch/steps.py``'s prefill step and train round with frontend
inputs, and ``launch/specs.py``: every architecture's input specs under every
``INPUT_SHAPES`` entry against the reference's ``jax.eval_shape`` specs,
and the numpy-drawn parts of its batches bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.launch import specs as JSP
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import model as JMDL
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve
from repro_torch.launch import train as port_train
from repro_torch.launch import specs as SP
from repro_torch.launch import steps
from repro_torch.models import layers as TL
from repro_torch.models import model as MDL
from repro_torch.utils import tree as tu
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["seamless-m4t-large-v2", "internvl2-2b"]
FIELD = {"audio": "frames", "vision": "patch_embeds"}
B, S = 2, 24

pytestmark = pytest.mark.usefixtures("one_thread")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch: str, **kw):
    jcfg = dataclasses.replace(jax_archs.ARCHS[arch].reduced(), remat=False, **kw)
    tcfg = dataclasses.replace(torch_archs.ARCHS[arch].reduced(), **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """The reference's reduced-config weights, as its tree and the port's."""
    jcfg, _ = _configs(arch)
    jparams = jax.jit(lambda key: JMDL.init(jcfg, key))(jax.random.PRNGKey(0))
    return jparams, MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _batch(cfg, lead=(), seed=0) -> dict:
    """Tokens, targets, a sample mask with its second sample masked, and
    the frontend's embeddings, all numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=lead + (B, S + 1)).astype(np.int32)
    mask = np.ones(lead + (B,), bool)
    mask[..., 1] = False
    front = rng.normal(size=lead + (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:], "sample_mask": mask,
            FIELD[cfg.frontend]: front}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------
# layers: cross-attention, prefill and decode
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _attention_weights():
    jp = JL.init_attention(jax.random.PRNGKey(3), 64, 4, 2, 16, jnp.float32)
    return jp, MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("use_flash", [False, True])
def test_cross_attention_layer_matches_reference(use_flash):
    """The block over an encoder memory of another length: K/V from the raw
    memory, no RoPE, nothing causal (even where the caller asks for it),
    on either attention path."""
    jp, tp = _attention_weights()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    mem = rng.normal(size=(2, 20, 64)).astype(np.float32)
    jkv = (jnp.einsum("bsd,dhk->bshk", mem, jp["wk"]), jnp.einsum("bsd,dhk->bshk", mem, jp["wv"]))
    tkv = TL.memory_kv(tp, torch.from_numpy(mem))
    for j, t in zip(jkv, tkv):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    kw = dict(n_rep=2, rope_theta=10000.0, use_flash=use_flash, causal=True)
    want = jax.jit(lambda p, x, kv: JL.attention_layer(p, x, cross_kv=kv, **kw))(
        jp, jnp.asarray(x), jkv)
    got = TL.attention_layer(tp, torch.from_numpy(x), cross_kv=tkv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cross_decode_attention_matches_reference_and_writes_nothing():
    """``cross=True`` against a nonzero memory K/V: every entry valid
    whatever ``cur_len`` says, no RoPE, and the cache is left as it was."""
    jp, tp = _attention_weights()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    kw = dict(n_rep=2, rope_theta=10000.0, cross=True)
    for cur in (0, 3, 25):
        want, jk, jv = JL.decode_attention(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                           jnp.asarray(cur, jnp.int32), **kw)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        got, gk, gv = TL.decode_attention(tp, torch.from_numpy(x), tk, tv, cur, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"cur_len {cur}")
        assert np.array_equal(_np(gk), ck) and np.array_equal(_np(gv), cv)
        assert np.array_equal(_np(jk), ck) and np.array_equal(_np(jv), cv)


def test_encoder_matches_reference():
    """``_run_encoder``: the projection of the f32 frames, two non-causal
    attention + MLP layers, the encoder norm."""
    jcfg, tcfg = _configs("seamless-m4t-large-v2")
    jparams, tparams = _weights("seamless-m4t-large-v2")
    frames = _batch(tcfg)["frames"]
    want = jax.jit(lambda p, f: JMDL._run_encoder(jcfg, p, f))(jparams, jnp.asarray(frames))
    got = MDL._run_encoder(tcfg, tparams, torch.from_numpy(frames))
    assert got.shape == (B, tcfg.frontend_len, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "flash-flag"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch, kernels):
    """Last-position logits of prefill with the frontend's inputs, the
    flash flag off and on (it reaches only the decoder's self-attention:
    the plain version here, Pallas interpret there; internvl2's 16 + 24
    positions are ragged against the kernel's 128-row tiles)."""
    jcfg, tcfg = _configs(arch, use_flash_kernel=kernels)
    jparams, tparams = _weights(arch)
    batch = _batch(tcfg)
    del batch["targets"], batch["sample_mask"]
    want = jax.jit(lambda p, b: JMDL.prefill(jcfg, p, b))(jparams, _jax(batch))
    got = MDL.prefill(tcfg, tparams, _torch(batch))
    assert got.shape == (B, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_flash_reaches_only_the_decoder_self_attention(arch, monkeypatch):
    """With the flag on, prefill calls the flash kernel's entry once per
    decoder layer: never from the encoder or the cross blocks, which take
    the blockwise path as the reference's do (``src/repro/models/
    model.py:239-246``, ``:149-156``), and never while decoding."""
    _, tcfg = _configs(arch, use_flash_kernel=True)
    _, tparams = _weights(arch)
    calls = []

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention", counted)
    batch = _torch(_batch(tcfg))
    MDL.prefill(tcfg, tparams, batch)
    n_pos = S + (tcfg.frontend_len if tcfg.frontend == "vision" else 0)
    assert calls == [(B, n_pos, tcfg.n_heads, tcfg.resolved_head_dim)] * tcfg.n_layers
    cache = MDL.init_cache(tcfg, B, 4, device="cpu")
    MDL.decode_step(tcfg, tparams, cache, batch["tokens"][:, :1])
    assert len(calls) == tcfg.n_layers


# --------------------------------------------------------------------------
# training: loss_fn and its gradient, remat, the replica-stacked loss
# --------------------------------------------------------------------------


def _port_value_and_grad(tcfg, flat, batch):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, aux = MDL.make_model(tcfg).loss_fn(leaves, _torch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, aux, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and every leaf's gradient (the encoder, the cross blocks
    and ``frontend_proj`` among them) against ``jax.value_and_grad``, with
    a masked sample; internvl2's loss skips the patch positions."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(arch)
    batch = _batch(tcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JMDL.loss_fn(jcfg, p, b), has_aux=True))
    (want, want_aux), jgrads = fn(jparams, _jax(batch))
    want_grads = tu.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, aux, grads = _port_value_and_grad(tcfg, tu.flatten(tparams), batch)
    np.testing.assert_allclose(_np(loss), _np(want), **TOL)
    for k in ("accuracy", "n_valid", "moe_aux", "ce_loss"):
        np.testing.assert_allclose(_np(aux[k]), _np(want_aux[k]), err_msg=k, **TOL)
    assert float(aux["n_valid"]) == 1.0
    assert sorted(grads) == sorted(want_grads)
    new = [k for k in grads if k.startswith(("encoder.", "cross.", "frontend_proj"))]
    assert len(new) == ({"seamless-m4t-large-v2": 9 + 1 + 2 * 5 + 1, "internvl2-2b": 1}[arch])
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(want_grads[k]), err_msg=k, **TOL)
        if k != "embed.table":
            assert _np(g).any(), f"{k}: no gradient"


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_training_launcher_stops_as_the_reference_does(arch):
    """The token stream yields no ``frames`` or ``patch_embeds`` (nor does
    the reference's, ``src/repro/data/providers.py:107-146``), so the LM
    workload stops at the first loss with the reference's ``KeyError``."""
    field = FIELD[torch_archs.ARCHS[arch].frontend]
    with pytest.raises(KeyError, match=field):
        port_train.main(["--workload", "lm", "--arch", arch, "--reduced", "--device", "cpu",
                         "--megabatches", "1", "--mega-batch", "2", "--b-max", "2",
                         "--seq-len", "8", "--replicas", "2"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_policies_change_no_number(arch):
    """remat off, 'full' and 'dots' (the encoder's layers and the decoder's
    groups under checkpointing) give bitwise the same loss and gradients."""
    _, tcfg = _configs(arch)
    _, tparams = _weights(arch)
    flat, batch = tu.flatten(tparams), _batch(tcfg, seed=1)
    runs = [_port_value_and_grad(dataclasses.replace(tcfg, remat=remat, remat_policy=policy),
                                 flat, batch)
            for remat, policy in ((False, "full"), (True, "full"), (True, "dots"))]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for k, g in grads.items():
            assert torch.equal(g, runs[0][2][k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_replica_stacked_loss_carries_the_frontend(arch):
    """``make_model``'s loss over (R, ...) leaves and (R, B, ...) batches:
    each replica's loss from its own weights and its own ``frames`` /
    ``patch_embeds``, as ``jax.vmap`` of the reference's ``loss_fn``."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(arch)
    R = 2
    jstack = jax.tree_util.tree_map(lambda a: jnp.stack([a, a * 0.5]), jparams)
    batch = _batch(tcfg, lead=(R,), seed=2)
    want, want_aux = jax.jit(jax.vmap(lambda p, b: JMDL.loss_fn(jcfg, p, b)))(jstack, _jax(batch))
    flat = {k: torch.stack([v, v * 0.5]) for k, v in tu.flatten(tparams).items()}
    got, aux = MDL.make_model(tcfg).loss_fn(flat, _torch(batch))
    assert got.shape == (R,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(aux["accuracy"]), _np(want_aux["accuracy"]), **TOL)
    # replica 1 with replica 0's frontend input gives another loss
    swapped = dict(batch)
    swapped[FIELD[tcfg.frontend]] = batch[FIELD[tcfg.frontend]][[0, 0]]
    other, _ = MDL.make_model(tcfg).loss_fn(flat, _torch(swapped))
    assert other[0] == got[0] and not torch.allclose(other[1], got[1], **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_builders_match_reference(arch):
    """``launch/steps.py`` with frontend inputs: the prefill step, and one
    lockstep round over R = 3 replicas (one masked) whose batches carry
    each replica's own ``frames`` / ``patch_embeds``."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(arch)
    batch = _batch(tcfg, lead=(3,), seed=4)
    prefill_in = {k: v[0] for k, v in batch.items() if k not in ("targets", "sample_mask")}
    want = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, _jax(prefill_in))
    got = steps.make_prefill_step(tcfg)(tparams, _torch(prefill_in))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    rng = np.random.default_rng(5)
    jreps = jax.tree_util.tree_map(
        lambda l: np.asarray(l)[None] + 0.01 * rng.normal(size=(3,) + l.shape).astype(l.dtype),
        jparams)
    reps = tu.flatten(MDL.params_from_jax(jreps, "cpu"))
    lr = np.array([0.1, 0.05, 0.2], np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want, want_m = jax.jit(jsteps.make_train_round(jcfg))(
        jax.tree_util.tree_map(jnp.asarray, jreps), _jax(batch), lr, mask)
    got, got_m = steps.make_train_round(tcfg)(reps, _torch(batch), torch.from_numpy(lr),
                                              torch.from_numpy(mask))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(_np(got_m[k]), _np(want_m[k]), err_msg=k, **TOL)
    want_flat = tu.flatten(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(got) == sorted(want_flat)
    for k, v in got.items():
        np.testing.assert_allclose(_np(v), want_flat[k], err_msg=k, **TOL)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_reference(arch, window):
    """12 decode steps from an empty cache (the rolling buffer of 8 wraps):
    the logits of every step and every cache leaf at the end. Decoding
    sees no frontend input in either package: seamless's ``cross_kv``
    stays zero, internvl2 starts at position 0."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(arch)
    tokens = _batch(tcfg, seed=3)["tokens"][:, :12]
    jcache = JMDL.init_cache(jcfg, B, 12, window)
    tcache = MDL.init_cache(tcfg, B, 12, window, device="cpu")
    jstep = jax.jit(lambda p, c, t: JMDL.decode_step(jcfg, p, c, t, window=window))
    for i in range(12):
        want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]))
        got, tcache = MDL.decode_step(tcfg, tparams, tcache, torch.from_numpy(tokens[:, i : i + 1]),
                                      window)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"step {i}")
    assert tcache["cur_len"] == int(jcache["cur_len"]) == 12
    jleaves = jax.tree_util.tree_flatten_with_path({k: v for k, v in jcache.items()
                                                   if k != "cur_len"})[0]
    tleaves = jax.tree_util.tree_flatten({k: v for k, v in tcache.items() if k != "cur_len"})[0]
    assert len(jleaves) == len(tleaves) > 0
    for (path, want), got in zip(jleaves, tleaves):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=str(path))
    assert ("cross_kv" in tcache) == (tcfg.encoder_layers > 0)
    for kv in tcache.get("cross_kv", []):
        assert kv["k"].shape == (B, tcfg.frontend_len, tcfg.n_kv_heads, tcfg.resolved_head_dim)
        assert not kv["k"].any() and not kv["v"].any()


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_without_a_card_raises(arch, monkeypatch):
    """The launcher's default device is the card: with none it raises, and
    runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced", "--batch", "2", "--context", "4", "--gen", "2"])


# --------------------------------------------------------------------------
# launch/specs.py
# --------------------------------------------------------------------------


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list(torch_archs.ARCHS))
def test_input_specs_match_reference(arch, shape):
    """Every input's shape and dtype at full width, as the reference's
    ``input_specs`` gives them (its decode cache through
    ``jax.eval_shape``, the port's on the meta device)."""
    want = JSP.input_specs(jax_archs.ARCHS[arch], INPUT_SHAPES[shape])
    got = SP.input_specs(torch_archs.ARCHS[arch], INPUT_SHAPES[shape])
    assert SP.decode_window(torch_archs.ARCHS[arch], INPUT_SHAPES[shape]) == JSP.decode_window(
        jax_archs.ARCHS[arch], INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    if "cache" in want:
        want = dict(want, cache={k: v for k, v in want["cache"].items() if k != "cur_len"})
        assert got["cache"].pop("cur_len") == 0
    want_leaves, want_tree = jax.tree_util.tree_flatten(want)
    got_leaves, got_tree = jax.tree_util.tree_flatten(
        got, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], torch.dtype))
    assert got_tree == want_tree
    for (g_shape, g_dtype), w in zip(got_leaves, want_leaves):
        assert (tuple(g_shape), _dtype_name(g_dtype)) == (tuple(w.shape), str(w.dtype))


@pytest.mark.parametrize("arch", list(torch_archs.ARCHS))
def test_make_train_batch_matches_reference(arch):
    """Tokens, targets and the mask bit for bit; the frontend field (drawn
    from another generator) in the reference's shape and dtype."""
    cfg = torch_archs.ARCHS[arch].reduced()
    want = JSP.make_train_batch(jax_archs.ARCHS[arch].reduced(), 3, 16, seed=4)
    got = SP.make_train_batch(cfg, 3, 16, seed=4, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("tokens", "targets", "sample_mask"):
        assert got[k].dtype == {"sample_mask": torch.bool}.get(k, torch.int32)
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in set(got) - {"tokens", "targets", "sample_mask"}:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        assert torch.equal(got[k], SP.make_train_batch(cfg, 3, 16, seed=4, device="cpu")[k])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_inputs_match_reference(arch):
    """make_decode_inputs: the same token draw and a cache of the
    reference's shapes holding ``context - 1`` tokens, from which a decode
    step gives the reference's logits."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(arch)
    jtok, jcache = JSP.make_decode_inputs(jcfg, B, 16, seed=5)
    ttok, tcache = SP.make_decode_inputs(tcfg, B, 16, seed=5, device="cpu")
    assert np.array_equal(ttok.numpy(), np.asarray(jtok)) and tcache["cur_len"] == 15
    want, _ = JMDL.decode_step(jcfg, jparams, jcache, jtok)
    got, _ = MDL.decode_step(tcfg, tparams, tcache, ttok)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
