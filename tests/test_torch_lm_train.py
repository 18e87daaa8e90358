"""LM training in the port against the reference, piece by piece, from the
same weights (``params_from_jax``) and the same numpy batches:

* ``loss_fn`` — loss, accuracy, n_valid, moe_aux and ce_loss — and the
  gradient of every leaf against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` on reduced llama3.2-1b, mamba2-780m, moonshot-v1-16b-a3b and
  jamba-1.5-large-398b, with a masked sample in the batch: f32 within rtol
  2e-4 / atol 2e-5, the reference's kernel tolerance (tests/test_kernels.py);
  bf16 as ``BF16_TOL`` and ``BF16_GRAD_FACTOR`` below say; and the MoE
  FFN's gradients under capacity overflow;
* activation checkpointing: ``remat`` off, 'full' and 'dots' give the same
  losses and gradients, bitwise;
* ``make_train_round`` and ``make_merge_step`` (``keep_global`` both ways)
  against the reference's on the same replicas;
* the model's flat tree (``utils.tree.flatten``/``unflatten``);
* the kernel flags: ``make_model`` refuses them, and no LM kernel wrapper
  returns an output that cuts the gradient;
* the launcher's LM workload end to end on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.launch import steps as jsteps
from repro.models import model as JMDL
from repro.models import moe as JMOE
from repro_torch.configs import archs as torch_archs
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_cuda
from repro_torch.kernels.moe_gmm.ops import moe_ffn_gmm, moe_ffn_gmm_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
from repro_torch.launch import steps
from repro_torch.launch import train as port_train
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.utils import tree as tu
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
# bf16, the loss and its aux (scalars): measured within 3.5e-4 relative
# (mamba2's loss), accuracy equal
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
# bf16 gradients: every matmul output and every backward product rounds to
# bf16, in each framework in its own order, so neither bf16 gradient is the
# other's to a tolerance per element. Each leaf is held instead to the f32
# gradient at the same (bf16) weights, by its relative L2 error, and must
# come no further from it than BF16_GRAD_FACTOR times the reference's own
# bf16 gradient does. Measured: the reference's bf16 gradients are 8.0e-3
# to 4.7e-2 from the f32 one, the port's 7.9e-3 to 6.6e-2, the largest
# ratio 1.53 (jamba's router); a dropped or halved leaf is 1 and 0.5 off.
BF16_GRAD_FACTOR = 2.0
ARCHS = ["llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"]
AUX = ("accuracy", "n_valid", "moe_aux", "ce_loss")
B, S = 3, 32


pytestmark = pytest.mark.usefixtures("one_thread")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_archs.ARCHS[arch].reduced(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(torch_archs.ARCHS[arch].reduced(), dtype=dtype, **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32"):
    """The reference's reduced weights, as its tree and the port's flat dict."""
    jcfg, _ = _configs(arch, dtype)
    jparams = JMDL.init(jcfg, jax.random.PRNGKey(0))
    flat = tu.flatten(MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jparams, flat


def _batch(vocab, lead=(), seed=0):
    """Tokens, targets and a sample mask with a masked sample per batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=lead + (B, S + 1)).astype(np.int32)
    mask = np.ones(lead + (B,), bool)
    mask[..., 1] = False
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:], "sample_mask": mask}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want)))


def _port_value_and_grad(tcfg, flat, batch):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, aux = MDL.make_model(tcfg).loss_fn(leaves, _torch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, aux, dict(zip(leaves, grads))


# --------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, flat = _weights(arch, dtype)
    batch = _batch(tcfg.vocab_size)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def value_and_grad(cfg, params):
        fn = jax.jit(jax.value_and_grad(lambda p, b: JMDL.loss_fn(cfg, p, b), has_aux=True))
        (loss, aux), grads = fn(params, jbatch)
        return loss, aux, tu.flatten(jax.tree_util.tree_map(np.asarray, grads))

    want, want_aux, want_grads = value_and_grad(jcfg, jparams)
    loss, aux, grads = _port_value_and_grad(tcfg, flat, batch)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(loss), _np(want), **tol)
    for k in AUX:
        np.testing.assert_allclose(_np(aux[k]), _np(want_aux[k]), err_msg=k, **tol)
    assert float(aux["n_valid"]) == 2.0                 # the masked sample does not count
    assert sorted(grads) == sorted(want_grads)
    if dtype == "bfloat16":   # the f32 gradient at the same bf16 weights
        f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
        _, _, exact = value_and_grad(dataclasses.replace(jcfg, dtype="float32"), f32)
    for k, g in grads.items():
        assert g.dtype == flat[k].dtype and g.shape == flat[k].shape, k
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(want_grads[k]), err_msg=k, **F32_TOL)
        else:
            got_err, ref_err = _rel_l2(g, exact[k]), _rel_l2(want_grads[k], exact[k])
            assert got_err <= BF16_GRAD_FACTOR * ref_err, (k, got_err, ref_err)
        if k != "embed.table":      # rows of tokens no batch names stay 0 there
            assert _np(g).any(), f"{k}: no gradient"


def test_masked_samples_carry_no_gradient():
    """A batch whose every sample is masked: loss 0 (n_valid clamped to 1),
    and no gradient reaches the model (llama has no MoE aux loss)."""
    _, tcfg = _configs("llama3.2-1b")
    _, flat = _weights("llama3.2-1b")
    batch = _batch(tcfg.vocab_size)
    batch["sample_mask"][:] = False
    loss, aux, grads = _port_value_and_grad(tcfg, flat, batch)
    assert loss.item() == 0.0 and aux["n_valid"].item() == 0.0
    assert all(not g.any() for g in grads.values())


def test_moe_grads_under_capacity_overflow_match_reference():
    """The MoE block at capacity factor 0.3: 5 slots for ~16 assignments
    per expert. The
    reference's scatter lets the last write win, so the kept assignment at
    slot capacity-1 is overwritten by a zeroed overflow row and gets no
    gradient; the port's two ``index_put`` give the same."""
    jp = JMOE.init_moe(jax.random.PRNGKey(0), 64, 128, 4, jnp.float32)
    tp = MDL.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(3).normal(size=(4, 8, 64)).astype(np.float32)
    dy = np.random.default_rng(4).normal(size=(4, 8, 64)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=0.3)

    def jloss(p, x):
        y, aux = JMOE.moe_layer(p, x, **kw)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = MOE.moe_layer(leaves, xt, **kw)
    ((y.float() * torch.from_numpy(dy)).sum() + aux).backward()
    np.testing.assert_allclose(_np(xt.grad), _np(want_x), **F32_TOL)
    for k, v in leaves.items():
        np.testing.assert_allclose(_np(v.grad), _np(want_p[k]), err_msg=k, **F32_TOL)


# --------------------------------------------------------------------------
# activation checkpointing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_change_no_number(arch):
    """remat off, 'full' and 'dots': the recomputation repeats the same ops
    on the same inputs, so loss, aux and every gradient are bitwise equal."""
    _, flat = _weights(arch)
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, tcfg = _configs(arch, remat=remat, remat_policy=policy)
        runs.append(_port_value_and_grad(tcfg, flat, _batch(tcfg.vocab_size, seed=1)))
    (loss0, aux0, grads0), rest = runs[0], runs[1:]
    for loss, aux, grads in rest:
        assert torch.equal(loss, loss0)
        assert all(torch.equal(aux[k], aux0[k]) for k in AUX)
        for k, g in grads.items():
            assert torch.equal(g, grads0[k]), k


def test_dots_policy_keeps_the_matmul_outputs(monkeypatch):
    """'dots' saves the (M,K)x(K,N) products and only them: reduced llama
    has 2 layers of 7 projections (q, k, v, o; gate, up, down), all in the
    checkpointed groups; attention's batched einsums are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    save_dots, seen = MDL._save_dots, []

    def policy(ctx, op, *args, **kwargs):
        decision = save_dots(ctx, op, *args, **kwargs)
        seen.append((op, decision, ctx.is_recompute))
        return decision

    monkeypatch.setattr(MDL, "_save_dots", policy)
    _, tcfg = _configs("llama3.2-1b", remat_policy="dots")
    _port_value_and_grad(tcfg, _weights("llama3.2-1b")[1], _batch(tcfg.vocab_size))
    saved = [op for op, decision, recompute in seen
             if decision == CheckpointPolicy.MUST_SAVE and not recompute]
    assert len(saved) == 14 and set(saved) <= set(MDL._DOTS), saved
    assert torch.ops.aten.bmm.default in {op for op, _, _ in seen}


# --------------------------------------------------------------------------
# the flat tree
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "kimi-k2-1t-a32b", "tinyllama-1.1b"])
def test_flat_tree_round_trip(arch):
    cfg = torch_archs.ARCHS[arch].reduced()
    params = MDL.init(cfg, torch.Generator().manual_seed(0))
    flat = tu.flatten(params)
    assert list(flat) == list(tu.flatten(MDL.init(cfg, torch.Generator().manual_seed(1))))
    back = tu.unflatten(flat)
    nonempty = {k: v for k, v in params.items() if not (isinstance(v, list) and not v)}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(nonempty)
    again = tu.flatten(back)
    assert list(again) == list(flat) and all(again[k] is v for k, v in flat.items())
    assert all(v.is_contiguous() for v in flat.values())


def test_tinyllama_has_twelve_leaves():
    """One leaf per stacked tensor: the merge launches once per leaf."""
    flat = MDL.make_model(torch_archs.ARCHS["tinyllama-1.1b"].reduced()).init(
        torch.Generator().manual_seed(0))
    assert list(flat) == [
        "embed.table",
        *(f"blocks.pos0.mixer.{k}" for k in ("wq", "wk", "wv", "wo", "norm")),
        *(f"blocks.pos0.ffn.{k}" for k in ("wi", "wg", "wo", "norm")),
        "final_norm", "lm_head",
    ]
    assert flat["blocks.pos0.ffn.wi"].shape == (2, 256, 512)


# --------------------------------------------------------------------------
# step functions against the reference's
# --------------------------------------------------------------------------


def _replicas(arch, R=3):
    """R different replicas: the reference's weights plus a per-replica
    perturbation, as both packages' (R, ...) trees."""
    jparams, _ = _weights(arch)
    rng = np.random.default_rng(5)
    jreps = jax.tree_util.tree_map(
        lambda l: np.asarray(l)[None] + 0.01 * rng.normal(size=(R,) + l.shape).astype(l.dtype),
        jparams)
    flat = tu.flatten(MDL.params_from_jax(jreps, "cpu"))
    return jax.tree_util.tree_map(jnp.asarray, jreps), flat


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
def test_train_round_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    jreps, reps = _replicas(arch)
    batch = _batch(tcfg.vocab_size, lead=(3,), seed=2)
    lr = np.array([0.1, 0.05, 0.2], np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want, want_m = jax.jit(jsteps.make_train_round(jcfg))(
        jreps, jax.tree_util.tree_map(jnp.asarray, batch), lr, mask)
    got, got_m = steps.make_train_round(tcfg)(reps, _torch(batch), torch.from_numpy(lr),
                                              torch.from_numpy(mask))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(_np(got_m[k]), _np(want_m[k]), err_msg=k, **F32_TOL)
    want_flat = tu.flatten(jax.tree_util.tree_map(np.asarray, want))
    for k, v in got.items():
        np.testing.assert_allclose(_np(v), want_flat[k], err_msg=k, **F32_TOL)
    # the masked replica is left exactly as it was
    for k, v in tu.flatten(jax.tree_util.tree_map(np.asarray, jreps)).items():
        np.testing.assert_array_equal(_np(got[k][1]), v[1], err_msg=k)


@pytest.mark.parametrize("keep_global", [True, False])
def test_merge_step_matches_reference(keep_global):
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg = _configs(arch)
    jreps, reps = _replicas(arch)
    jparams, flat = _weights(arch)
    alphas = np.array([0.5, 0.2, 0.3])
    if keep_global:
        jprev = jax.tree_util.tree_map(lambda l: l * 0.9, jparams)
        prev = tu.tree_map(lambda l: l * 0.9, flat)
        want_g, want_r = jsteps.make_merge_step(jcfg, 0.9, True)(jreps, alphas, jparams, jprev)
        got_g, got_r = steps.make_merge_step(tcfg, 0.9, True)(reps, alphas, flat, prev)
    else:
        want_r = jsteps.make_merge_step(jcfg, keep_global=False)(jreps, alphas)
        got_r = steps.make_merge_step(tcfg, keep_global=False)(reps, alphas)
        want_g = jax.tree_util.tree_map(lambda l: l[0], want_r)
        got_g = tu.tree_map(lambda l: l[0], got_r)
    want_g = tu.flatten(jax.tree_util.tree_map(np.asarray, want_g))
    want_r = tu.flatten(jax.tree_util.tree_map(np.asarray, want_r))
    for k in flat:
        np.testing.assert_allclose(_np(got_g[k]), want_g[k], err_msg=k, **F32_TOL)
        np.testing.assert_allclose(_np(got_r[k]), want_r[k], err_msg=k, **F32_TOL)
        assert got_r[k].shape == (3,) + flat[k].shape and got_r[k].is_contiguous()


# --------------------------------------------------------------------------
# kernel flags: forward-only kernels never cut a gradient
# --------------------------------------------------------------------------


def _flash_inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 16, 2, 16, generator=g) for _ in range(3)]


def _ssd_inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 16, 2, 8, generator=g), -torch.rand(1, 16, 2, generator=g),
            torch.randn(1, 16, 2, 4, generator=g), torch.randn(1, 16, 2, 4, generator=g)]


def _gmm_inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 4, 8, generator=g), torch.randn(2, 8, 16, generator=g),
            torch.randn(2, 8, 16, generator=g), torch.randn(2, 16, 8, generator=g)]


WRAPPERS = {
    "flash_attention": (flash_attention, flash_attention_cuda, _flash_inputs, {}),
    "ssd_scan": (ssd_scan, ssd_scan_cuda, _ssd_inputs, {"chunk": 8}),
    "moe_ffn_gmm": (moe_ffn_gmm, moe_ffn_gmm_cuda, _gmm_inputs, {}),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_kernel_wrappers_refuse_to_record_a_gradient(name):
    """On the CPU the plain version could be differentiated, but the card's
    kernel could not: the public wrapper raises alike on every device, and
    the CUDA wrapper before it looks at the device. Without grad (or under
    ``no_grad``) the wrapper runs."""
    public, cuda, inputs, kw = WRAPPERS[name]
    msg = f"{name} has no backward"
    for i in range(len(inputs())):
        args = inputs()
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match=msg):
            public(*args, **kw)
        with pytest.raises(RuntimeError, match=msg):
            cuda(*args, **kw)
        with torch.no_grad():
            public(*args, **kw)
    public(*inputs(), **kw)


@pytest.mark.parametrize("flag", MDL.KERNEL_FLAGS)
def test_training_refuses_kernel_flags(flag):
    """``make_model`` (what the trainer takes) refuses the flag by name;
    ``loss_fn`` called past it reaches the kernel's wrapper, which refuses
    to be recorded by autograd; without grad the loss evaluates."""
    _, tcfg = _configs("jamba-1.5-large-398b", **{flag: True})
    _, flat = _weights("jamba-1.5-large-398b")
    with pytest.raises(NotImplementedError, match=flag):
        MDL.make_model(tcfg)
    params = tu.unflatten({k: v.clone().requires_grad_(True) for k, v in flat.items()})
    batch = _torch(_batch(tcfg.vocab_size))
    with pytest.raises(RuntimeError, match="has no backward"):
        MDL.loss_fn(tcfg, params, batch)
    with torch.no_grad():
        loss, _ = MDL.loss_fn(tcfg, params, batch)
    assert torch.isfinite(loss)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def test_launcher_trains_an_lm_by_default_on_cpu(tmp_path):
    """No --workload: the LM (tinyllama-1.1b, reduced) trains and writes its
    records, with the reference's defaults for the workload and arch."""
    out = tmp_path / "log.json"
    state, mlog = port_train.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--megabatches", "2", "--mega-batch", "8", "--b-max", "4", "--seq-len", "16",
        "--out", str(out),
    ])
    records = json.loads(out.read_text())
    assert [r["megabatch"] for r in records] == [1, 2]
    assert records == json.loads(json.dumps(mlog.records))
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"]) for r in records)
    assert "blocks.pos0.ffn.wi" in state.global_model
    assert state.global_model["embed.table"].shape == (512, 256)
    # the reference's defaults (src/repro/launch/train.py)
    args = port_train.parser().parse_args([])
    assert (args.workload, args.arch, args.seq_len, args.reduced) == (
        "lm", "tinyllama-1.1b", 128, False)
