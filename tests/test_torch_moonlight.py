"""The port's latent-attention config (Moonlight-16B-A3B,
``configs/moonlight_16b_a3b.py``) on the CPU in f32, at small widths
(``MLAMoEConfig.reduced``: d 64, 4 heads, kv rank 32, q/k heads 16 + 8, v
heads 16, 16 experts of 24 in shares of 4, top 4, shared 2 x 24, dense 96,
vocab 256; 1 dense + 2 MoE layers, 32 tokens), against the plain reference
(``tests/moonlight_ref.py``): the latent attention, the router, the whole
model's loss and every gradient, the expert shares against the uncut
layer, two mega-batches of Adaptive SGD through ``ElasticTrainer``, the
``--arch`` lookup, and the refusals of what the config lacks."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import moonlight_ref as REF
from repro_torch.configs import archs
from repro_torch.configs.moonlight_16b_a3b import MOONLIGHT_16B_A3B, arch
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.utils import tree as tu

ROOT = Path(__file__).resolve().parents[1]
CFG = MOONLIGHT_16B_A3B.reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_config(cfg) -> dict:
    """The reference's constants (the source's ``config.json`` keys)."""
    return dict(num_attention_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_head_dim, qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, num_experts_per_tok=cfg.top_k,
                routed_scaling_factor=cfg.routed_scaling_factor, first_expert=cfg.first_expert,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps)


def setup(cfg=CFG, seed=0):
    params = MDL.init(cfg, torch.Generator().manual_seed(seed))
    buffers = MDL.init_buffers(cfg, torch.Generator().manual_seed(seed + 1))
    return tu.flatten(params), buffers


def rel(a, b) -> float:
    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double()).clamp_min(1e-30)).item()


def _gain(n, seed):
    return 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(seed))


def test_latent_attention_and_its_gradients_match_the_reference():
    flat, _ = setup()
    p = {k[len("prefix.0.mixer."):]: v.clone().requires_grad_(True)
         for k, v in flat.items() if k.startswith("prefix.0.mixer.")}
    with torch.no_grad():   # gains away from 0, so a norm left out shows
        p["kv_norm"].copy_(_gain(CFG.kv_lora_rank, 1))
        p["norm"].copy_(_gain(CFG.d_model, 2))
    x = torch.randn(2, 16, CFG.d_model, generator=torch.Generator().manual_seed(3))
    got = L.mla_layer(p, x, kv_rank=CFG.kv_lora_rank, nope=CFG.qk_nope_head_dim,
                      rope=CFG.qk_rope_head_dim, v_dim=CFG.v_head_dim,
                      rope_theta=CFG.rope_theta, norm_eps=CFG.norm_eps)
    m = REF.Model(ref_config(CFG))
    want = torch.stack([REF.attention(m, p, x[b]) for b in range(2)])
    assert rel(got, want) < 1e-5
    g_got = torch.autograd.grad(got.square().sum(), list(p.values()))
    g_want = torch.autograd.grad(want.square().sum(), list(p.values()))
    for k, a, b in zip(p, g_got, g_want):
        assert rel(a, b) < 1e-5, k


def test_the_router_matches_the_reference():
    flat, buffers = setup()
    router, bias = flat["blocks.pos0.ffn.router"][0], buffers["blocks.pos0.ffn.score_bias"][0]
    h = torch.randn(32, CFG.d_model, generator=torch.Generator().manual_seed(4))
    w, ids = MOE.route_sigmoid(router, bias, h, CFG.top_k, CFG.routed_scaling_factor)
    w_ref, ids_ref = REF.route(REF.Model(ref_config(CFG)), router, bias, h)
    assert torch.equal(ids, ids_ref)
    assert rel(w, w_ref) < 1e-6
    # the bias changes the selection, and the weights sum to the scale
    plain = torch.topk(torch.sigmoid(h @ router), CFG.top_k).indices
    assert not torch.equal(ids.sort(-1).values, plain.sort(-1).values)
    assert torch.allclose(w.sum(-1), torch.full((32,), CFG.routed_scaling_factor))


def _batch(mask, seed=5):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, CFG.vocab_size, (2, 17), generator=g)
    return {"tokens": t[:, :-1], "targets": t[:, 1:], "sample_mask": torch.tensor(mask)}


@pytest.mark.parametrize("mask", [(True, True), (False, True)], ids=["full", "padded"])
def test_the_models_loss_and_every_gradient_match_the_reference(mask):
    """Two sequences of 16; with a padded (masked) row, which the dropless
    MoE layers route to no expert, the reference sees the valid one only."""
    flat, buffers = setup()
    with torch.no_grad():
        for i, (k, v) in enumerate(flat.items()):
            if k.endswith("norm"):
                v.copy_(_gain(v.shape, i))
    batch = _batch(list(mask))
    model = MDL.make_model(CFG, buffers)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, aux = model.loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))

    m = REF.Model(ref_config(CFG))
    ref_leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    biases = REF.layer_biases(buffers, ref_leaves)
    rows = [b for b in range(2) if mask[b]]
    n_tok = len(rows) * batch["targets"].shape[1]
    want = sum(REF.sequence_nll(m, ref_leaves, biases, batch["tokens"][b], batch["targets"][b])
               for b in rows) / n_tok
    ref_grads = torch.autograd.grad(want, list(ref_leaves.values()))
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert aux["moe_aux"].item() == 0.0
    for k, a, b in zip(leaves, grads, ref_grads):
        assert rel(a, b) < 1e-5, k


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Four cards' shares of 4 experts: their outputs, less 3 x the shared
    experts every card computes alike, equal the reference's uncut layer
    (all 16 experts); each share routes over all 16."""
    flat, buffers = setup(dataclasses.replace(CFG, experts_held=0))
    p = tu.unflatten({k[len("blocks.pos0.ffn."):]: v[0] for k, v in flat.items()
                      if k.startswith("blocks.pos0.ffn.")})
    p["score_bias"] = buffers["blocks.pos0.ffn.score_bias"][0]
    x = torch.randn(1, 32, CFG.d_model, generator=torch.Generator().manual_seed(6))
    kw = dict(top_k=CFG.top_k, scale=CFG.routed_scaling_factor, norm_eps=CFG.norm_eps)
    total = torch.zeros_like(x)
    for s in range(4):
        share = dict(p, **{k: p[k][4 * s:4 * s + 4] for k in ("wi", "wg", "wo")})
        out, _ = MOE.moe_layer_dropless(share, x, first_expert=4 * s, **kw)
        total += out - x
    h = L.rmsnorm(x, p["norm"], CFG.norm_eps)[0]
    shared = MOE.shared_swiglu(p["shared"], h)
    m = REF.Model(dict(ref_config(CFG), first_expert=0))
    ref_p = {k: v for k, v in p.items() if k not in ("shared", "score_bias")}
    ref_p.update({f"shared.{k}": v for k, v in p["shared"].items()})
    want = REF.moe(m, ref_p, p["score_bias"], x[0]) - x[0]
    assert rel(total[0] - 3 * shared, want) < 1e-5


def test_two_megabatches_through_the_trainer_repeat_the_reference_replay():
    """Adaptive SGD (R = 4, b_max 4, 6 batches a mega-batch, the overlap
    pipeline) through ``ElasticTrainer``: the host decisions of each
    mega-batch are the plain replay's (``perfbench/reference``), and the
    selection bias, a buffer, is no trained leaf."""
    sys.path.insert(0, str(ROOT))
    from perfbench.reference import check
    from perfbench.reference.moonlight import replay_decisions
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.heterogeneity import SpeedModel
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.providers import TokenProvider

    traffic = dict(replicas=4, b_max=4, mega_batch=6, overlap=True, speed="simulated",
                   max_gap=0.32, lr=0.05, seq_len=8)
    seed = 2**31 + 9
    _, buffers = setup()
    trainer = ElasticTrainer(
        model=MDL.make_model(CFG, buffers),
        provider=TokenProvider.make(CFG.vocab_size, traffic["seq_len"], seed=seed),
        cfg=ElasticConfig.from_bmax(4, n_replicas=4, mega_batch=6),
        speed=SpeedModel(4, max_gap=0.32, seed=seed), seed=seed, device="cpu",
        sparse_grads=False)
    state = trainer.init_state()
    assert not any("score_bias" in k for k in state.global_model)
    got = []
    for _ in range(2):
        state, info = trainer.run_megabatch(state, prefetch=True)
        got.append(dict(u=info["u"], n_rounds=info["n_rounds"],
                        b=np.asarray(state.b, np.float64).tolist(),
                        lr=np.asarray(state.lr, np.float64).tolist()))
        assert np.isfinite(info["train_loss"])
    trainer.close()
    want = replay_decisions({}, traffic, seed, 2)
    assert check.decision_mismatches(got, want) == 0


def test_the_arch_resolves_beside_an_unchanged_archs():
    from repro_torch.launch.train import parser

    assert arch("moonlight-16b-a3b") is MOONLIGHT_16B_A3B
    assert "moonlight-16b-a3b" not in archs.ARCHS
    assert list(archs.ARCHS) == archs.ARCH_IDS
    assert arch("tinyllama-1.1b") is archs.ARCHS["tinyllama-1.1b"]
    assert parser().parse_args(["--arch", "moonlight-16b-a3b"]).arch == "moonlight-16b-a3b"
    c = MOONLIGHT_16B_A3B
    assert (c.d_model, c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
            c.n_heads, c.n_experts, c.top_k, c.n_shared_experts, c.dense_d_ff, c.d_ff) == \
        (2048, 512, 128, 64, 128, 16, 64, 6, 2, 11264, 1408)


@pytest.mark.parametrize("what", ["prefill", "init_cache", "decode_step"])
def test_serving_refuses_latent_attention(what):
    flat, _ = setup()
    tokens = torch.zeros((1, 4), dtype=torch.long)
    call = {"prefill": lambda: MDL.prefill(CFG, tu.unflatten(flat), {"tokens": tokens}),
            "init_cache": lambda: MDL.init_cache(CFG, 1, 8),
            "decode_step": lambda: MDL.decode_step(CFG, tu.unflatten(flat), {}, tokens[:, :1])}
    with pytest.raises(ValueError, match="cache of the compressed KV latent"):
        call[what]()


def test_the_flash_kernel_flag_is_refused_on_latent_attention():
    with pytest.raises(ValueError, match="q/k 24 and v 16"):
        dataclasses.replace(CFG, use_flash_kernel=True)


def test_the_partitioned_path_refuses_latent_attention():
    from repro_torch.sharding.rules import MeshAxes

    with pytest.raises(ValueError, match="sharding rules for its leaves"):
        MeshAxes(CFG, mesh=None)
