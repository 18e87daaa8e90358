"""The per-device cost analysis (``repro_torch.launch.cost_analysis``)
against the reference's HLO analyzer (``repro.launch.hlo_analysis``): the
counterparts of ``tests/test_hlo_analysis.py`` on traced programs with
known analytic costs, then the matmul FLOPs of one reduced LM step on one
device against ``analyze(compiled.as_text())`` of the reference's jitted
step, within 2%, and tensor parallelism over 2 on a (1, 2) fake mesh
halving them."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.launch import specs as REF_SP
from repro.launch import steps as REF_STEPS
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.models import model as REF_MDL
from repro_torch.configs.archs import ARCHS
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import steps as ST
from repro_torch.models import model as MDL
from repro_torch.utils import tree as tu

B, S, R = 2, 64, 2


def test_unrolled_matmul_flops():
    d = 256
    a, b = torch.randn(d, d), torch.randn(d, d)
    _, mode = CA.analyze(lambda: a @ b)
    assert abs(mode.costs.flops - 2 * d ** 3) / (2 * d ** 3) < 0.01
    # reads both operands, writes the result
    assert mode.costs.hbm_bytes == 3 * d * d * 4


def test_loop_forward_and_backward_flops():
    """Fwd+bwd of a 10-step loop of DxD matmuls: 2D^3 * 10 * 2 (forward
    product + dL/dx product; the weights are not differentiated). Each
    iteration is counted as it runs: no trip-count roll-up."""
    d = 128
    x, ws = torch.randn(d, d), torch.randn(10, d, d)

    def step():
        xx = x.clone().requires_grad_(True)
        y = xx
        for w in ws.unbind(0):
            y = torch.tanh(y @ w)
        y.sum().backward()

    _, mode = CA.analyze(step)
    analytic = 2 * d ** 3 * 10 * 2
    assert abs(mode.costs.flops - analytic) / analytic < 0.05


@pytest.fixture(scope="module")
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_process_group

    init_fake_process_group(2)
    yield
    dist.destroy_process_group()


def test_all_reduce_bytes_counted(fake_group):
    """An all_reduce of f32 (128, 256) on a fake group: its result bytes,
    once."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed as dist

    t = torch.randn(128, 256)
    _, mode = CA.analyze(lambda: funcol.wait_tensor(
        funcol.all_reduce(t, "sum", dist.group.WORLD)))
    assert mode.costs.collective_bytes["all-reduce"] == 128 * 256 * 4
    assert mode.costs.collective_counts["all-reduce"] == 1
    assert mode.costs.total_collective_bytes == 128 * 256 * 4


def test_costs_accumulate():
    a, b = CA.Costs(flops=1.0), CA.Costs(flops=2.0)
    b.collective_bytes["all-to-all"] = 5.0
    a.add(b, mult=3.0)
    assert a.flops == 7.0
    assert a.collective_bytes["all-to-all"] == 15.0
    assert a.total_collective_bytes == 15.0


def test_recorded_ops_give_the_same_totals():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4)

    def step():
        y = torch.relu(x @ w)
        y.sum().backward()
        buf = torch.zeros(8, 4)
        buf[:, 1] = y[:, 0].detach()

    with CA.CostMode(record=True) as mode:
        step()
    again = CA.costs_from_ops(mode.ops)
    assert again.flops == mode.costs.flops and again.hbm_bytes == mode.costs.hbm_bytes
    # the copy into a column counts its update twice (read, write), as
    # dynamic-update-slice does
    copy = [r for r in mode.ops if r[1] == "copy"]
    assert copy and CA.costs_from_ops(copy).hbm_bytes == 2 * 8 * 4


# --------------------------------------------------------------------------
# one reduced LM step against the reference's compiled HLO
# --------------------------------------------------------------------------


def _ref_flops(arch: str, mode: str) -> float:
    cfg = REF_ARCHS[arch].reduced()
    params = jax.eval_shape(lambda k: REF_MDL.init(cfg, k), jax.random.PRNGKey(0))
    if mode == "train":
        reps = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct((R,) + tuple(s.shape), s.dtype), params)
        batch = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct((R,) + tuple(s.shape), s.dtype),
            REF_SP.train_specs(cfg, B, S))
        vec = jax.ShapeDtypeStruct((R,), jnp.float32)
        lowered = jax.jit(REF_STEPS.make_train_round(cfg)).lower(reps, batch, vec, vec)
    elif mode == "prefill":
        lowered = jax.jit(REF_STEPS.make_prefill_step(cfg)).lower(
            params, REF_SP.prefill_specs(cfg, B, S))
    else:
        ins = REF_SP.decode_specs(cfg, B, S)
        lowered = jax.jit(REF_STEPS.make_decode_step(cfg)).lower(
            params, ins["cache"], ins["tokens"])
    return ref_analyze(lowered.compile().as_text()).flops


def _port_flops(arch: str, mode: str, mesh=None) -> float:
    cfg = ARCHS[arch].reduced()
    g = torch.Generator().manual_seed(0)
    params = MDL.init(cfg, g)
    if mode == "train":
        flat = {k: v[None].repeat((R,) + (1,) * v.ndim) for k, v in tu.flatten(params).items()}
        toks = torch.randint(0, cfg.vocab_size, (R, B, S + 1), generator=g, dtype=torch.int32)
        batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
                 "sample_mask": torch.ones(R, B, dtype=torch.bool)}
        vec = torch.full((R,), 0.1)
        if mesh is None:
            fn, args = ST.make_train_round(cfg), (flat, batch, vec, torch.ones(R))
        else:
            from repro_torch.sharding.rules import MeshAxes, param_specs, train_batch_specs

            ax = MeshAxes(cfg, mesh)
            reps = ST.layout_replicas(flat, param_specs(cfg, flat, mesh, with_replica_dim=True),
                                      mesh, ax)
            bt = ST.layout_replicas(batch, train_batch_specs(cfg, batch, mesh), mesh, ax)
            _, n = ST.replica_coordinate(mesh, ax)
            fn = ST.make_partitioned_train_round(cfg, mesh)
            args = (reps, bt, vec[: R // n], torch.ones(R // n))
    elif mode == "prefill":
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
        fn, args = ST.make_prefill_step(cfg), (params, {"tokens": toks})
    else:
        toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, dtype=torch.int32)
        cache = MDL.init_cache(cfg, B, S, device="cpu")
        cache["cur_len"] = S - 1
        fn, args = ST.make_decode_step(cfg), (params, cache, toks)
    _, cm = CA.analyze(fn, *args)
    return cm.costs.flops


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m", "moonshot-v1-16b-a3b"])
def test_step_flops_match_reference_hlo(arch, mode):
    ref, got = _ref_flops(arch, mode), _port_flops(arch, mode)
    assert ref > 0
    assert abs(got - ref) / ref < 0.02, (got, ref)


def test_tensor_parallel_halves_per_device_flops(fake_group):
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(1, 2, device_type="cpu")
    one = _port_flops("llama3.2-1b", "train")
    two = _port_flops("llama3.2-1b", "train", mesh=mesh)
    # the data axis has one rank, so each rank holds all R replicas
    assert abs(two / one - 0.5) < 0.05 * 0.5, (two, one)
