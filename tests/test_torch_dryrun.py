"""The dry run (``repro_torch.launch.dryrun``): its analytic terms equal
the reference's exactly for every registered arch; every reduced arch
traces in every mode (shapes shrunk) over a (2, 2) fake mesh into a record
with the reference's keys and finite terms; and the cut-and-extrapolated
terms equal a full trace's."""
from __future__ import annotations

import dataclasses
import math
import os

import pytest

from repro.configs.archs import ARCHS as REF_ARCHS
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun as DR

#: the four input shapes, cut to a reduced model's size
SHRUNK = {
    "train_4k": dict(seq_len=64, global_batch=4),
    "prefill_32k": dict(seq_len=64, global_batch=4),
    "decode_32k": dict(seq_len=64, global_batch=4),
    "long_500k": dict(seq_len=128, global_batch=1),
}
STEP_KEYS = {"flops", "hbm_bytes", "collectives", "memory", "trace_s", "n_devices", "fits_hbm"}
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "steps", "model_flops_per_token",
               "total_params", "tokens_per_step", "mode"}


def _reference_dryrun():
    """The reference's dry-run module, without the ``XLA_FLAGS`` it sets as
    it is imported (512 host devices): left set, every later JAX test in
    this process would see 512 devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_terms_equal_the_reference(arch):
    ref = _reference_dryrun()
    assert DR.model_flops_per_token(ARCHS[arch]) == ref.model_flops_per_token(REF_ARCHS[arch])
    assert DR.total_params(ARCHS[arch]) == ref.total_params(REF_ARCHS[arch])


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_process_group, make_debug_mesh

    init_fake_process_group(4)
    yield make_debug_mesh(2, 2, device_type="cpu")
    dist.destroy_process_group()


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, (int, float)) or math.isfinite(x)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_reduced_arch_traces_in_every_mode(mesh, arch):
    cfg = ARCHS[arch].reduced()
    for name, cut in SHRUNK.items():
        shape = dataclasses.replace(INPUT_SHAPES[name], **cut)
        rec = DR.combo_record(arch, cfg, name, shape, mesh, "debug")
        assert set(rec) == RECORD_KEYS
        assert rec["mesh_shape"] == {"data": 2, "model": 2}
        want = {"train": {"train", "merge"}, "prefill": {"prefill"},
                "decode": {"decode"}}[shape.mode]
        assert set(rec["steps"]) == want, name
        for step, st in rec["steps"].items():
            assert STEP_KEYS <= set(st), (name, step)
            assert _finite(st), (name, step)
            assert st["n_devices"] == 4
            assert set(st["collectives"]["bytes"]) == set(DR.CA.COLLECTIVES)
            assert st["hbm_bytes"] > 0 and st["memory"]["argument_size_in_bytes"] > 0
            if step != "merge":
                assert st["flops"] > 0, (name, step)


@pytest.mark.parametrize("arch,mode", [("mamba2-780m", "prefill"),
                                       ("llama3.2-1b", "train")])
def test_cut_and_extrapolated_terms_equal_a_full_trace(mesh, arch, mode):
    """Three groups and six attention chunks, traced whole and as the cut
    programs (one and two groups, two to five chunks): FLOPs, bytes and
    collectives agree to rounding."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), n_layers=3)
    base = INPUT_SHAPES["train_4k" if mode == "train" else "prefill_32k"]
    shape = dataclasses.replace(base, seq_len=6 * DR.SEQ_CHUNK, global_batch=2)
    step = mode
    plan, target = DR.trace_plan(cfg, shape, step)
    assert target == (3, 3072) and len(plan) == 8
    cut = DR.analyze_step(cfg, shape, mesh, step)
    full = DR.analyze_step(cfg, shape, mesh, step, full=True)
    assert full["traced"] == [[3, 3072]]
    for key in ("flops", "hbm_bytes"):
        assert cut[key] == pytest.approx(full[key], rel=1e-9), key
    for kind in ("bytes", "counts"):
        for c, v in full["collectives"][kind].items():
            assert cut["collectives"][kind][c] == pytest.approx(v, rel=1e-9, abs=1e-6), (kind, c)
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert cut["memory"][k] == full["memory"][k]


def test_cut_lengths_keep_a_fractional_moe_capacity_whole():
    """kimi-k2 holds 1,280 / 3 expert slots a 512-token chunk of its
    prefill_32k batch (32 x 512 tokens x top-8 x 1.25 / 384 experts): its
    cuts step by three chunks, so each cut's capacity is a whole number and
    grows in proportion; the other archs' capacities are whole already."""
    shape = INPUT_SHAPES["prefill_32k"]
    kimi = DR.trace_plan(ARCHS["kimi-k2-1t-a32b"], shape, "prefill", tokens_a_chunk=32 * 512)
    assert sorted({s for _, s in kimi[0]}) == [1536, 3072, 4608, 6144]
    for arch in ("moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "llama3.2-1b"):
        plan, _ = DR.trace_plan(ARCHS[arch], shape, "prefill", tokens_a_chunk=32 * 512)
        assert sorted({s for _, s in plan}) == [1024, 1536, 2048, 2560], arch
    # where the cuts would pass the target, the whole length is traced
    plan, _ = DR.trace_plan(ARCHS["kimi-k2-1t-a32b"], INPUT_SHAPES["train_4k"], "train",
                            tokens_a_chunk=256 * 512)
    assert {s for _, s in plan} == {4096}
