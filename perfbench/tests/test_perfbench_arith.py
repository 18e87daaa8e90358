"""The yardstick's arithmetic against values worked out by hand at tiny
widths: the bounds of each kernel, the model FLOPs, and the readers of the
metrics that use them."""
import numpy as np
import pytest
import torch

from perfbench import roofline, spec, trace
from perfbench.harness import Run

PEAK = 67e12
BW = 3.35e12


def test_spmm_counts_the_rows_its_data_names():
    # 2 x 3 slots, H = 4, f32: 6 x 9 B of idx/val/mask, 3 distinct rows x 16 B,
    # a (2, 4) output of 32 B; 2 x 4 x 5 live slots
    assert roofline.spmm(6, 2, 5, 3, 4, 4) == (6 * 9 + 3 * 16 + 2 * 16, 40)


def test_weighted_merge_bytes():
    # R = 4, N = 10, f32: 5 x 40 B + 16 B of weights, + 80 B of g and gp
    assert roofline.weighted_merge(4, 10, 4, True) == (296, 2 * 4 * 10 + 30)
    assert roofline.weighted_merge(4, 10, 4, False) == (216, 80)


def test_head_gemms_and_model_flops():
    # 2 replicas of W2 (H = 3, NC = 5), 8 rows: W2 120 B, logits 160 B, h 96 B
    fwd, dh, dw2 = roofline.head_gemms(2, 8, 3, 5, train=True)
    assert fwd == dh == dw2 == (96 + 120 + 160, 2 * 8 * 3 * 5)
    assert roofline.head_gemms(1, 8, 3, 5, train=False) == [(96 + 60 + 160, 240)]
    assert roofline.model_flops(2, 10, 3, 5) == 4 * 10 * 3 + 2 * 6 * 3 * 5
    assert roofline.bound_s(BW, 0.0, PEAK) == 1.0 and roofline.bound_s(0.0, PEAK, PEAK) == 1.0


def _run(**kw):
    config = dict(hidden=3, n_classes=5, peak_flops=PEAK)
    return Run(config=config, devices=(torch.device("cuda", 0),), **kw)


def _profile(ops, launches=None, spans=(), start=0.0, end=10.0):
    return trace.Profile(start_us=start, end_us=end,
                         devices=(torch.device("cuda", 0),), ops=list(ops), spans=list(spans),
                         launches=launches or {"spmm": [], "weighted_merge": []})


def test_end_to_end_readers():
    run = _run(samples=300, window_s=2.0, completions=[0.5, 1.0, 1.5, 2.0], setup_s=7.0,
               peak_bytes=3 * 2**30)
    assert spec.reader("train_samples_per_s")(run) == 150.0
    assert spec.reader("megabatch_p90_s")(run) == pytest.approx(0.5)
    assert spec.reader("peak_mem_gib")(run) == 3.0
    assert spec.reader("setup_s")(run) == 7.0


def test_mfu_and_host_readers():
    run = _run(model_flops=0.5 * PEAK, window_s=2.0,
               staging=[dict(plan_s=0.001, pack_s=0.002, upload_s=0.003)] * 2,
               merge_s=[0.004, 0.006],
               shard_windows=[np.array([1.0, 0.5]), np.array([2.0, 2.0])])
    assert spec.reader("mfu")(run) == pytest.approx(25.0)
    assert spec.reader("host_stage_ms")(run) == pytest.approx(6.0)
    assert spec.reader("merge_ms")(run) == pytest.approx(5.0)
    assert spec.reader("shard_imbalance_pct")(run) == pytest.approx(25.0)


def test_kernel_rooflines_from_a_profile():
    # one training round's spmm over R = 2 replicas of (B, K) = (2, 3), and
    # one evaluation batch (2, 3); W1 (NF = 10, H = 3) f32
    idx = torch.tensor([[[0, 1, 1], [2, 0, 9]], [[0, 0, 0], [5, 6, 7]]], dtype=torch.int32)
    mask = torch.tensor([[[1, 1, 1], [1, 0, 0]], [[1, 1, 0], [1, 1, 1]]], dtype=torch.bool)
    spmm = [(idx, mask, (2, 10, 3), 4), (idx[0], mask[0], (10, 3), 4)]
    merge = [(2, 100, 4, True)]
    gemm_s, spmm_s, merge_s = 3e-6, 2e-6, 1e-6
    ops = [("sm90_xmma_gemm_f32f32_tn", 0, 0.0, gemm_s * 1e6),
           ("spmm_rows_kernel", 0, 4.0, 4.0 + spmm_s * 1e6),
           ("void merge_kernel<float>", 0, 7.0, 7.0 + merge_s * 1e6)]
    run = _run(profile=_profile(ops, {"spmm": spmm, "weighted_merge": merge}))
    head = sum(roofline.bound_s(b, f, PEAK)
               for b, f in roofline.head_gemms(2, 4, 3, 5, True)
               + roofline.head_gemms(1, 2, 3, 5, False))
    assert spec.reader("roofline_pct.xml_head")(run) == pytest.approx(100 * head / gemm_s)
    # round: replica 0 names rows {0, 1, 2}, replica 1 rows {0, 5, 6, 7}: 7
    # distinct, 9 live slots; evaluation: rows {0, 1, 2}, 4 live slots
    spmm_bound = (roofline.bound_s(*roofline.spmm(12, 4, 9, 7, 3, 4), PEAK)
                  + roofline.bound_s(*roofline.spmm(6, 2, 4, 3, 3, 4), PEAK))
    assert spec.reader("roofline_pct.spmm")(run) == pytest.approx(100 * spmm_bound / spmm_s)
    merge_bound = roofline.bound_s(*roofline.weighted_merge(2, 100, 4, True), PEAK)
    assert spec.reader("roofline_pct.weighted_merge")(run) \
        == pytest.approx(100 * merge_bound / merge_s)
    # busy 3 + 2 + 1 us of the 10 us stretch
    assert spec.reader("device_idle_pct")(run) == pytest.approx(40.0)


def test_readers_find_nothing_without_a_profile_or_kernels():
    run = _run()
    for name in ("roofline_pct.xml_head", "roofline_pct.spmm", "roofline_pct.weighted_merge",
                 "device_idle_pct", "merge_ms", "host_stage_ms", "shard_imbalance_pct"):
        assert spec.reader(name)(run) is None
    run.profile = _profile([])
    assert spec.reader("roofline_pct.xml_head")(run) is None


def test_idle_gaps_go_to_the_open_span():
    p = _profile([("k", 0, 1.0, 3.0), ("k", 0, 2.0, 4.0), ("k", 0, 6.0, 7.0)],
                 spans=[("stage", 0.0, 5.0), ("merge", 4.5, 5.5)])
    assert trace.union_us([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)])[0] == 4.0
    gaps = dict(trace.idle_gaps(p))
    # idle: [0, 1) stage, [4, 4.5) stage, [4.5, 5.5) merge, [5.5, 6) and [7, 10) host
    assert gaps == pytest.approx({"stage": 1.5e-6, "merge": 1e-6, "host": 3.5e-6})
    assert trace.device_ops(p) == [["k", pytest.approx(5e-6)]]


def test_a_span_the_program_opens_is_no_device_work():
    """A ``record_function`` range under a name the benchmark does not know,
    and its copy on the device's timeline (a GPU user annotation, with or
    without the event saying so), leave the busy time as it was."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def profiled(foreign: bool):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                with torch.profiler.record_function("stage"):
                    if foreign:
                        with torch.profiler.record_function("program_step"):
                            torch.ones(8).sum()
                    else:
                        torch.ones(8).sum()
        return list(prof.events())

    def on_card(name, t0, t1, **kind):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA, device_index=0,
                               time_range=SimpleNamespace(start=t0, end=t1), **kind)

    kernels = [on_card("gemm", 10.0, 13.0), on_card("gemm", 20.0, 22.0)]
    base = trace.reduce(profiled(False) + kernels, (torch.device("cuda", 0),), {})
    events = profiled(True) + kernels + [
        on_card("program_step", 0.0, 40.0, is_user_annotation=True),
        on_card("program_step", 0.0, 40.0),
        on_card(trace.WINDOW_SPAN, 0.0, 50.0)]
    got = trace.reduce(events, (torch.device("cuda", 0),), {})
    assert trace.device_busy_s(got, 0) == trace.device_busy_s(base, 0) == pytest.approx(5e-6)
    assert [n for n, _, _, _ in got.ops] == ["gemm", "gemm"]
    assert [n for n, _, _ in got.spans] == ["stage"] and got.end_us > got.start_us
