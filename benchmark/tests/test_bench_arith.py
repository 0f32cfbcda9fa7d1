"""The yardstick's arithmetic on known inputs: conv_bound, the operation
counter against FlopCounterMode, the busy union and idle gaps, the
percentile, the spread, the sample and the comparison."""

import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.lib import check, roofline, stats, trace, tryon
from benchmark.lib.flops import OpCounter


def test_conv_bound_at_the_serving_shapes():
    # PERF.md's K1 fp32 table: [8,514,514,128] -> 64 is bound at 4.6155 ms
    # by operations; [8,514,514,64] -> 64 at 2.3077 ms
    t, by, flop = roofline.conv_bound(8, 512, 512, 128, 64, torch.float32,
                                      8 * 514 * 514 * 128, 8 * 512 * 512 * 64)
    assert by == "operations" and flop == 2 * 8 * 512 * 512 * 9 * 128 * 64
    assert t * 1e3 == pytest.approx(4.6155, abs=1e-4)
    t, _, _ = roofline.conv_bound(8, 512, 512, 64, 64, torch.float32,
                                  8 * 514 * 514 * 64, 8 * 512 * 512 * 64)
    assert t * 1e3 == pytest.approx(2.3077, abs=1e-4)
    # bf16 [8,514,514,64] -> 64 is bound by bytes at 0.1609 ms
    t, by, _ = roofline.conv_bound(8, 512, 512, 64, 64, torch.bfloat16,
                                   8 * 514 * 514 * 64, 8 * 512 * 512 * 64)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.1609, abs=1e-4)


def test_k1_scope_of_recorded_convs():
    x = torch.randn(2, 64, 10, 12)
    with OpCounter() as ops:
        F.conv2d(x, torch.randn(128, 64, 3, 3))             # K1
        F.conv2d(x, torch.randn(128, 64, 3, 3), padding=1)  # padded: not
        F.conv2d(x, torch.randn(256, 64, 3, 3))             # C_out > 128
        F.conv2d(x, torch.randn(64, 64, 1, 1))              # 1x1
        F.conv2d(x, torch.randn(64, 1, 3, 3), groups=64)    # depthwise
    k1 = [c for c in ops.convs if roofline.is_k1_conv(c)]
    assert len(ops.convs) == 5 and len(k1) == 1
    t, _, flop = roofline.k1_bound(k1[0])
    assert flop == 2 * 2 * 8 * 10 * 9 * 64 * 128
    assert t == pytest.approx(flop / 67e12)


def test_op_counter_agrees_with_flop_counter_mode():
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(16, 8, 3, stride=2),
        torch.nn.Flatten(), torch.nn.Linear(8 * 7 * 7, 10))
    x = torch.randn(4, 3, 16, 16, requires_grad=True)
    with FlopCounterMode(display=False) as ref:
        model(x).sum().backward()
    with OpCounter() as ops:
        y = model(x)
        w = torch.randn(3, 5)
        torch.bmm(torch.randn(2, 3, 4), torch.randn(2, 4, 6))
        y.sum().backward()
    extra = 2 * 2 * 3 * 4 * 6
    assert sum(ops.flops.values()) == ref.get_total_flops() + extra
    assert set(ops.flops) == {torch.float32}
    assert ops.peak_seconds(roofline.PEAK_FLOPS) == pytest.approx(
        (ref.get_total_flops() + extra) / 67e12)
    del w


def test_grouped_conv_backward_counts_each_group_once():
    # FlopCounterMode counts a grouped conv's weight gradient over every
    # input channel (groups times too much); the counter counts the
    # forward's operations once for each gradient asked for
    x = torch.randn(2, 16, 9, 9, requires_grad=True)
    w = torch.randn(8, 4, 3, 3, requires_grad=True)
    with OpCounter() as ops:
        y = F.conv2d(x, w, groups=4)
    fwd = ops.flops[torch.float32]
    assert fwd == 2 * 2 * 7 * 7 * 8 * 4 * 9
    with OpCounter() as ops:
        y.sum().backward()
    assert ops.flops[torch.float32] == 2 * fwd


def test_busy_union_and_idle_gaps():
    assert trace.busy_us([(0, 10), (5, 15), (20, 25), (24, 30), (40, 41)]) \
        == 15 + 10 + 1
    assert trace.busy_us([]) == 0
    span = trace.Span()
    span.kernels = [(trace.MARK_KERNEL, 0, 1), ("a", 1, 10), ("b", 5, 12),
                    (trace.MARK_KERNEL, 40, 41), ("a", 41, 50),
                    ("c", 70, 80), (trace.MARK_KERNEL, 100, 101)]
    span.labels = [("run_batch", 10, 45), ("stream_next", 0, 100),
                   ("fetch", 50, 65)]
    span._lo, span._hi = 0, 100
    assert span.segments() == [[("a", 1, 10), ("b", 5, 12)],
                               [("a", 41, 50), ("c", 70, 80)]]
    # a request's own span: mark to its last operation, the wait after out
    assert span.segment_spans() == [(12e-6, 11e-6), (40e-6, 19e-6)]
    run = harness.Run()
    run.trace = span
    assert harness.reader("idle_share.single")(run) == pytest.approx(
        1 - 30 / 52)
    gaps = span.idle_gaps()
    # 12 -> 40 (middle 26: run_batch), 50 -> 70 (60: fetch), 80 -> 100
    # (90: stream_next), 1 -> 1 and 41 -> 41 are no gaps
    assert gaps[:3] == [["run_batch", 28e-6], ["fetch", 20e-6],
                        ["stream_next", 20e-6]]
    ops = dict(span.device_ops())
    assert ops == {"a": 18e-6, "c": 10e-6, "b": 7e-6}


def test_span_reads_the_profilers_events():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, start, end, device=cuda):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    span = trace.Span()
    span.read([event("k", 0, 5), event(mark, 10, 10), event("k", 11, 20),
               event("k", 30, 40), event(mark, 50, 51), event("k", 52, 80),
               event("aten::add", 0, 90, cpu), event("bench.run_batch", 9, 60,
                                                     cpu),
               event("bench.run_batch", 11, 80)])   # the label on the device
    assert span.window_s == pytest.approx(40e-6)
    assert span.busy_s == pytest.approx(19e-6)
    assert span.labels == [("run_batch", 9, 60)]
    assert span.segments() == [[("k", 11, 20), ("k", 30, 40)]]
    with pytest.raises(RuntimeError, match="1 marks"):
        trace.Span().read([event(mark, 0, 1), event("k", 2, 3)])


def test_percentile_and_spread():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 90) == 90
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 90) == 5
    # statistics.quantiles' exclusive method: 1.5 and 4.5 of 1..5
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_window_rate_is_all_work_over_all_time():
    run = harness.Run()
    run.items, run.window_s = 712, 40.25
    run.ops, run.ops_items = OpCounter(), 8
    run.ops.flops[torch.float32] = 8 * 67e12 * 0.01
    from benchmark.harness import reader

    # 0.01 s of peak work an image, 712 images in 40.25 s
    assert reader("mfu.serve")(run) == pytest.approx(
        100 * 0.01 * 712 / 40.25)
    run.spans["prepare_pair"] = [0.040, 0.050, 0.045]
    run.spans["run_batch"] = [0.2, 0.3, 0.25, 0.35]
    assert reader("single.prep_ms")(run) == pytest.approx(45.0)
    assert reader("single.dispatch_ms")(run) == pytest.approx(275.0)
    assert reader("idle_share.serve")(run) is None
    assert reader("k1_roofline.serve")(run) is None


def test_k1_roofline_over_whole_batches():
    run = harness.Run()
    x = torch.randn(1, 64, 10, 10)
    with OpCounter() as run.ops:
        F.conv2d(x, torch.randn(64, 64, 3, 3))
        F.conv2d(x, torch.randn(128, 64, 3, 3))
    bound = sum(roofline.k1_bound(c)[0]
                for c in run.ops.convs) * 1e6          # us
    span = trace.Span()
    k = "void conv3x3_f32_kernel<64, 64>(float const*)"
    span.kernels = [(trace.MARK_KERNEL, 0, 1), (k, 1, 1 + 2 * bound / 2),
                    (k, 100, 100 + 2 * bound / 2),
                    (trace.MARK_KERNEL, 400, 401), (k, 401, 402),
                    (trace.MARK_KERNEL, 500, 501)]
    span._lo, span._hi = 0, 500
    run.trace = span
    # the first batch took twice its bound; the second holds one launch
    # of two and is left out
    assert harness.reader("k1_roofline.serve")(run) == pytest.approx(50.0)


def test_reservoir_is_seeded_and_uniform():
    def kept(seed):
        r = tryon.Reservoir(4, seed)
        for i in range(100):
            r.offer(i, np.full(2, i))
        return sorted(p for p, _ in r.kept)

    assert kept(7) == kept(7) and kept(7) != kept(8)
    hits = np.zeros(100)
    for seed in range(400):
        hits[kept(seed)] += 1
    assert hits.min() > 0 and hits.max() < 45     # ~16 each


def test_image_gaps_and_judge():
    ref = torch.linspace(-100, 100, 1000)
    got = ref.clone()
    assert check.image_gaps(got, ref) == (0.0, 0.0)
    got[:10] += 3.0                 # 1.5% of the range, on 1% of values
    share, gap = check.image_gaps(got, ref)
    assert share == pytest.approx(0.01) and gap == pytest.approx(
        30 / 1000 / 200)
    got[0] = math.nan
    assert check.image_gaps(got, ref) == (1.0, 1.0)
    ok, table = check.judge({"share_off": 1e-5, "mean_gap": 2e-6},
                            {"share_off": 1e-4, "mean_gap": 1e-6})
    assert not ok and list(table) == ["share_off", "mean_gap"]
    assert table["mean_gap"] == {"value": 2e-6, "limit": 1e-6}
    ok, _ = check.judge({}, {"share_off": 1.0})
    assert not ok


def test_forbidden_modules_are_named_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pasta_tpu_torch_fake.x", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    monkeypatch.setitem(sys.modules, "pasta_tpu.ops", sys)
    assert harness.loaded_forbidden() == ["jaxlib", "pasta_tpu"]
