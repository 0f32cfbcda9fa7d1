"""The readers of the port's own spans (`lib/program.py` and the five
metrics on it) on hand-built timelines: the anchor onto the trace's
clock, the idle arithmetic of both `dispatch_idle_ms` readers and their
split note, every reader's None where the port has no `tracing` module,
and `lib/trace.py` taking no `pasta.*` range for a kernel."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.lib import program, trace

NEW = ["single.decode_ms", "single.dispatch_idle_ms", "serve.prep_wait_ms",
       "serve.fetch_wait_ms", "serve.dispatch_idle_ms"]
OFFSET_US = 5_000_000.0      # the port's clock (us) minus the trace's
MAIN, POOL = 1, 2


class Timeline:
    """Port spans written on the trace's clock (us) and stored on the
    port's (ns, shifted by OFFSET_US)."""

    def __init__(self):
        self.spans, self.labels = [], []

    def span(self, name, start, end, thread=MAIN, **attrs):
        self.spans.append(SimpleNamespace(
            name=name, start=int((start + OFFSET_US) * 1e3),
            end=int((end + OFFSET_US) * 1e3), thread=thread, attrs=attrs,
            id=len(self.spans) + 1, parent=None))

    def run(self, kernels):
        span = trace.Span()
        span.kernels, span.labels = sorted(kernels, key=lambda k: k[1]), \
            self.labels
        out = harness.Run()
        out.trace = span
        return out


def _mark(t):
    return (trace.MARK_KERNEL, t, t + 1)


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers a timeline's spans as the port's snapshot."""
    def use(timeline):
        monkeypatch.setattr(program, "spans", lambda run: timeline.spans)
    return use


def test_anchor_bounds_the_offset():
    """Each span lies inside its label: its start bounds the offset from
    above, its end from below; the offset is the middle of the tightest
    bounds, whatever one pair's wait between label and span."""
    tl = Timeline()
    for k, (late, early) in enumerate(((3.0, 2.0), (5.0, 6.0), (4.0, 1.0),
                                       (900.0, 30.0))):
        start = 1000.0 * k
        tl.labels.append(("run_batch", start, start + 500))
        tl.labels.append(("prepare_pair", start - 300, start - 10))
        tl.span("run_batch", start + late, start + 500 - early)
    offset, how = program.anchor(tl.labels, tl.spans)
    # at most OFFSET_US + 3, at least OFFSET_US - 1
    assert offset == pytest.approx(OFFSET_US + 1.0, abs=1e-3)
    assert how.startswith("offset bounds 4.0 us apart over 4 run_batch")
    assert "start differences spread 897.0 us" in how
    # one label more than spans: no pairing
    offset, how = program.anchor(
        tl.labels + [("run_batch", 9000, 9100)], tl.spans)
    assert offset is None and how == "5 run_batch labels, 4 run_batch spans"
    # a span that starts before its label: the bounds contradict
    tl.span("run_batch", 4000.0 - 50.0, 4400.0)
    assert program.anchor(tl.labels + [("run_batch", 4000, 4500)],
                          tl.spans)[0] is None
    # every pair 150 us late and early: the bounds 300 us apart
    wide = Timeline()
    for k in range(3):
        wide.labels.append(("run_batch", 1000.0 * k, 1000.0 * k + 500))
        wide.span("run_batch", 1000.0 * k + 150, 1000.0 * k + 350)
    assert program.anchor(wide.labels, wide.spans)[0] is None
    assert program.anchor([], [])[0] is None


def _single_timeline():
    """Two requests: a mark, prepare_pair (decode, host_prepare), then
    run_batch whose four stages queue kernels with idle stretches."""
    tl, kernels = Timeline(), []
    for k, t in enumerate((0.0, 1000.0)):
        kernels.append(_mark(t))
        tl.labels.append(("prepare_pair", t + 10, t + 100))
        tl.span("prepare_pair", t + 12, t + 98)
        tl.span("decode", t + 15, t + 60 + 10 * k)
        tl.span("host_prepare", t + 61 + 10 * k, t + 95)
        tl.labels.append(("run_batch", t + 102, t + 398))   # its span's
        tl.span("run_batch", t + 102, t + 398)
        tl.span("upload", t + 105, t + 120)
        tl.span("ingest", t + 120, t + 150)
        tl.span("assemble", t + 150, t + 200)
        tl.span("generator", t + 200, t + 395)
        # busy 130-140 and 160-300; idle 102-130 (upload 105-120 = 15,
        # ingest 120-130 = 10, run_batch itself 102-105 = 3), 140-150
        # (ingest 10), 150-160 (assemble 10), 300-395 (generator 95) and
        # 395-398 (run_batch 3): 146 us in run_batch
        kernels += [("k", t + 130, t + 140), ("k", t + 160, t + 300)]
    kernels.append(_mark(2000.0))
    return tl, kernels


def test_single_dispatch_idle_and_split(recorded):
    tl, kernels = _single_timeline()
    recorded(tl)
    run = tl.run(kernels)
    assert harness.reader("single.dispatch_idle_ms")(run) == pytest.approx(
        0.146, abs=1e-6)
    note, = run.notes
    assert ("inside run_batch: upload 0.015; replay 0.000; ingest 0.020; "
            "assemble 0.010; generator 0.095; run_batch 0.006") in note
    assert "over 2 batches" in note
    # outside run_batch, a request: 1-12, 98-102 and 398-1000 (or 1001-1012,
    # 1098-1102, 1398-2000) with no span open (617 us), prepare_pair
    # 12-15, 60-61 (70-71), 95-98 (7), decode 45 (55), host_prepare 34 (24)
    assert "decode 0.050" in note and "host_prepare 0.029" in note
    assert "prepare_pair 0.007" in note
    assert "none 0.617" in note
    assert "offset bounds 0.0 us apart over 2 run_batch spans" in note
    assert ("host ms a batch in the window: prepare_pair 0.086; decode "
            "0.050;") in note
    assert harness.reader("single.decode_ms")(run) == pytest.approx(0.05)


def test_a_replays_idle_is_inside_run_batch(recorded):
    """A replayed batch's run_batch holds `upload` and `replay`: the idle
    in `replay` is the dispatch's, not the window's outside run_batch."""
    tl, kernels = Timeline(), [_mark(0.0)]
    tl.labels.append(("run_batch", 100.0, 400.0))
    tl.span("run_batch", 100.0, 400.0, graph="replay")
    tl.span("upload", 105.0, 120.0)
    tl.span("replay", 120.0, 395.0)
    # busy 130-300: idle 100-130 (run_batch 5, upload 15, replay 10) and
    # 300-400 (replay 95, run_batch 5); outside, 1-100 and 400-1000
    kernels += [("k", 130.0, 300.0), _mark(1000.0)]
    recorded(tl)
    run = tl.run(kernels)
    assert harness.reader("single.dispatch_idle_ms")(run) == pytest.approx(
        0.130)
    note, = run.notes
    assert ("inside run_batch: upload 0.015; replay 0.105; ingest 0.000; "
            "assemble 0.000; generator 0.000; run_batch 0.010") in note
    assert "outside run_batch: none 0.699 |" in note     # the marks: 1 us


def _stream_timeline():
    """Three batches: the first queued before the first mark on the device
    (left out), the device running the previous batch while the host
    queues the next one, one idle stretch inside each later run_batch."""
    tl, kernels = Timeline(), []
    for k in range(3):
        t = 1000.0 * k
        tl.span("prep_wait", t + 0, t + 20, batch=k)
        tl.labels.append(("run_batch", t + 21, t + 299))
        tl.span("run_batch", t + 21, t + 299, batch=k)
        tl.span("upload", t + 25, t + 100, batch=k)
        tl.span("generator", t + 100, t + 290, batch=k)
        tl.span("fetch", t + 300, t + 310, batch=k)
        tl.span("fetch_wait", t + 310, t + 990, batch=k)
        tl.span("prepare_pair", t + 400, t + 900, thread=POOL, batch=k + 1)
        # the device: the mark of batch k on the device 700 us after its
        # host start, busy until the next mark but for 10 us (k + 1) in
        # the upload and 5 us in the generator of the next batch
        kernels.append(_mark(t + 700))
    kernels.append(_mark(3700.0))
    busy = [(700.0, 1050.0), (1060.0, 1200.0), (1205.0, 2050.0),
            (2070.0, 2200.0), (2205.0, 3700.0)]
    kernels += [("k", s, e) for s, e in busy]
    return tl, kernels


def test_stream_dispatch_idle_and_split(recorded):
    tl, kernels = _stream_timeline()
    recorded(tl)
    run = tl.run(kernels)
    # batch 0's run_batch (21-299) lies before the first mark (700): out;
    # batches 1 and 2 idle 10 + 5 and 20 + 5 us
    assert harness.reader("serve.dispatch_idle_ms")(run) == pytest.approx(
        0.020)
    note, = run.notes
    assert "over 2 batches" in note
    assert ("inside run_batch: upload 0.015; replay 0.000; ingest 0.000; "
            "assemble 0.000; generator 0.005; run_batch 0.000") in note
    assert "outside run_batch: 0 |" in note
    assert "fetch 0.010; fetch_wait 0.680" in note
    assert harness.reader("serve.prep_wait_ms")(run) == pytest.approx(0.020)
    assert harness.reader("serve.fetch_wait_ms")(run) == pytest.approx(0.68)


def test_unmapped_spans_give_none(recorded):
    tl, kernels = _single_timeline()
    tl.labels.append(("run_batch", 5000.0, 5100.0))    # a call not recorded
    recorded(tl)
    run = tl.run(kernels)
    assert harness.reader("single.dispatch_idle_ms")(run) is None
    assert run.notes == ["dispatch idle: no mapping onto the trace: 3 "
                         "run_batch labels, 2 run_batch spans"]
    # the span readers need no mapping
    assert harness.reader("single.decode_ms")(run) == pytest.approx(0.05)


def test_every_new_reader_is_none_without_the_ports_tracing(monkeypatch):
    """What the parent commit gives: no `pasta_tpu_torch.tracing`."""
    monkeypatch.setitem(sys.modules, "pasta_tpu_torch.tracing", None)
    assert program.spans(harness.Run()) is None
    tl, kernels = _single_timeline()
    run = tl.run(kernels)
    for name in NEW:
        assert harness.reader(name)(run) is None, name
    assert run.notes == []
    assert harness.reader("single.dispatch_idle_ms")(harness.Run()) is None


def test_no_spans_recorded_gives_none(monkeypatch):
    from pasta_tpu_torch import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: [])
    run = Timeline().run([_mark(0), _mark(10)])
    assert all(harness.reader(name)(run) is None for name in NEW)


def test_a_run_reads_the_spans_recorded_since_the_last_run():
    """The first reader of a run takes the port's spans and empties its
    store: the next run in the process reads only its own."""
    from torch.profiler import ProfilerActivity, profile

    from pasta_tpu_torch import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("decode"):
            pass
    first, second = harness.Run(), harness.Run()
    assert [s.name for s in program.spans(first)] == ["decode"]
    assert program.median_ms(first, "decode") is not None
    assert tracing.snapshot() == [] and program.spans(second) == []
    assert program.spans(first) is first.port_spans


def test_new_metrics_are_declared_for_one_cell_each():
    declared = {m["name"]: m for m in harness.declared()["per_layer"]}
    for name in NEW:
        cell = ("g512_fp32_single_b1" if name.startswith("single.")
                else "g512_fp32_stream_b8")
        assert declared[name]["workloads"] == [cell]
        assert declared[name]["better"] == "lower"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_port_ranges_are_no_kernels(device):
    """The port's pasta.* ranges, on the host (CPU) or as the profiler's
    annotation on the device's timeline (CUDA, is_user_annotation), leave
    the kernels, the labels and the metrics read from them as they were."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    k1 = "void conv3x3_f32_kernel<64, 64>(float const*)"

    def event(name, start, end, dev=cuda, annotation=False):
        return SimpleNamespace(name=name, device_type=dev,
                               is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    base = [event(mark, 0, 1), event(k1, 2, 30), event("k", 40, 60),
            event(mark, 100, 101), event(k1, 102, 130),
            event(mark, 200, 201),
            event("bench.run_batch", 1, 90, cpu)]
    ranges = [event(f"pasta.{n}", s, e, cpu if device == "cpu" else cuda,
                    annotation=device == "cuda")
              for n, s, e in (("run_batch", 1, 190), ("generator", 5, 95),
                              ("upload", 70, 99))]
    plain, with_ranges = trace.Span(), trace.Span()
    plain.read(base)
    with_ranges.read(base + ranges)
    assert with_ranges.kernels == plain.kernels
    assert with_ranges.labels == plain.labels == [("run_batch", 1, 90)]
    assert (with_ranges.busy_s, with_ranges.window_s) == (plain.busy_s,
                                                          plain.window_s)
    assert with_ranges.idle_gaps() == plain.idle_gaps()
    for name in ("idle_share.serve", "idle_share.single"):
        runs = [harness.Run(), harness.Run()]
        runs[0].trace, runs[1].trace = plain, with_ranges
        assert harness.reader(name)(runs[0]) == harness.reader(name)(runs[1])
