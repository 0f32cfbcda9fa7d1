"""The port's spans (`pasta_tpu_torch/tracing.py`) in the serving path, on
the CPU: nothing recorded, no range opened and no clock read without a
profiler; under a CPU `torch.profiler` the tree of spans of
`prepare_pair`, `run_batch` and `run_stream` with their parents and
shared batch ids (prep spans on the pool's threads, shard spans under
`mesh=["cpu", "cpu"]` on the mesh's thread), the `graph` attribute of
`run_batch` ("eager" on the CPU), the `pasta.*` ranges among
the profiler's events, outputs bit-equal with tracing on and off, and the
cap's `dropped` count.

The generator is the 64 px one of tests/test_torch_generator.py (channel_base
2048, channel_max 128) behind a wrapper that takes every 8th pixel of the pipeline's 512 px
inputs, so that a batch costs little here; what the spans bracket is the
pipeline's own code, whatever the model.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pasta_tpu_torch import serving, tracing
from pasta_tpu_torch.data.synthetic import write_tryon_root
from pasta_tpu_torch.models import Generator

FORWARD = ["upload", "ingest", "assemble", "generator"]


class SmallG(torch.nn.Module):
    """The 64 px generator on every 8th pixel of the 512 px inputs."""

    def __init__(self):
        super().__init__()
        self.g = Generator(seed=0, img_resolution=64, channel_base=2048,
                           channel_max=128).eval()

    def forward(self, noise_mode, generator, **inputs):
        small = {k: v[:, ::8, ::8].contiguous() if v.dim() == 4 else v
                 for k, v in inputs.items()}
        return self.g(noise_mode=noise_mode, generator=generator, **small)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return SmallG()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("traceroot") / "root")
    return path, write_tryon_root(path, 3, seed=7)


@pytest.fixture(scope="module")
def items(model, root):
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper")
    return [pipe.prepare_pair(path, p) for p in pairs[:2]]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(child, parent):
    return parent.start <= child.start <= child.end <= parent.end


def test_off_records_nothing(model, root, items, monkeypatch):
    """Without a profiler every span is the one null context: no range
    opened, no clock read, nothing kept."""
    def refuse(*a, **k):
        raise AssertionError("called off a profiler")

    monkeypatch.setattr(tracing, "_range", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    assert tracing.span("a") is tracing.span("b", size=1) is tracing._NULL
    assert tracing.batch(3) is tracing._NULL
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper")
    pipe.prepare_pair(path, pairs[0])
    pipe.run_batch(items)
    list(pipe.run_stream(path, pairs, batch_size=2, num_workers=2))
    assert tracing.snapshot() == [] and tracing.dropped() == 0


def test_single_request_tree(model, root, items):
    """prepare_pair's decode and host_prepare, run_batch's four stages:
    children by parent id, inside their parent's time, on one thread;
    run_batch's attributes and one batch id for its spans."""
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper")
    with _cpu_profile():
        pipe.prepare_pair(path, pairs[0])
        pipe.run_batch(items)
        pipe.run_batch(items[:1])
    spans = tracing.snapshot()
    named = _by_name(spans)
    assert sorted(named) == sorted(["prepare_pair", "decode",
                                    "host_prepare", "run_batch"] + FORWARD)
    prep, = named["prepare_pair"]
    assert prep.parent is None
    for name in ("decode", "host_prepare"):
        child, = named[name]
        assert child.parent == prep.id and _inside(child, prep)
    assert named["decode"][0].end <= named["host_prepare"][0].start
    main = threading.get_ident()
    assert {s.thread for s in spans} == {main}
    batches = named["run_batch"]
    assert [b.attrs["size"] for b in batches] == [2, 1]
    assert all(b.parent is None and b.attrs["tiled"] == pipe.last_tiled
               for b in batches)
    assert batches[0].attrs["batch"] != batches[1].attrs["batch"]
    for b in batches:
        kids = sorted((s for s in spans if s.parent == b.id),
                      key=lambda s: s.start)
        assert [s.name for s in kids] == FORWARD
        assert all(_inside(s, b) and s.attrs["batch"] == b.attrs["batch"]
                   for s in kids)


def test_stream_tree(model, root):
    """run_stream over 3 pairs at batch 2: per batch one id shared by its
    prep spans (pool threads), prep_wait, run_batch and its stages, fetch
    and fetch_wait (serving thread)."""
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper")
    with _cpu_profile():
        out = list(pipe.run_stream(path, pairs, batch_size=2, num_workers=2))
    assert [c for c, _ in out] == [pairs[:2], pairs[2:]]
    spans = tracing.snapshot()
    main = threading.get_ident()
    by_batch = {}
    for s in spans:
        by_batch.setdefault(s.attrs["batch"], []).append(s)
    assert len(by_batch) == 2
    for (bid, group), n_pairs in zip(sorted(by_batch.items()), (2, 1)):
        named = _by_name(group)
        serving_side = ["prep_wait", "run_batch", "fetch", "fetch_wait"]
        assert sorted(named) == sorted(serving_side + FORWARD + [
            "prepare_pair", "decode", "host_prepare"])
        assert [len(named[n]) for n in ("prepare_pair", "decode",
                                        "host_prepare")] == [n_pairs] * 3
        for s in named["prepare_pair"]:
            assert s.thread != main and s.parent is None
        for name in ("decode", "host_prepare"):
            parents = {s.parent for s in named[name]}
            assert parents == {s.id for s in named["prepare_pair"]}
        for name in serving_side + FORWARD:
            s, = named[name]
            assert s.thread == main
        rb = named["run_batch"][0]
        assert rb.attrs["size"] == 2 and rb.parent is None
        assert all(named[n][0].parent == rb.id for n in FORWARD)
        wait, fetch = named["prep_wait"][0], named["fetch"][0]
        assert wait.end <= rb.start and rb.end <= fetch.start
        assert named["fetch_wait"][0].start >= fetch.end
        assert max(s.end for s in named["prepare_pair"]) <= wait.end


def test_mesh_shard_spans(model, items):
    """Under mesh=["cpu", "cpu"] each shard's stages run on the mesh's
    thread with the run_batch span as their parent and the shard's
    device, and share its batch id."""
    with serving.TryonPipeline(model, mode="upper", mesh=["cpu", "cpu"]) \
            as pipe:
        with _cpu_profile():
            pipe.run_batch(items)
    spans = tracing.snapshot()
    rb, = _by_name(spans)["run_batch"]
    assert rb.thread == threading.get_ident()
    kids = [s for s in spans if s.parent == rb.id]
    assert sorted(s.name for s in kids) == sorted(FORWARD * 2)
    assert {s.thread for s in kids} != {rb.thread}
    assert len({s.thread for s in kids}) == 1
    assert all(s.attrs["device"] == "cpu"
               and s.attrs["batch"] == rb.attrs["batch"] for s in kids)
    assert len(spans) == 9


def test_run_batch_runs_eagerly_on_the_cpu(model, items):
    """On the CPU no batch is captured into a CUDA graph: the pipeline
    counts every batch eager, holds no graph, and each run_batch span
    carries graph="eager", with and without a mesh."""
    pipe = serving.TryonPipeline(model, mode="upper")
    with _cpu_profile():
        pipe.run_batch(items)
        pipe.run_batch(items[:1])
    assert pipe.graph_counts == {"replay": 0, "capture": 0, "eager": 2}
    assert pipe.graph_keys == 0
    with serving.TryonPipeline(model, mode="upper", mesh=["cpu", "cpu"]) \
            as split:
        with _cpu_profile():
            split.run_batch(items)
    assert split.graph_counts == {"replay": 0, "capture": 0, "eager": 1}
    batches = _by_name(tracing.snapshot())["run_batch"]
    assert [b.attrs["graph"] for b in batches] == ["eager"] * 3


def test_ranges_on_the_profiler_timeline(model, items):
    """Each recorded span opens pasta.<name> on the thread that runs it:
    the main thread's ranges are among the profiler's events, nested as
    the spans are."""
    pipe = serving.TryonPipeline(model, mode="upper")
    with _cpu_profile() as prof:
        pipe.run_batch(items)
    events = {}
    for e in prof.events():
        if e.name.startswith("pasta."):
            events.setdefault(e.name, []).append(e)
    assert sorted(events) == sorted(
        "pasta." + n for n in ["run_batch"] + FORWARD)
    rb, = events["pasta.run_batch"]
    for n in FORWARD:
        e, = events["pasta." + n]
        assert e.thread == rb.thread
        assert (rb.time_range.start <= e.time_range.start
                <= e.time_range.end <= rb.time_range.end)


def test_outputs_equal_with_tracing_on_and_off(model, root, items):
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper")
    off = pipe.run_batch(items).numpy()
    stream_off = list(pipe.run_stream(path, pairs, batch_size=2,
                                      num_workers=2))
    with _cpu_profile():
        on = pipe.run_batch(items).numpy()
        stream_on = list(pipe.run_stream(path, pairs, batch_size=2,
                                         num_workers=2))
    assert tracing.snapshot()
    assert np.array_equal(on, off)
    assert len(stream_on) == len(stream_off)
    for (c_on, o_on), (c_off, o_off) in zip(stream_on, stream_off):
        assert c_on == c_off and np.array_equal(o_on, o_off)


def test_explicit_parent_and_batch_scope():
    """A parent passed explicitly wins over the thread's stack and hands
    on its batch; `batch()` keeps the batch in scope or takes a new one."""
    with _cpu_profile():
        with tracing.batch(41):
            with tracing.span("outer") as outer:
                with tracing.batch() as inner_bid:
                    assert inner_bid == 41
        with tracing.span("other") as other:
            def shard():
                with tracing.span("shard", parent=outer):
                    pass

            t = threading.Thread(target=shard)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.batch() as a:
            pass
        with tracing.batch() as b:
            pass
    named = {s.name: s for s in tracing.snapshot()}
    assert named["outer"].attrs == {"batch": 41}
    assert named["shard"].parent == outer.id != other.id
    assert named["shard"].attrs == {"batch": 41}
    assert "batch" not in named["other"].attrs
    assert a != b


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores, switching every microsecond, past the cap:
    every span is kept or counted as dropped, each with its own id and its
    own thread's parent."""
    import sys

    monkeypatch.setattr(tracing, "CAP", 5000)
    n_threads, n_spans = 12, 600
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(n_spans // 2):
                    with tracing.span("outer"):
                        with tracing.span("inner"):
                            pass

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    kept = tracing.snapshot()
    assert len(kept) == 5000
    assert len(kept) + tracing.dropped() == n_threads * n_spans
    assert len({s.id for s in kept}) == len(kept)
    by_id = {s.id: s for s in kept}
    for s in kept:
        if s.name == "inner" and s.parent in by_id:
            assert by_id[s.parent].thread == s.thread
            assert by_id[s.parent].name == "outer"


def test_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with _cpu_profile():
        for i in range(5):
            with tracing.span("s", i=i):
                pass
    assert [s.attrs["i"] for s in tracing.snapshot()] == [0, 1, 2]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.snapshot() == [] and tracing.dropped() == 0
