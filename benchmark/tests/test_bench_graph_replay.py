"""The two readers of the `graph` attribute of the port's `run_batch`
spans (`lib/replay.py`, `serve.graph_replay_share`,
`single.graph_replay_share`) on hand-built spans: the share of the
traced batches that replayed, and None where no `run_batch` span carries
the attribute, where no span was recorded, and where the port has no
`tracing` module."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.lib import program

NEW = ["serve.graph_replay_share", "single.graph_replay_share"]


def _span(name, **attrs):
    return SimpleNamespace(name=name, start=0, end=1, thread=1, attrs=attrs,
                           id=1, parent=None)


def _read(monkeypatch, name, spans):
    monkeypatch.setattr(program, "spans", lambda run: spans)
    return harness.reader(name)(harness.Run())


@pytest.mark.parametrize("name", NEW)
def test_share_of_replayed_batches(monkeypatch, name):
    """Replayed run_batch spans over those that say how they ran; the
    child spans and a run_batch span without the attribute do not count."""
    spans = ([_span("run_batch", graph="replay", batch=k) for k in range(3)]
             + [_span("run_batch", graph="capture"),
                _span("replay", graph="replay"), _span("upload"),
                _span("run_batch", size=8)])
    assert _read(monkeypatch, name, spans) == pytest.approx(0.75)
    eager = [_span("run_batch", graph="eager") for _ in range(2)]
    assert _read(monkeypatch, name, eager) == 0.0
    replayed = [_span("run_batch", graph="replay") for _ in range(7)]
    assert _read(monkeypatch, name, replayed) == 1.0


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_attribute_or_spans(monkeypatch, name):
    """A program whose run_batch spans carry no `graph` (one older than its
    graphs), a run that recorded no span, and a port without spans at
    all read None."""
    older = [_span("run_batch", size=8, tiled=True), _span("generator")]
    assert _read(monkeypatch, name, older) is None
    assert _read(monkeypatch, name, []) is None
    assert _read(monkeypatch, name, None) is None


def test_none_without_the_ports_tracing(monkeypatch):
    monkeypatch.setitem(sys.modules, "pasta_tpu_torch.tracing", None)
    for name in NEW:
        assert harness.reader(name)(harness.Run()) is None, name


def test_declared_for_one_cell_each():
    declared = {m["name"]: m for m in harness.declared()["per_layer"]}
    for name, cell, moves in (
            ("serve.graph_replay_share", "g512_fp32_stream_b8",
             "serve_img_per_s"),
            ("single.graph_replay_share", "g512_fp32_single_b1",
             "tryon_p50_ms")):
        entry = declared[name]
        assert entry["workloads"] == [cell] and entry["moves"] == moves
        assert entry["better"] == "higher" and entry["unit"] == "fraction"
        assert entry["layer"] == "serving pipeline, dispatch"
