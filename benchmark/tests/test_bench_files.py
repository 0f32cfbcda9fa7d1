"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, driver and per-layer reader is a file of its own, found by
name, and the declaration keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.declared()
# the numbers each driver's check compares
CHECKED = {"stream": {"share_off", "mean_gap"},
           "single": {"share_off", "mean_gap"},
           "train": {"first_loss_gap.g", "first_loss_gap.r1", "rows_off"}
           | {f"grad_median.{m}" for m in ("g", "d", "dp")}
           | {f"change_median.{m}" for m in ("g", "d", "dp", "g_ema")}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = harness.HERE


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(word) for word in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    ctx = harness.Context(cell, 1, 1.0, False, "cpu", 0.0, None)
    assert ctx.workload["config"] == entry["config"]
    assert ctx.workload["traffic"] == entry["traffic"]
    assert ctx.workload["chips"] == entry["chips"]
    assert ctx.workload["why"] == entry["why"]
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       f"{ctx.workload['driver']}.py"))
    assert set(ctx.workload["check"]["limits"]) == \
        CHECKED[ctx.workload["driver"]]
    e2e, layers = harness.metrics_of(cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layers


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/")
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        data = json.load(f)
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    assert data["source"] == entry["source"] and data["assumed"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        # each listed cell reports the metric it moves
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved, m["name"]
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_a_per_layer_metric_and_an_e2e_metric():
    for w in BENCH["workloads"]:
        e2e, layers = harness.metrics_of(w["name"])
        assert len(e2e) >= 2 and layers, w["name"]


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
