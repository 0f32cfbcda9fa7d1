"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

Everything a cell is sits in files of its own, found by the names in
BENCHMARK.json: `workloads/<cell>.json` (its configuration, traffic,
driver, warm-up, sample and limits), `configs/<config>.json`,
`traffic/<traffic>.json`, `drivers/<driver>.py` and one reader a
per-layer metric, `metrics/<metric>.py`. A driver returns a `Run`; the
harness keeps of it the end-to-end metrics BENCHMARK.json gives the cell
(trace 0) or its per-layer metrics (trace 1).
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pasta_tpu")


def pin_caches():
    """Point every build and kernel cache a run may fill at fixed
    directories inside the checkout (the port builds its CUDA sources into
    `pasta_tpu_torch/_build/` by itself), so that only a checkout's first
    run builds and the two sides of a comparison share nothing."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def declared():
    """BENCHMARK.json at the root of the checkout."""
    return _json(ROOT, "BENCHMARK.json")


def metrics_of(cell, bench=None):
    """(end-to-end metric entries, per-layer metric entries) of a cell:
    those whose `workloads` list it, or that have no such list."""
    bench = bench or declared()

    def of(entries):
        return [m for m in entries if cell in m.get("workloads", [cell])]

    return of(bench["end_to_end"]), of(bench["per_layer"])


class Context:
    """One run's inputs: the cell's files, the seed, the window's length,
    whether it traces, the device, the directory it may write into
    (`tmp`), and whether the reference at TF32 stands in for the program
    (`control`, the comparison's control; tests only)."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, tmp,
                 control=False, overrides=None):
        self.cell = cell
        self.workload = _json(HERE, "workloads", f"{cell}.json")
        self.config = _json(HERE, "configs",
                            f"{self.workload['config']}.json")
        self.traffic = _json(HERE, "traffic",
                             f"{self.workload['traffic']}.json")
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.control = device, t_start, control
        self.tmp = tmp
        self.stamps = []

    def stamp(self, what):
        """Note the seconds since the process started at a step of set-up
        (printed on standard error: where set-up goes)."""
        self.stamps.append((what, time.perf_counter() - self.t_start))


class Run:
    """What a driver measured: end-to-end values (`e2e`), host-clock
    durations of the window by name (`spans`, seconds), what the window
    completed (`items`) over `window_s`, the reference's operation counter
    at the cell's batch (`ops`, `ops_items`), the traced span (`trace`),
    the answers attempted and failed, the compared numbers (`numbers`),
    the device's peak memory and lines for standard error (`notes`)."""

    def __init__(self):
        self.e2e = {}
        self.spans = collections.defaultdict(list)
        self.items = 0
        self.window_s = None
        self.ops = self.ops_items = None
        self.trace = None
        self.attempted = self.failed = 0
        self.numbers = {}
        self.memory_peak = None
        self.notes = []


def reader(metric):
    """metrics/<metric>.py's `read(run)`."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(ctx):
    return importlib.import_module(f"benchmark.drivers.{ctx.workload['driver']}")


def loaded_forbidden():
    """Top-level names of JAX or the JAX package in sys.modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def metric_values(ctx, run, bench=None):
    """{name: {"value", "unit"}} of the metrics this run reports."""
    e2e, layers = metrics_of(ctx.cell, bench)
    out = {}
    if not ctx.trace:
        for m in e2e:
            if m["name"] not in run.e2e:
                raise RuntimeError(f"{ctx.cell}: the driver measured no "
                                   f"{m['name']}")
            out[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in layers:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
