"""Single requests, open loop: try-on requests of one (person, clothes)
pair each arrive at the mix's fixed rate, evenly spaced, and one server
thread takes them in order: `prepare_pair` on that thread, `run_batch` of
one item, the image copied to the host.

A request's latency runs from when it was due to its image on the host,
so a request that waits behind a slow one counts the wait. The window
opens after the workload's warm-up requests (taken back to back); every
request due within `ctx.seconds` of its opening belongs to it, and the
last one is waited for. With a trace, `trace_requests` more requests run
on the same schedule under the profiler, each marked on the device when
it starts, one more mark closing the span.
"""

from __future__ import annotations

import time

from ..harness import Run
from ..lib import stats
from ..lib import trace as tr
from ..lib import tryon


def _request(pipe, root, pair, spans=None):
    t0 = time.perf_counter()
    with tr.label("prepare_pair"):
        item = pipe.prepare_pair(root, pair)
    t1 = time.perf_counter()
    with tr.label("run_batch"):
        image = pipe.run_batch([item])
    t2 = time.perf_counter()
    with tr.label("fetch"):
        image = image[0].cpu().numpy()
    if spans is not None:
        spans["prepare_pair"].append(t1 - t0)
        spans["run_batch"].append(t2 - t1)
    return image


def serve(pipe, root, requests, rate, seconds, spans, mark=False,
          keep=None):
    """Serve the requests due at `rate` a second for `seconds` from now:
    each request's latency (from its due time) and lateness (its start
    after its due time) go into `spans`; `keep(pair, image)` sees every
    answer. Returns the seconds until the last answer."""
    t_open = time.perf_counter()
    k = 0
    while k / rate < seconds:
        due = t_open + k / rate
        now = time.perf_counter()
        if now < due:
            with tr.label("idle"):
                time.sleep(due - now)
        start = time.perf_counter()
        if mark:
            tr.mark()
        pair = next(requests)
        image = _request(pipe, root, pair, spans)
        spans["latency"].append(time.perf_counter() - due)
        spans["lateness"].append(start - due)
        if keep is not None:
            keep(pair, image)
        k += 1
    return time.perf_counter() - t_open


def run(ctx):
    pipe, root, pairs, state = tryon.build(ctx)
    w, rate = ctx.workload, ctx.traffic["rate_per_s"]
    out = Run()
    sample = tryon.Reservoir(w["check"]["sample"], ctx.seed)
    requests = iter(pairs)
    for _ in range(w["warmup_requests"]):
        _request(pipe, root, next(requests))
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_start
    ctx.stamp("warm-up")
    out.window_s = serve(pipe, root, requests, rate, ctx.seconds, out.spans,
                         keep=sample.offer)
    out.items = out.attempted = len(out.spans["latency"])
    latency_ms = [1e3 * s for s in out.spans["latency"]]
    out.e2e["tryon_p50_ms"] = stats.percentile(latency_ms, 50)
    out.e2e["tryon_p90_ms"] = stats.percentile(latency_ms, 90)
    out.notes.append(
        "window: {} requests at {} a second; median ms: prepare_pair {:.2f},"
        " run_batch {:.2f}, lateness {:.2f} (max {:.2f})".format(
            out.items, rate, *(1e3 * stats.median(out.spans[k])
                               for k in ("prepare_pair", "run_batch",
                                         "lateness")),
            1e3 * max(out.spans["lateness"])))
    if ctx.trace:
        with tr.Span() as span:
            serve(pipe, root, requests, rate, w["trace_requests"] / rate,
                  {k: [] for k in ("prepare_pair", "run_batch", "latency",
                                   "lateness")}, mark=True)
            tr.mark()
        out.trace = span
    ctx.stamp("window")
    tryon.read_peak(out)
    del pipe
    tryon.release()
    tryon.check_sample(ctx, out, root, state, sample.kept, 1)
    return out
