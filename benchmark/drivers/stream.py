"""The stream: `TryonPipeline.run_stream` over the mix's pairs, as
`cli.test --pipeline serving` reads a pairs file (closed loop, one
stream, its prep threads ahead of the card).

The window opens when the warm-up's last batch reaches the host and
closes at the first batch to reach it `ctx.seconds` later or more; the
rate is every image that reached the host in between over that time. With
a trace, the stream runs on for the workload's `trace_batches`, each
batch marked on the device where `run_batch` queues it. Then the stream
is closed, and the kept sample is checked against the reference.
"""

from __future__ import annotations

import time

from ..harness import Run
from ..lib import trace as tr
from ..lib import tryon


def run(ctx):
    pipe, root, pairs, state = tryon.build(ctx)
    t, w = ctx.traffic, ctx.workload
    batch = t["batch_size"]
    out = Run()
    sample = tryon.Reservoir(w["check"]["sample"], ctx.seed)
    stream = pipe.run_stream(root, pairs, batch_size=batch,
                             num_workers=t["prep_threads"],
                             prefetch=t["prefetch"])
    for _ in range(w["warmup_batches"]):
        next(stream)
    t_open = time.perf_counter()
    out.e2e["setup_s"] = t_open - ctx.t_start
    ctx.stamp("warm-up")
    while True:
        chunk, images = next(stream)
        now = time.perf_counter()
        out.items += len(chunk)
        for pair, image in zip(chunk, images):
            sample.offer(pair, image)
        if now - t_open >= ctx.seconds:
            break
    out.window_s = now - t_open
    out.attempted = out.items
    out.e2e["serve_img_per_s"] = out.items / out.window_s
    out.notes.append(f"window: {out.items} images in {out.window_s:.3f} s")
    if ctx.trace:
        queue = pipe.run_batch

        def marked(items):
            tr.mark()
            with tr.label("run_batch"):
                return queue(items)

        pipe.run_batch = marked
        with tr.Span() as span:
            for _ in range(w["trace_batches"]):
                with tr.label("stream_next"):
                    next(stream)
        out.trace = span
    stream.close()
    ctx.stamp("window")
    tryon.read_peak(out)
    del pipe, stream
    tryon.release()
    tryon.check_sample(ctx, out, root, state, sample.kept, batch)
    return out
