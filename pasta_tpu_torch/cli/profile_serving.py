"""Where the time of one serving batch goes, on one NVIDIA GPU.

Builds the same run as chip_smoke.py's main phase (fashion Generator config,
num_bf16_res=3, seeded random weights, seeded synthetic records, batch 8,
upper mode) and prints:

  - the card's name and power limit (nvidia-smi);
  - per stage of TryonPipeline.run_batch -- upload (np.stack + H2D),
    ingest_device, assemble_inputs_device, Generator -- the CUDA-event
    time, median of REPEATS batches, for a tiled and a full-path batch,
    beside the batch's host wall time;
  - TryonPipeline.run_stream over 512 pairs of a synthetic dataset root
    (its 16 pairs cycled; batch 8), with 1, 2, 4 and 8 host prep threads,
    through cli.bench.stream_throughput, untraced (before any trace runs
    in the process);
  - a torch.profiler trace of one tiled run_batch: device busy time (union
    of kernel intervals) over the device span, the idle share, and kernel
    time by kernel name;
  - the same run_stream passes under a device-only trace: img/s, the
    host's ms a batch queueing it, waiting for its prep and waiting for
    the previous batch's output (the pipeline's `run_batch`, `prep_wait`
    and `fetch_wait` spans, pasta_tpu_torch/tracing.py) and the device's
    idle share over the run (how far the overlap of host prep and device
    work reaches).

Run from the repository root:  python3 -m pasta_tpu_torch.cli.profile_serving
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 8
REPEATS = 5
TOP_KERNELS = 30


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _stages(pipe, items, tiled):
    from pasta_tpu_torch.serving import assemble_inputs_device, ingest_device

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        ev[0].record()
        batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(
            pipe.device) for k in items[0] if k != "tiles_fit"}
        ev[1].record()
        ing = ingest_device(batch)
        ev[2].record()
        inputs = assemble_inputs_device(ing, pipe.mode, tiled=tiled)
        ev[3].record()
        pipe.model(noise_mode="const", **inputs)
        ev[4].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)], wall * 1e3


def _idle_share(prof):
    """(device busy ms, device span ms, idle share) of a trace's kernels."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() > 0]
    if not kernels:
        raise RuntimeError("profile_serving: the trace holds no device time")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_us(intervals)
    return busy / 1e3, span / 1e3, 1 - busy / span, kernels


def _span_ms(spans):
    """{name: mean ms} of the pipeline's spans."""
    ms = collections.defaultdict(list)
    for s in spans:
        ms[s.name].append((s.end - s.start) / 1e6)
    return {name: float(np.mean(v)) for name, v in ms.items()}


def _stream(pipe, trace=None):
    """run_stream over a synthetic root at 1, 2, 4 and 8 prep threads, each
    measured by cli.bench.stream_throughput; with `trace` = (profile,
    activities), under a trace, with the host's ms a batch in the
    pipeline's `run_batch`, `prep_wait` and `fetch_wait` spans and the
    device's idle share."""
    from pasta_tpu_torch import tracing
    from pasta_tpu_torch.cli import bench
    from pasta_tpu_torch.data.synthetic import write_tryon_root

    with tempfile.TemporaryDirectory(prefix="pasta_profile_") as tmp:
        root = os.path.join(tmp, "root")
        pairs = write_tryon_root(root, 16)
        if trace is None:
            for workers in (1, 2, 4, 8):
                rate = bench.stream_throughput(pipe, root, pairs, BATCH,
                                               num_workers=workers)
                print(f"[stream] run_stream {bench.STREAM_PAIRS} pairs, "
                      f"batch {BATCH}, {workers} prep threads, untraced: "
                      f"{rate:.2f} img/s", flush=True)
            return
        for workers in (1, 2, 4, 8):
            prof = trace[0](activities=trace[1])
            tracing.clear()
            rate = bench.stream_throughput(pipe, root, pairs, BATCH,
                                           num_workers=workers, context=prof)
            busy, span, idle, _ = _idle_share(prof)
            # the warm-up batch ran before the trace and recorded no span
            ms = _span_ms(tracing.snapshot())
            print(f"[stream] run_stream {bench.STREAM_PAIRS} pairs, "
                  f"batch {BATCH}, {workers} prep threads, traced: "
                  f"{rate:.2f} img/s | ms a batch: queueing run_batch "
                  f"{ms['run_batch']:.1f}, prep_wait {ms['prep_wait']:.1f}, "
                  f"fetch_wait {ms['fetch_wait']:.1f} | device busy "
                  f"{busy:.1f} ms over a span of {span:.1f} ms, idle share "
                  f"{idle:.3f}", flush=True)
        tracing.clear()


def main():
    if not torch.cuda.is_available():
        print("profile_serving: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from torch.profiler import ProfilerActivity, profile

    from pasta_tpu_torch.data.synthetic import make_garment, make_person
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.ops import conv3x3
    from pasta_tpu_torch.serving import TryonPipeline
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    conv3x3.build()
    model = Generator(seed=0, num_bf16_res=3).eval().to("cuda")
    pipe = TryonPipeline(model, mode="upper")
    tiled_items = [pipe.prepare(make_person(s, jitter=3.0),
                                make_garment(1000 + s, jitter=3.0))
                   for s in range(BATCH)]
    full_items = [pipe.prepare(make_person(s, jitter=40.0),
                               make_garment(1000 + s, jitter=40.0))
                  for s in range(100, 100 + BATCH)]
    if not all(bool(it["tiles_fit"]) for it in tiled_items) or all(
            bool(it["tiles_fit"]) for it in full_items):
        raise RuntimeError("profile_serving: synthetic batches do not take "
                           "the tiled and the full paste path")

    for name, items, tiled in (("tiled", tiled_items, True),
                               ("full", full_items, False)):
        _stages(pipe, items, tiled)                      # warm-up
        runs = [_stages(pipe, items, tiled) for _ in range(REPEATS)]
        med = np.median(np.array([r[0] for r in runs]), axis=0)
        walls = [r[1] for r in runs]
        print(f"[stages] {name} B={BATCH}: upload {med[0]:.2f} ingest "
              f"{med[1]:.2f} assemble {med[2]:.2f} generator {med[3]:.2f} ms "
              f"(CUDA events, median of {REPEATS}) | wall median "
              f"{np.median(walls):.2f} ms, all {[round(w, 1) for w in walls]}",
              flush=True)

    _stream(pipe)                    # before any trace in this process
    pipe.run_batch(tiled_items)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_batch(tiled_items)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, span, idle, kernels = _idle_share(prof)
    print(f"[profile] tiled B={BATCH}: wall {wall:.1f} ms | device busy "
          f"{busy:.1f} ms over a device span of {span:.1f} ms, "
          f"idle share {idle:.3f} | {len(kernels)} device events",
          flush=True)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())
    print(f"[profile] kernel time {total / 1e3:.1f} ms; top {TOP_KERNELS}:")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"{us / 1e3:9.2f} ms {100 * us / total:5.1f}% x{n:5d}  "
              f"{name[:110]}")
    _stream(pipe, (profile, [ProfilerActivity.CUDA]))


if __name__ == "__main__":
    main()
