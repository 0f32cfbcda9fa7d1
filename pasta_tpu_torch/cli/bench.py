"""Benchmark: end-to-end 512px try-on serving throughput on one NVIDIA GPU;
twin of the root bench.py.

Measures both stages of serving and their overlap:
  * device: ingest_device (uint8 -> fp32 planes and, with cond="device",
    the person conditioning), then the warps, the input assembly and the
    generator forward, on one batch uploaded once; each stage timed by
    CUDA events over --iters launches (ingest_ms, warp_forward_ms);
  * host: decode + keypoint parse + masks + homography solves (load_person
    + host_prepare) over a pool of 8 threads (host_prep_images_per_sec);
  * both: one TryonPipeline.run_stream pass over STREAM_PAIRS pairs
    (the root's pairs cycled; 64 batches of 8), host prep of
    later batches on 8 threads while the card runs
    (stream_images_per_sec), the one rate here measured end to end.

The data: the dataset root given by --dataroot with its test_pairs.txt
(bench.py reads its fixture root so), else a synthetic root of --persons
persons (`data/synthetic.write_tryon_root`) in a temporary directory;
the `data` field says which. Weights are the port's seeded random
generator. Upper mode, as bench.py.

Prints one line per extra batch size (--also-batch, default 32) and, last,
ONE JSON line: "metric", "value" (images/sec/chip of the device stages
alone: batch / (ingest_ms + warp_forward_ms)), "batch", "g_bf16_res",
"ingest_ms", "warp_forward_ms", "cond", "warp_impl",
"host_prep_images_per_sec", "host_cores", "stream_images_per_sec",
"stream_pairs", "device", "power_limit", "data". Needs a card.

    python3 -m pasta_tpu_torch.cli.bench [--batch 8] [--dataroot ROOT]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

MODE = "upper"
STREAM_PAIRS = 512               # 64 batches of 8 a run_stream measurement


def read_pairs(root, pairs_txt="test_pairs.txt"):
    """(person, clothes) names of a pairs file inside the root."""
    from ..data.testsets import TryonPairDataset

    return TryonPairDataset(root, pairs_txt, mode=MODE).pairs


def host_throughput(pipe, root, pairs, num_workers=8, reps=3):
    """Host-stage pairs/s (`TryonPipeline.prepare_pair`) over a thread
    pool, after one warm-up pass."""
    def prep(pair):
        return pipe.prepare_pair(root, pair)

    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(prep, pairs))
        t0 = time.perf_counter()
        for _ in range(reps):
            list(pool.map(prep, pairs))
        dt = time.perf_counter() - t0
    return len(pairs) * reps / dt


def event_ms(fn, iters):
    """Mean CUDA-event time of fn() over `iters` launches, after one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_stages(pipe, items, iters):
    """(ingest ms, warp + forward ms) of one batch, by CUDA events."""
    from ..serving import assemble_inputs_device, ingest_device

    tiled = all(bool(it["tiles_fit"]) for it in items)
    with torch.inference_mode():
        batch = pipe._upload(items)
        ingested = ingest_device(batch)

        def forward():
            inputs = assemble_inputs_device(ingested, pipe.mode, tiled=tiled)
            pipe.model(noise_mode="const", **inputs)

        return (event_ms(lambda: ingest_device(batch), iters),
                event_ms(forward, iters))


def stream_throughput(pipe, root, pairs, batch, num_workers=8,
                      n_pairs=STREAM_PAIRS, context=None):
    """Images/s of one run_stream pass over `n_pairs` pairs (`pairs`
    cycled), with `num_workers` prep threads: host wall clock from the
    call to the last output on the host, after a warm-up pass over one
    batch. Enough batches that the pipeline's fill (the first batch's prep
    alone) and drain (the last output's wait) are a small part of the
    time. `context`, when given, is a context manager entered around the
    timed pass (profile_serving's trace)."""
    for _ in pipe.run_stream(root, pairs[:batch], batch_size=batch,
                             num_workers=num_workers):
        pass
    stream = [pairs[i % len(pairs)] for i in range(n_pairs)]
    with context if context is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in pipe.run_stream(root, stream, batch_size=batch,
                                 num_workers=num_workers):
            pass
        return n_pairs / (time.perf_counter() - t0)


def card():
    """(name, power limit) as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def run(batch=8, g_bf16_res=3, cond="device", iters=20, dataroot=None,
        persons=16, also_batches=(32,)):
    """Measure and return the record of the main batch; each batch of
    `also_batches` is measured too and printed on a line of its own."""
    from ..data.roots import as_root
    from ..data.synthetic import write_tryon_root
    from ..models import Generator
    from ..serving import TryonPipeline

    with tempfile.TemporaryDirectory(prefix="pasta_bench_") as tmp:
        if dataroot is None:
            root = os.path.join(tmp, "root")
            pairs = write_tryon_root(root, persons)
            data = f"synthetic ({persons} persons)"
        else:
            root, pairs, data = dataroot, read_pairs(dataroot), dataroot
        root = as_root(root)
        model = Generator(seed=0, num_bf16_res=g_bf16_res).eval().to("cuda")
        pipe = TryonPipeline(model, mode=MODE, cond=cond)
        base = [pipe.prepare_pair(root, p)
                for p in pairs[:max((batch,) + tuple(also_batches))]]
        name, limit = card()

        def device_record(b):
            items = [base[i % len(base)] for i in range(b)]
            t_ingest, t_main = device_stages(pipe, items, iters)
            ips = b / ((t_ingest + t_main) / 1e3)
            torch.cuda.empty_cache()
            return {
                "metric": "tryon_512px_serving_throughput",
                "value": round(ips, 2), "unit": "images/sec/chip",
                "batch": b, "g_bf16_res": g_bf16_res,
                "ingest_ms": round(t_ingest, 3),
                "warp_forward_ms": round(t_main, 3),
                "cond": cond, "warp_impl": "gather",
                "device": name, "power_limit": limit, "data": data,
            }

        for b in also_batches:
            print(json.dumps(device_record(b)), flush=True)
        record = device_record(batch)
        host_ips = host_throughput(pipe, root, pairs)
        record.update(
            host_prep_images_per_sec=round(host_ips, 2),
            host_cores=os.cpu_count() or 1,
            stream_images_per_sec=round(stream_throughput(
                pipe, root, pairs, batch), 2),
            stream_pairs=STREAM_PAIRS,
        )
        return record


def main(argv=None):
    from ..ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--g-bf16-res", type=int, default=3)
    p.add_argument("--cond", default="device", choices=["device", "host"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dataroot", default=None,
                   help="dataset root with test_pairs.txt (default: a "
                        "synthetic root in a temporary directory)")
    p.add_argument("--persons", type=int, default=16,
                   help="persons of the synthetic root")
    p.add_argument("--also-batch", type=int, nargs="*", default=[32])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    record = run(args.batch, args.g_bf16_res, args.cond, args.iters,
                 args.dataroot, args.persons, tuple(args.also_batch))
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
