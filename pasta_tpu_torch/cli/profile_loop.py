"""Where the time between two training steps goes, on one NVIDIA GPU.

Drives what `train/loop.py` does around a step -- take a batch from
`ParallelLoader`, upload it, assemble it on the card, queue the step -- on
a synthetic dataset root at the fashion preset, and prints for each variant
the wall s/step, the step's time on the card (CUDA events), the gap between
two steps on the card, and the host's share of each part, all without the
first two steps (the pool's start-up). With `--timeline`
it also prints when each of the pool's threads started and ended each item,
on the main thread's clock. The variants: the batch resident on the card
(no loader), then each loader with 8 threads and with one, taking the next
batch after the upload and assembly (as the loop does) or before them (at
the top of the step, as the JAX loop does), and with the batches loaded
beforehand (the floor: upload and assembly alone). TF32 is off.

Run from the repository root:
    python3 -m pasta_tpu_torch.cli.profile_loop [--batch 4] [--steps 6]
        [--persons 24] [--timeline]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch


def run_variant(tag, step, state, resident, gen, root, batch_size, n,
                impl="device", workers=8, take="after", preload=False,
                timeline=False):
    """n steps of one variant; prints its line (and its timeline)."""
    from pasta_tpu_torch.data import trainsets as ts
    from pasta_tpu_torch.train import loop as tloop

    loader, log = None, []
    if impl is not None:
        ds = ts.TryonTrainDataset(root, seed=0, loader_impl=impl)
        loader = tloop.ParallelLoader(ds, batch_size, workers, 0)
        inner = loader._get

        def timed_item(i):
            t0 = time.perf_counter()
            item = inner(i)
            log.append((t0, time.perf_counter(), threading.get_ident()))
            return item

        loader._get = timed_item
        batches = iter(loader)
        if preload:
            loaded_all = [next(batches) for _ in range(n)]
            loader.close()
            batches = iter(loaded_all)

    def assemble(loaded):
        with torch.no_grad():
            if impl == "device":
                return ts.assemble_train_batch_lean(
                    tloop.upload_batch(loaded[0], "cuda"), tiled=loaded[1])
            return ts.assemble_train_batch(
                tloop.upload_batch(loaded, "cuda"))

    events, rows = [], []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    loaded = next(batches) if loader is not None and take == "after" else None
    for i in range(n):
        t0 = time.perf_counter()
        if loader is not None and take == "before":
            loaded = next(batches)
        t1 = time.perf_counter()
        batch = resident if loader is None else assemble(loaded)
        t2 = time.perf_counter()
        if loader is not None and take == "after" and i + 1 < n:
            loaded = next(batches)
        t3 = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(state, batch, gen)
        e1.record()
        events.append((e0, e1))
        rows.append((t0 - t_start, (t1 - t0) + (t3 - t2), t2 - t1,
                     time.perf_counter() - t3))
    torch.cuda.synchronize()
    warm = 2                                   # the pool's start-up apart
    wall = (time.perf_counter() - t_start - rows[warm][0]) / (n - warm)
    if loader is not None and not preload:
        loader.close()
    on_card = np.mean([a.elapsed_time(b) for a, b in events[warm:]]) / 1e3
    gap = np.mean([a[1].elapsed_time(b[0])
                   for a, b in zip(events[warm:], events[warm + 1:])])
    take_ms, prep_ms, queue_s = (np.mean([r[k] for r in rows[warm:]])
                                 for k in (1, 2, 3))
    print(f"[loop] {tag:58s} wall {wall:.4f} s/step | step on card "
          f"{on_card:.4f} s | gap {gap:7.2f} ms | host: taking a batch "
          f"{1e3 * take_ms:6.1f} ms, upload + assembly queued in "
          f"{1e3 * prep_ms:6.1f} ms, the step in {queue_s:.4f} s", flush=True)
    if timeline:
        for r in rows:
            print(f"[loop]     step begins at {r[0]:.3f} s: batch taken in "
                  f"{1e3 * r[1]:.1f} ms, upload + assembly queued in "
                  f"{1e3 * r[2]:.1f} ms, the step in {1e3 * r[3]:.1f} ms")
        for t0, t1, tid in sorted(log):
            print(f"[loop]       item {t0 - t_start:.3f} -> "
                  f"{t1 - t_start:.3f} s ({1e3 * (t1 - t0):.0f} ms), thread "
                  f"{tid % 1000}")
        sys.stdout.flush()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--persons", type=int, default=24)
    p.add_argument("--timeline", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_loop: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)

    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.data.synthetic import write_dataset_root
    from pasta_tpu_torch.train.config import fashion_config

    cfg = fashion_config(batch_size=args.batch)
    state, step, resident, gen = bench_train.setup(cfg, "cuda")
    tmp = tempfile.mkdtemp(prefix="pasta_profile_loop_")
    try:
        root = os.path.join(tmp, "root")
        write_dataset_root(root, args.persons, 500)
        step(state, resident, gen)             # warm-up: builds the kernels
        torch.cuda.synchronize()
        common = (step, state, resident, gen, root, args.batch, args.steps)
        run_variant("resident batch, no loader", *common, impl=None)
        for impl in ("device", "host"):
            for workers in (8, 1):
                for take in ("after", "before"):
                    run_variant(
                        f"{impl} loader, {workers} thread(s), next batch "
                        f"taken {take} upload + assembly", *common, impl=impl,
                        workers=workers, take=take,
                        timeline=args.timeline and workers == 8)
            run_variant(f"{impl} loader, batches loaded beforehand", *common,
                        impl=impl, preload=True)
        run_variant("resident batch, no loader, again", *common, impl=None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
