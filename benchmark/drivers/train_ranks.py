"""Data-parallel training: the port's `training_loop` in `data_axis_size`
ranks spawned by the port's `train/entry.py::spawn`, one card a rank over
NCCL (gloo on the CPU), each rank on its own rows of the global batch
with the configuration's TrainConfig and the mix's loader, tick and
workers (`rank_main`); `lib/ranks.py` holds what wraps the loop's step
and what checks it.

This process spawns the ranks, writes the seeded synthetic root while
they start (they wait for it before they read it), and waits for them
until the workload's deadline (`deadline_s` after the start of
`run.py`, plus the window's seconds); past it, it kills every rank and
fails, so that a rank stuck at a collective never hangs the run.

The window opens and closes at rank 0's progress calls, as the one-card
driver's does (`drivers/train.py`), but holds at least the workload's
`min_window_steps` steps: a tick of four ranks outlasts `--seconds`, and
one tick alone leaves a slow stretch of the shared host unaveraged. Rank
0 decides when it closes and tells the others. `train_sec_per_kimg` is
the window's seconds over the global batch's images / 1000. The device's
peak memory is the fullest card's. `run.trace` is rank 0's traced span
(with `traced_kinds`, and the reference's operations a step of each kind
on rank 0's rows, `ops_kinds`, for the one-card cell's readers), and
`run.ranks` every rank's spans, NCCL kernels and collective counts
(`metrics/train_x4.*.py`).

The check's numbers are each the worst rank's, and beside them:
`rows_off` over every rank's kept rows (`ranks.rows_off`: a row that is
not the person the loader's rank-strided index stream puts there; the
stream repeats persons within a pass, so a repeat alone is no fault) and
`ranks_apart`, the largest difference between two ranks' parameters
after the run.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import threading
import time

import torch
import torch.distributed as dist

from .. import harness
from ..harness import Run
from ..lib import check, ranks, training, tryon
from .train import _patched


def _spawn(world, job, out, deadline):
    """Run `rank_main` in `world` ranks; kill them all at
    `deadline` (perf_counter seconds)."""
    from pasta_tpu_torch.train.entry import spawn

    failed = []

    def target():
        try:
            spawn(rank_main, world, job,
                  "file://" + os.path.join(out, "rendezvous"), out)
        except BaseException as e:      # noqa: BLE001 -- raised below
            failed.append(e)

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(max(deadline - time.perf_counter(), 0.0))
    if thread.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        thread.join(60)
        raise RuntimeError(f"{job['cell']}: the ranks ran past the "
                           f"deadline and were killed")
    if failed:
        raise failed[0]
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _worst(results):
    """({number: the worst rank's value}, {number: where it lies})."""
    numbers, where = {}, {}
    for r, res in enumerate(results):
        for k, v in res["numbers"].items():
            if k not in numbers or v > numbers[k]:
                numbers[k] = v
                where[k] = f"rank {r}" + (f", {res['where'][k]}"
                                          if res["where"].get(k) else "")
    return numbers, where


def run(ctx):
    t, train = ctx.traffic, ctx.config["train"]
    world = train["data_axis_size"]
    if t["tick_interval"] % train["d_reg_interval"]:
        raise ValueError("a tick must hold whole periods of the lazy R1")
    root = os.path.join(ctx.tmp, "root")
    out_dir = os.path.join(ctx.tmp, "ranks")
    os.makedirs(out_dir)
    job = dict(cell=ctx.cell, seed=ctx.seed, seconds=ctx.seconds,
               trace=ctx.trace, control=ctx.control, t_start=ctx.t_start,
               tmp=ctx.tmp, root=root,
               device="cpu" if ctx.device == "cpu" else "cuda",
               overrides={"workload": ctx.workload, "config": ctx.config,
                          "traffic": ctx.traffic})
    deadline = ctx.t_start + ctx.workload["deadline_s"] + ctx.seconds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        written = pool.submit(ranks.write_root, ctx, root)
        results = _spawn(world, job, out_dir, deadline)
        written.result()
    first = results[0]
    ctx.stamps = sorted(ctx.stamps + first["stamps"], key=lambda s: s[1])
    out = Run()
    out.window_steps = {}
    if "window" in first:
        window_s, steps, out.attempted, out.failed, ticks = first["window"]
        out.window_s, out.items = window_s, steps
        out.e2e["setup_s"] = first["t_open"] - ctx.t_start
        out.e2e["train_sec_per_kimg"] = window_s / (
            steps * train["batch_size"] / 1e3)
        out.window_steps = {True: steps // train["d_reg_interval"]}
        out.window_steps[False] = steps - out.window_steps[True]
        out.notes.append(
            f"window: {steps} steps of {world} ranks in {window_s:.3f} s "
            f"({out.attempted} ticks, {out.failed} failed; each tick's s: "
            f"{', '.join(f'{x:.3f}' for x in ticks)})")
    out.trace, out.traced_kinds = first["span"], first["traced_kinds"]
    out.ops_kinds = first["ops_kinds"]
    out.ranks = [r["traced"] for r in results]
    peaks = [r["peak"] for r in results if r["peak"] is not None]
    out.memory_peak = max(peaks) if peaks else None
    out.notes.append("peak memory by rank, GB: " + ", ".join(
        f"{p / 1e9:.2f}" for p in peaks))
    numbers, where = _worst(results)
    numbers["rows_off"] = ranks.rows_off(
        [r["rows"] for r in results], root, train["resolution"],
        training.loop_seed(ctx))
    numbers["ranks_apart"] = max(r["ranks_apart"] for r in results)
    out.notes.append("check numbers (the worst rank's): " + ", ".join(
        f"{k} {v!r}" + (f" ({where[k]})" if where.get(k) else "")
        for k, v in numbers.items()))
    out.numbers = check.judge(numbers, ctx.workload["check"]["limits"])
    return out


def rank_main(rank, world, job, init_method, out):
    """One rank of the cell: join the group, train, check, and write what
    it measured into `out/rank<rank>.pt`."""
    from pasta_tpu_torch.train.entry import init_distributed

    device = init_distributed(rank, world, init_method, job["device"])
    try:
        ctx = harness.Context(job["cell"], job["seed"], job["seconds"],
                              job["trace"], str(device), job["t_start"],
                              job["tmp"], control=job["control"],
                              overrides=job["overrides"])
        result = run_rank(ctx, job["root"], rank, world)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_rank(ctx, root, rank, world):
    """This rank's loop, from the benchmark's seeded weights, around the
    step it builds wrapped by `ranks.RankRecorder`; then, the program's
    state freed, the check. What it measured, as a dict:

    - every rank: the check's numbers on its rows and where each lies,
      `ranks_apart`, its device's peak memory, its kept batches' real
      images (8-bit, for `rows_off`) and, with a trace, what the readers
      of `metrics/train_x4.*.py` read (`traced`) and the reference's
      operations a step of each kind (`ops_kinds`);
    - rank 0 also: the window, its ticks and set-up stamps and, with a
      trace, its traced span and the kind of each traced step."""
    from pasta_tpu_torch.data.trainsets import TryonTrainDataset
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train import loop
    from pasta_tpu_torch.train.config import TrainConfig

    t = ctx.traffic
    cfg = TrainConfig(**training.train_config(ctx))
    if cfg.data_axis_size != world:
        raise ValueError(f"{ctx.cell}: {cfg.data_axis_size} ranks "
                         f"configured, {world} spawned")
    ctx.stamp("imports")
    weights = training.seeded_weights(ctx)
    vgg = VGG19Features().to(ctx.device).requires_grad_(False)
    vgg.load_state_dict(weights["vgg"])
    ctx.stamp("weights")
    seed = training.loop_seed(ctx)
    ranks.wait_for_root(root)
    ctx.stamp("root")
    dataset = TryonTrainDataset(root, seed=seed, resolution=cfg.resolution,
                                loader_impl=cfg.loader_impl)
    rec = ranks.RankRecorder(ctx, cfg.batch_size, world)
    originals = _patched(loop, rec, weights)
    try:
        with ranks.planted(ctx.control, rank, world):
            loop.training_loop(
                cfg, dataset,
                os.path.join(ctx.tmp, "run") if rank == 0 else None,
                vgg=vgg, tick_interval=t["tick_interval"],
                snapshot_ticks=2 ** 62, num_workers=t["workers"], seed=seed,
                progress_fn=rec.progress, abort_fn=rec.abort,
                device=ctx.device)
    except training.Stop:
        pass
    finally:
        loop.make_train_step, loop.start_state = originals
    out = {"peak": (torch.cuda.max_memory_allocated(ctx.device)
                    if ctx.device.startswith("cuda") else None)}
    if rank == 0 and rec.t_close is not None:
        out["window"] = rec.window(t["tick_interval"])
        out["t_open"] = rec.t_open
    out["traced"] = rec.traced
    if rank == 0:
        out["span"], out["traced_kinds"] = rec.span, rec.traced_kinds
    out["ranks_apart"] = ranks.ranks_apart(rec.state)
    program = rec.side(weights)
    batches, kinds = rec.batches, rec.kinds
    # the loader's 8-bit values back (the card divides by 127.5 as a
    # product with its reciprocal: an ulp off numpy's quotient)
    out["rows"] = torch.cat([torch.round((b["real_img"].cpu() + 1) * 127.5)
                             for b in batches]).to(torch.uint8)
    del rec, vgg, dataset
    tryon.release()
    out["numbers"], out["where"] = ranks.check_rank(
        ctx, program, weights, batches, kinds, rank, world)
    del program
    out["ops_kinds"] = (ranks.count_ops(ctx, weights, batches, kinds, rank,
                                        world) if ctx.trace else {})
    out["stamps"] = ctx.stamps
    return out
