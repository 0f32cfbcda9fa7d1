"""Training: the port's `training_loop` (the loop `cli.train` runs) on a
seeded synthetic root, from the benchmark's seeded weights, with the
configuration's TrainConfig and the mix's loader, tick and workers.

The step the loop builds is wrapped (`lib/training.py::Recorder`): the
loop's own `make_train_step` and `start_state` are swapped for the run
with versions that call them, the first to label each step
`bench.train_step` and keep what the check needs, the second to load the
benchmark's weights into the state it returns. No snapshot, grid or
evaluator runs.

The window opens at the loop's progress call after the workload's
warm-up ticks (the loop calls it after the tick's metrics reach the host,
which waits for the device) and closes at the first progress call
`ctx.seconds` later or more: whole ticks of `tick_interval` steps, each
holding one lazy R1 step. `train_sec_per_kimg` is the window's seconds
over its images / 1000. The loop is then aborted at that tick; with a
trace it runs `trace_steps` more steps under the profiler and is stopped
from inside the next step (`Stop`). A tick whose fetched losses are not
all finite is a failed one, of the window's ticks.
"""

from __future__ import annotations

import concurrent.futures
import os

import torch

from ..harness import Run
from ..lib import training, tryon
from ..traffic import synth


def _patched(loop, rec, weights):
    """Swap the loop's step factory and start for the run's; returns the
    originals."""
    originals = (loop.make_train_step, loop.start_state)
    start_state = loop.start_state

    def start(cfg, seed, device, resume_path=None):
        state = start_state(cfg, seed, device, resume_path)
        with torch.no_grad():
            for m in training.MODULES:
                getattr(state, m).load_state_dict(weights[m])
            state.g_ema.load_state_dict(weights["g"])
        return state

    loop.make_train_step = rec.factory(loop.make_train_step)
    loop.start_state = start
    return originals


def run(ctx):
    from pasta_tpu_torch.data.trainsets import TryonTrainDataset
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train import loop
    from pasta_tpu_torch.train.config import TrainConfig

    t = ctx.traffic
    cfg = TrainConfig(**training.train_config(ctx))
    if t["tick_interval"] % cfg.d_reg_interval:
        raise ValueError("a tick must hold whole periods of the lazy R1")
    root = os.path.join(ctx.tmp, "root")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        written = pool.submit(synth.write_root, root, ctx.seed, t["persons"],
                              t["jitter_px"])
        ctx.stamp("imports")
        weights = training.seeded_weights(ctx)
        vgg = VGG19Features().to(ctx.device).requires_grad_(False)
        vgg.load_state_dict(weights["vgg"])
        ctx.stamp("weights")
        written.result()
    seed = training.loop_seed(ctx)
    dataset = TryonTrainDataset(root, seed=seed, resolution=cfg.resolution,
                                loader_impl=cfg.loader_impl)
    ctx.stamp("root")
    rec = training.Recorder(ctx, cfg.batch_size)
    originals = _patched(loop, rec, weights)
    try:
        loop.training_loop(
            cfg, dataset, os.path.join(ctx.tmp, "run"), vgg=vgg,
            tick_interval=t["tick_interval"], snapshot_ticks=2 ** 62,
            num_workers=t["workers"], seed=seed, progress_fn=rec.progress,
            abort_fn=rec.abort, device=ctx.device)
    except training.Stop:
        pass
    finally:
        loop.make_train_step, loop.start_state = originals
    out = Run()
    out.e2e["setup_s"] = rec.t_open - ctx.t_start
    window_s, steps, out.attempted, out.failed, ticks = rec.window(
        t["tick_interval"])
    out.window_s, out.items = window_s, steps
    out.e2e["train_sec_per_kimg"] = window_s / (steps * cfg.batch_size / 1e3)
    out.window_steps = {True: steps // cfg.d_reg_interval}
    out.window_steps[False] = steps - out.window_steps[True]
    out.notes.append(f"window: {steps} steps in {window_s:.3f} s "
                     f"({out.attempted} ticks, {out.failed} failed; each "
                     f"tick's s: {', '.join(f'{x:.3f}' for x in ticks)})")
    out.trace, out.traced_kinds = rec.span, rec.traced_kinds
    ctx.stamp("window")
    tryon.read_peak(out)
    program = rec.side(weights)
    batches, kinds = rec.batches, rec.kinds
    del rec, vgg, dataset
    tryon.release()
    training.check_steps(ctx, out, program, weights, batches, kinds, root,
                         cfg.resolution)
    return out
