"""Training orchestration, port of pasta_tpu/train/loop.py (reference
training_loop_fullbody.py:344-789).

Host loop: parallel preprocessing -> upload of the compact raw batch ->
assembly of the step's inputs on the device -> one train step (all phases)
-> periodic status, stats, snapshots and checkpoints.

Nothing in the loop waits for the card between ticks: the step's metrics
stay on the device and are fetched in one transfer a tick, the uploads go
through pinned memory without blocking, and the lazy-R1 cadence is decided
from the step number on the host, and so is Gpl's. The checkpoint carries
the optimizer state, the EMA, ADA's p, Gpl's pl_mean and the step, so a
resume is exact
(`io/checkpoint.py`; a flat .npz of either package resumes too,
`io/npz_ckpt.py`).

Observability: stdout tees into <run_dir>/log.txt, per-tick 3-moment stats
go to stats.jsonl (every step is aggregated), and scalars go to TensorBoard
events when torch.utils.tensorboard is importable.

More than one card (twin of the JAX loop's multi-process path): in a
process group of `cfg.data_axis_size` ranks (`train/entry.py`), rank r
loads its rank-strided share of the index stream, `batch_per_device` items
a step, and trains on them; the state starts as rank 0's (`replicate`),
and the step keeps the ranks' states equal and its metrics global. Rank 0
(the chief) owns all file output: log.txt, stats.jsonl, TensorBoard,
checkpoints; the other ranks print nothing. The sample grid is skipped
with ranks (each holds only its rows), as in the JAX loop. The ranks wait
for each other after the first step of each lazy-phase variant and at the
end of the run.

Not here yet, each coming with the module it needs: the in-training
evaluator (`eval_metrics`, `eval_ticks`, `eval_items`, `detector_params`,
`metric_cache_dir`: the metrics and their detectors) and the cross-pair
try-on grid (`tryon_grid_k`: the test-mode preprocessing).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import PIL.Image
import torch

from ..data.trainsets import (TryonTrainDataset, assemble_train_batch,
                              assemble_train_batch_lean,
                              batch_to_lean_inputs, batch_to_raw_inputs)
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.npz_ckpt import load_npz_state
from ..summary import summarize_state
from . import dist as tdist
from .config import TrainConfig
from .entry import barrier, replicate
from .state import init_state
from .stats import Collector, JsonlLogger, Tee
from .steps import fetch_metrics, make_train_step


class ParallelLoader:
    """Background-thread batch producer over a thread pool.

    The reference relies on torch DataLoader worker processes feeding an
    InfiniteSampler (training_loop_fullbody.py:392-394, misc.py:115-146);
    this is the JAX package's loader: a rank-strided windowed-shuffle index
    stream (data/sampler.py) drained by a thread pool (cv2 and the decoders
    release the GIL). The dataset's one RandomState is shared by the pool's
    threads, so only num_workers=1 gives a repeatable stream of draws.
    """

    def __init__(self, dataset, batch_size, num_workers=8, seed=0,
                 rank=0, num_replicas=1, shuffle=True, window_size=0.5,
                 holdout=0):
        from ..data.sampler import infinite_sampler

        self.dataset = dataset
        self.lean = getattr(dataset, "loader_impl", "host") == "device"
        self._get = dataset.lean_item if self.lean else dataset.__getitem__
        self.batch_size = batch_size
        self.sampler = infinite_sampler(
            len(dataset), rank=rank, num_replicas=num_replicas,
            shuffle=shuffle, seed=seed, window_size=window_size,
            skip_first=holdout)
        self.pool = concurrent.futures.ThreadPoolExecutor(num_workers)
        self._pending = []

    def _submit(self):
        idxs = [next(self.sampler) for _ in range(self.batch_size)]
        return [self.pool.submit(self._get, int(i)) for i in idxs]

    def __iter__(self):
        # keep two batches in flight; yield COMPACT raw batches (uint8):
        # the training loop expands them on the device
        # (assemble_train_batch), so the host->device upload is ~6x smaller
        # than shipping the assembled float32 inputs. The device loader
        # (lean) ships only raw planes + scalars and yields
        # (batch, tiled, windowed).
        self._pending = [self._submit(), self._submit()]
        while True:
            futs = self._pending.pop(0)
            self._pending.append(self._submit())
            items = [f.result() for f in futs]
            yield (batch_to_lean_inputs(items) if self.lean
                   else batch_to_raw_inputs(items))

    def close(self):
        """Drop the batches in flight and stop the pool's threads."""
        for futs in self._pending:
            for f in futs:
                f.cancel()
        self._pending = []
        self.pool.shutdown(wait=True)


def lazy_phases(cfg, step):
    """(do_r1_d, do_pl) of `step`: the lazy R1 phases every d_reg_interval
    steps, Gpl every g_reg_interval steps (pasta_tpu/train/loop.py), each
    only where its weight is not 0. Decided on the host, from the step
    number alone."""
    return (cfg.r1_gamma != 0 and step % cfg.d_reg_interval == 0,
            cfg.pl_weight != 0 and step % cfg.g_reg_interval == 0)


def upload_batch(batch_np, device):
    """A loader's numpy batch -> tensors on `device`, float64 as float32
    (what `jnp.asarray` makes of it in the JAX loop). On the card each
    array goes through pinned memory with a non-blocking copy, so the host
    does not wait for the transfer."""
    device = torch.device(device)
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(np.asarray(v))
        if t.dtype == torch.float64:
            t = t.float()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def save_image_grid(images, path, drange=(-1, 1), grid_cols=None,
                    side_images=None, top_images=None, border=4):
    """[N, H, W, 3] -> one PNG grid (training_loop_fullbody.py:313-340).

    side_images ([rows, H, W, 3]) / top_images ([cols, H, W, 3]) prepend the
    source person column / source garment row with a `border`-px white
    gutter — the reference's image_side/image_top bordered snapshot layout.
    Sources share `drange` with the cells."""
    n, h, w, _ = images.shape
    cols = grid_cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    lo, hi = drange

    def to_u8(x):
        x = (np.asarray(x, np.float32) - lo) * 255 / (hi - lo)
        return np.clip(x, 0, 255).astype(np.uint8)

    img = to_u8(images)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img[i]
    if side_images is not None:
        side = to_u8(side_images)
        col = np.zeros((rows * h, w, 3), np.uint8)
        for r in range(min(rows, len(side))):
            col[r * h:(r + 1) * h] = side[r]
        gutter = np.full((rows * h, border, 3), 255, np.uint8)
        grid = np.concatenate([col, gutter, grid], axis=1)
    if top_images is not None:
        top = to_u8(top_images)
        lead = (w + border) if side_images is not None else 0
        row = np.full((h, lead + cols * w, 3), 255, np.uint8)
        for c in range(min(cols, len(top))):
            row[:, lead + c * w:lead + (c + 1) * w] = top[c]
        gutter = np.full((border, row.shape[1], 3), 255, np.uint8)
        grid = np.concatenate([row, gutter, grid], axis=0)
    PIL.Image.fromarray(grid).save(path)


def training_loop(
    cfg: TrainConfig,
    dataset: TryonTrainDataset,
    run_dir: str,
    vgg=None,
    resume_path: Optional[str] = None,
    total_steps: Optional[int] = None,
    tick_interval: int = 50,
    snapshot_ticks: int = 10,
    num_workers: int = 8,
    seed: int = 0,
    progress_fn=None,
    abort_fn=None,
    device="cuda",
):
    """Train on `device` (the card unless the caller asks for the CPU);
    returns the final TrainState. `vgg`: a VGG19Features module on that
    device for the perceptual loss, or None to run without it.

    In a process group, every rank calls this with the same arguments and
    its own card; only rank 0 writes into `run_dir` (the others may pass
    None), and `abort_fn` must answer alike on every rank."""
    world = tdist.world_size()
    if world != cfg.data_axis_size:
        raise ValueError(f"TrainConfig.data_axis_size={cfg.data_axis_size} "
                         f"but the process group holds {world} ranks")
    stream = sys.stdout
    if tdist.rank() == 0:
        os.makedirs(run_dir, exist_ok=True)
        sys.stdout = Tee(stream, os.path.join(run_dir, "log.txt"))
    else:
        sys.stdout = open(os.devnull, "w")
    try:
        return _training_loop_impl(
            cfg, dataset, run_dir, vgg, resume_path, total_steps,
            tick_interval, snapshot_ticks, num_workers, seed, progress_fn,
            abort_fn, torch.device(device))
    finally:
        sys.stdout.close()
        sys.stdout = stream


def _training_loop_impl(
    cfg, dataset, run_dir, vgg, resume_path, total_steps, tick_interval,
    snapshot_ticks, num_workers, seed, progress_fn, abort_fn, device,
):
    rank, world = tdist.rank(), tdist.world_size()
    is_chief = rank == 0
    print(f"fp32 numerics: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    state = start_state(cfg, seed, device, resume_path)
    summarize_state(state)  # startup accounting (misc.py:201-269 analogue)
    if resume_path is not None and cfg.ema_rampup is not None:
        # The reference speeds up ADA adaptation and disables the EMA rampup
        # on resume (train.py:340-342); the checkpoint restores ada_p and the
        # step exactly, so only the rampup disable applies.
        cfg = dataclasses.replace(cfg, ema_rampup=None)

    train_step = make_train_step(cfg, vgg)
    loader = ParallelLoader(dataset, cfg.batch_per_device, num_workers, seed,
                            rank=rank, num_replicas=world)
    batches = iter(loader)
    logger = JsonlLogger(run_dir) if is_chief else None
    collector = Collector()
    tb_writer = _make_tb_writer(run_dir) if is_chief else None

    if total_steps is None:
        total_steps = cfg.total_kimg * 1000 // cfg.batch_size

    # each rank its own draws (the reference's seed * num_gpus + rank)
    generator = torch.Generator(device=device).manual_seed(
        (seed + 1) * world + rank)
    variants = set()
    start_step = state.step
    t_tick = time.time()
    images_at_tick = start_step * cfg.batch_size
    step_metrics = []  # device-side; fetched once per tick (no per-step sync)

    lean_loader = getattr(dataset, "loader_impl", "host") == "device"
    try:
        loaded = next(batches) if start_step < total_steps else None
        for step in range(start_step, total_steps):
            with torch.no_grad():
                if lean_loader:
                    batch_np, tiled, _ = loaded
                    batch = assemble_train_batch_lean(
                        upload_batch(batch_np, device), tiled=tiled)
                else:
                    batch = assemble_train_batch(
                        upload_batch(loaded, device))
            # Take the next batch now and not at the top of the next step:
            # taking one hands the pool its next items, and its threads
            # then share the interpreter lock with the queueing of this
            # step, during which the card has work, and not with the
            # upload and assembly above, during which it has none.
            if step + 1 < total_steps:
                loaded = next(batches)
            do_r1_d, do_pl = lazy_phases(cfg, step)
            state, metrics = train_step(state, batch, generator,
                                        do_r1_d=do_r1_d, do_r1_dp=do_r1_d,
                                        do_pl=do_pl)
            step_metrics.append(metrics)
            if world > 1 and (do_r1_d, do_pl) not in variants:
                # the first step of a variant builds what it needs (the
                # kernels, at the very first) at each rank's own pace
                variants.add((do_r1_d, do_pl))
                barrier()

            if (step + 1) % tick_interval == 0 or step == total_steps - 1:
                # the step's metrics are already global (every rank's mean)
                for m in fetch_metrics(step_metrics):
                    collector.report(m)
                step_metrics.clear()
                cur_nimg = (step + 1) * cfg.batch_size
                dt = time.time() - t_tick
                sec_per_kimg = dt / max(
                    (cur_nimg - images_at_tick) / 1000, 1e-9)
                print(
                    f"tick step {step + 1:<7d} kimg {cur_nimg / 1000:<10.1f} "
                    f"sec/kimg {sec_per_kimg:<8.1f} "
                    f"g_loss {collector.mean('g_loss'):.3f} "
                    f"d_loss {collector.mean('d_loss'):.3f} "
                    f"augment p {collector.mean('ada_p'):.3f}",
                    flush=True)
                row = {"step": step + 1, "kimg": cur_nimg / 1000,
                       "sec_per_kimg": sec_per_kimg, **collector.as_dict()}
                if logger is not None:
                    logger.write(row)
                if tb_writer is not None:
                    for name, val in row.items():
                        if isinstance(val, dict):
                            tb_writer.add_scalar(
                                f"Train/{name}", val["mean"], step + 1)
                        elif isinstance(val, (int, float)) and name != "step":
                            tb_writer.add_scalar(
                                f"Train/{name}", val, step + 1)
                    tb_writer.flush()
                collector.reset()
                t_tick = time.time()
                images_at_tick = cur_nimg

                tick_idx = (step + 1) // tick_interval
                if is_chief and (tick_idx % snapshot_ticks == 0
                                 or step == total_steps - 1):
                    # with ranks, no sample grid: each holds only its rows
                    _save_snapshot(state, batch if world == 1 else None,
                                   run_dir, step + 1)
                if progress_fn is not None:
                    progress_fn(cur_nimg, cfg.total_kimg * 1000)
                if abort_fn is not None and abort_fn():
                    break
    finally:
        loader.close()
        if logger is not None:
            logger.close()
        if tb_writer is not None:
            tb_writer.close()
    barrier()   # the chief's last snapshot is written
    return state


def start_state(cfg, seed, device, resume_path=None):
    """The state a run starts from: `init_state` on `device`, restored from
    `resume_path` (a `.pt` of this package or a flat `.npz` of either; every
    rank reads it), then rank 0's on every rank (`replicate`)."""
    state = init_state(cfg, seed=seed, device=device)
    if resume_path is not None:
        if resume_path.endswith(".npz"):
            load_npz_state(resume_path, state)
        else:
            load_checkpoint(resume_path, state)
    return replicate(state)


def _make_tb_writer(run_dir):
    """TensorBoard scalars, when available (training_loop_fullbody.py:422-427
    guarded-import semantics)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=run_dir)
    except Exception as e:  # pragma: no cover - depends on environment
        print(f"skipping tfevents export: {e}", flush=True)
        return None


def _save_snapshot(state, batch, run_dir, step):
    """EMA-generator sample grid + full-state checkpoint; the checkpoint
    alone when `batch` is None."""
    from ..data.cihp import parsing2im

    ckpt = os.path.join(run_dir, f"ckpt-{step:06d}.pt")
    if batch is None:
        save_checkpoint(ckpt, state)
        print(f"snapshot: {ckpt}", flush=True)
        return
    n_vis = min(8, batch["real_img"].shape[0])
    sub = {k: v[:n_vis] for k, v in batch.items()}
    with torch.no_grad():
        _, finetune, parsing = state.g_ema(
            torch.zeros((n_vis, 0), device=sub["real_img"].device),
            sub["style_input"], sub["retain"], sub["pose"],
            sub["denorm_upper_input"], sub["denorm_lower_input"],
            sub["denorm_upper_mask"], sub["denorm_lower_mask"],
            noise_mode="const")
        parsing_idx = parsing.argmax(dim=-1)
    fakes = finetune.float().cpu().numpy()
    parsing_idx = parsing_idx.cpu().numpy()
    reals = sub["real_img"].cpu().numpy()
    save_image_grid(
        np.concatenate([reals, fakes], axis=0),
        os.path.join(run_dir, f"fakes{step:06d}.png"), grid_cols=n_vis)
    # Predicted-parsing snapshot grids (training_loop_fullbody.py:709-719
    # fakes*_parsing.png): the reference's grayscale index/6 encoding, plus
    # a CIHP-colormapped twin (util_functions.py parsing2im semantics).
    gray = (parsing_idx.astype(np.float32) / 6.0 * 2.0 - 1.0)[..., None]
    save_image_grid(
        np.repeat(gray, 3, axis=-1),
        os.path.join(run_dir, f"fakes{step:06d}_parsing.png"),
        grid_cols=n_vis)
    color = np.stack([parsing2im(p) for p in parsing_idx])
    save_image_grid(
        color, os.path.join(run_dir, f"fakes{step:06d}_parsing_color.png"),
        drange=(0, 255), grid_cols=n_vis)
    save_checkpoint(ckpt, state)
    print(f"snapshot: fakes{step:06d}.png + {ckpt}", flush=True)
