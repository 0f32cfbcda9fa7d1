"""Rank processes for the data-parallel benchmark tests
(tests/test_torch_dist_bench*.py): the plain data-parallel reference
(`benchmark/reference/train/ranks.py`), the port's step against it, and
the port's collectives under a profiler, each in gloo ranks on the CPU.

`run(world, task, payload, tmp_path)` spawns `world` ranks (a `file://`
rendezvous under `tmp_path`), runs TASKS[task](rank, world, payload) in
each and returns the ranks' results in rank order. The module imports
torch and the port only, so that a rank starts fast; the tasks import
the benchmark's reference inside.
"""

from __future__ import annotations

import os
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

from pasta_tpu_torch.train.entry import init_distributed, spawn

# the fashion preset's structure at a width a CPU step takes ~1 s at
NARROW = dict(resolution=64, channel_base=2048, channel_max=128,
              d_reg_interval=2)
CELL = "train512_b4_x4"


def run(world, task, payload, tmp_path):
    out = os.path.join(str(tmp_path), f"ranks-{uuid.uuid4().hex}")
    os.makedirs(out)
    spawn(_rank_main, world, task, payload,
          "file://" + os.path.join(out, "rendezvous"), out)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, task, payload, init_method, out):
    init_distributed(rank, world, init_method, "cpu")
    torch.set_num_threads(2)
    try:
        result = TASKS[task](rank, world, payload)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def context(world, seed, **train):
    """The cell's context on the CPU at the narrow width, `world` ranks
    of 2 rows each (the configuration's numbers otherwise)."""
    from benchmark import harness

    ctx = harness.Context(CELL, seed, 0.01, False, "cpu",
                          time.perf_counter(), None)
    ctx.config["train"].update(NARROW, batch_size=2 * world,
                               data_axis_size=world, **train)
    return ctx


def batches(cfg, n, seed=7):
    """`n` global batches of the training inputs' schema."""
    from pasta_tpu_torch.train.state import example_batch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = example_batch(cfg, rng)
        b["gt_parsing"] = np.round(b["gt_parsing"])
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _rows(batch, rank, world):
    n = batch["real_img"].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def reference_task(rank, world, p):
    """The data-parallel reference's steps (`p["kinds"]`, R1 or not) on this
    rank's rows: its metrics a step and every gradient it applied in the
    first step by (module, leaf)."""
    import types

    from benchmark.lib import training
    from benchmark.reference.train import ranks as reference

    ctx = context(world, p["seed"], **p["train"])
    weights = training.seeded_weights(ctx)
    cfg = types.SimpleNamespace(**training.train_config(ctx))
    grads = {}
    with reference.couple():
        ref = reference.RankTraining(cfg, weights, "cpu")
        gen = torch.Generator().manual_seed(1 + rank)
        metrics = []
        for i, (b, kind) in enumerate(zip(batches(cfg, len(p["kinds"])),
                                          p["kinds"])):
            ref.record = (lambda m, leaf, g: grads.setdefault(
                (m, leaf), []).append(g.clone())) if i == 0 else None
            metrics.append({k: float(v) for k, v in ref.step(
                _rows(b, rank, world), gen, kind).items()})
    return dict(metrics=metrics, grads=grads)


def step_vs_reference_task(rank, world, p):
    """The port's step on this rank's rows (from the benchmark's weights,
    with the loop's rank generator) for `p["kinds"]`, then the cell's
    check of it on this rank and `ranks_apart`."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import TrainConfig
    from pasta_tpu_torch.train.entry import replicate
    from pasta_tpu_torch.train.state import init_state
    from pasta_tpu_torch.train.steps import make_train_step

    from benchmark.lib import ranks, training

    ctx = context(world, p["seed"], **p["train"])
    cfg = TrainConfig(**training.train_config(ctx))
    weights = training.seeded_weights(ctx)
    state = init_state(cfg, seed=0, device="cpu")
    for m in training.MODULES:
        getattr(state, m).load_state_dict(weights[m])
    state.g_ema.load_state_dict(weights["g"])
    state = replicate(state)
    vgg = VGG19Features().requires_grad_(False)
    vgg.load_state_dict(weights["vgg"])
    step = make_train_step(cfg, vgg)
    rec = ranks.RankRecorder(ctx, cfg.batch_size, world)
    gen = torch.Generator().manual_seed(
        (training.loop_seed(ctx) + 1) * world + rank)
    with ranks.planted(p.get("fault"), rank, world):
        for b, kind in zip(batches(cfg, len(p["kinds"])), p["kinds"]):
            rec.step(step, state, _rows(b, rank, world), gen, do_r1_d=kind,
                     do_r1_dp=kind, do_pl=False)
    apart = ranks.ranks_apart(state)
    numbers, _ = ranks.check_rank(ctx, rec.side(weights), weights,
                                  rec.batches, rec.kinds, rank, world)
    return dict(numbers=numbers, ranks_apart=apart)


def traced_step_task(rank, world, p):
    """Two R1 steps of the port at the smoke configuration, the first off
    a profiler, the second under one: the port's
    spans and collective counts after each, and each phase's trained
    parameter count."""
    from torch.profiler import ProfilerActivity, profile

    from pasta_tpu_torch import tracing
    from pasta_tpu_torch.train import dist as tdist
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.entry import replicate
    from pasta_tpu_torch.train.state import (batch_to, example_batch,
                                             init_state)
    from pasta_tpu_torch.train.steps import make_train_step

    cfg = smoke_config(world, mbstd_group_size=4)
    state = replicate(init_state(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg)
    rng = np.random.RandomState(rank)
    gen = torch.Generator().manual_seed(rank)
    out = {}
    for traced, kind in ((False, True), (True, True)):
        batch = batch_to(example_batch(
            smoke_config(1, batch_size=cfg.batch_per_device), rng), "cpu")
        tracing.clear()
        tdist.reset_counts()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                step(state, batch, gen, do_r1_d=kind, do_r1_dp=kind)
        else:
            step(state, batch, gen, do_r1_d=kind, do_r1_dp=kind)
        out[traced] = dict(
            spans=[(s.name, dict(s.attrs)) for s in tracing.snapshot()],
            counts=tdist.counts())
    out["params"] = {m: sum(p.numel() for p in getattr(state, m).parameters())
                     for m in ("g", "d", "dp")}
    return out


TASKS = {"reference": reference_task,
         "step_vs_reference": step_vs_reference_task,
         "traced_step": traced_step_task}
