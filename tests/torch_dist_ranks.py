"""Rank processes for the data-parallel tests (tests/test_torch_dist*.py).

`run(world, task, payload, tmp_path)` spawns `world` gloo ranks on the
CPU (a `file://` rendezvous under `tmp_path`: the test workers run side by
side, and TCP ports could collide), runs TASKS[task](rank, world,
payload) in each and returns the ranks' results in rank order. The module
imports torch and the port only, so that a rank starts fast.
"""

from __future__ import annotations

import os
import uuid

import numpy as np
import torch
import torch.distributed as dist

from pasta_tpu_torch.train.entry import (init_distributed, replicate,
                                         shard_batch, spawn)


def run(world, task, payload, tmp_path):
    tag = uuid.uuid4().hex
    out = os.path.join(str(tmp_path), f"ranks-{tag}")
    os.makedirs(out)
    spawn(_rank_main, world, task, payload,
          "file://" + os.path.join(out, "rendezvous"), out)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, task, payload, init_method, out):
    init_distributed(rank, world, init_method, "cpu")
    torch.set_num_threads(1)
    try:
        result = TASKS[task](rank, world, payload)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _numpy(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def step_task(rank, world, p):
    """One train step of `p["cfg"]` from the state dicts in `p["state"]`
    on this rank's rows of `p["batch"]`; the step's metrics, the four
    modules' state dicts, ada_p, pl_mean."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.state import batch_to, init_state
    from pasta_tpu_torch.train.steps import fetch_metrics, make_train_step

    cfg = p["cfg"]
    st = init_state(cfg, seed=0, device="cpu")
    for name, sd in p["state"].items():
        getattr(st, name).load_state_dict(
            {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
            strict=True)
    if rank != 0:       # replicate must bring rank 0's state here
        with torch.no_grad():
            for prm in st.g.parameters():
                prm.add_(1.0)
    st.pl_mean = torch.tensor(p.get("pl_mean", 0.0))
    st = replicate(st)
    vgg = None
    if p.get("vgg") is not None:
        vgg = VGG19Features(seed=3).requires_grad_(False)
        vgg.load_state_dict({k: torch.from_numpy(v)
                             for k, v in p["vgg"].items()}, strict=True)
    step = make_train_step(cfg, vgg)
    batch = batch_to(shard_batch(p["batch"], rank, world), "cpu")
    kw = dict(p.get("kw", {}))
    if p.get("pl_noise") is not None:
        kw["pl_noise"] = torch.from_numpy(
            shard_batch({"n": p["pl_noise"]}, rank, world)["n"])
    st, metrics = step(st, batch, torch.Generator().manual_seed(3 + rank),
                       **kw)
    return dict(metrics=fetch_metrics([metrics])[0],
                **{name: _numpy(getattr(st, name))
                   for name in ("g", "d", "dp", "g_ema")},
                ada_p=float(st.ada_p), pl_mean=float(st.pl_mean),
                step=st.step, cur_nimg=st.cur_nimg)


def _grads(layer, x, wy, v):
    """The layer's output on x, d sum(y * wy) / dx and d sum(that * v) /
    dx (R1's second order)."""
    x = x.clone().requires_grad_(True)
    y = layer(x)
    (gx,) = torch.autograd.grad((y * wy).sum(), x, create_graph=True)
    (ggx,) = torch.autograd.grad((gx * v).sum(), x)
    return y.detach().numpy(), gx.detach().numpy(), ggx.numpy()


def mbstd_task(rank, world, p):
    """MinibatchStdLayer at each group size of `p["groups"]` on this rank's
    rows of p["x"]: output, gradient and gradient of the gradient, each
    rank's rows."""
    from pasta_tpu_torch.nn.layers import MinibatchStdLayer

    rows = shard_batch({k: torch.from_numpy(p[k]) for k in ("x", "wy", "v")},
                       rank, world)
    return {g: _grads(MinibatchStdLayer(g, p["channels"]), rows["x"],
                      rows["wy"], rows["v"]) for g in p["groups"]}


def reductions(p):
    """Sites 2-4 on the arrays of `p` (this rank's rows, or the global
    batch in one process): Gpl's penalty and pl_mean, the parsing CE, the
    contextual distance; each value with its gradient."""
    from pasta_tpu_torch.losses.contextual import contextual_distance
    from pasta_tpu_torch.losses.parsing import weighted_parsing_ce
    from pasta_tpu_torch.train.steps import pl_penalty

    out = {}
    lengths = torch.from_numpy(p["pl_lengths"]).requires_grad_(True)
    penalty, pl_mean = pl_penalty(lengths, torch.tensor(p["pl_mean"]), 0.01)
    (g,) = torch.autograd.grad(penalty, lengths)
    out["pl"] = (penalty.item(), pl_mean.item(), g.numpy())
    logits = torch.from_numpy(p["logits"]).requires_grad_(True)
    ce = weighted_parsing_ce(logits, torch.from_numpy(p["targets"]))
    (g,) = torch.autograd.grad(ce, logits)
    out["ce"] = (ce.item(), g.numpy())
    x = torch.from_numpy(p["x_feat"]).requires_grad_(True)
    cx = contextual_distance(x, torch.from_numpy(p["y_feat"]))
    (g,) = torch.autograd.grad(cx, x)
    out["cx"] = (cx.item(), g.numpy())
    return out


def reductions_task(rank, world, p):
    keys = ("pl_lengths", "logits", "targets", "x_feat", "y_feat")
    rows = shard_batch({k: p[k] for k in keys}, rank, world)
    return reductions(dict(p, **rows))


def start_task(rank, world, p):
    """The training loop's starting state on this rank, resumed from
    `p["resume"]`: the modules' and the Adams' state dicts, the scalars."""
    from pasta_tpu_torch.train.loop import start_state

    st = start_state(p["cfg"], 0, "cpu", p["resume"])
    out = {name: _numpy(getattr(st, name))
           for name in ("g", "d", "dp", "g_ema")}
    for name in ("g_opt", "d_opt", "dp_opt"):
        opt = getattr(st, name).state_dict()["state"]
        out[name] = {(i, k): v.numpy().copy() for i, s in opt.items()
                     for k, v in s.items()}
    out.update(step=st.step, cur_nimg=st.cur_nimg, ada_p=float(st.ada_p),
               pl_mean=float(st.pl_mean))
    return out


def numerics_task(rank, world, p):
    """The fp32 flags this spawned rank runs with."""
    return dict(cudnn=torch.backends.cudnn.allow_tf32,
                matmul=torch.backends.cuda.matmul.allow_tf32)


TASKS = dict(step=step_task, mbstd=mbstd_task, reductions=reductions_task,
             start=start_task, numerics=numerics_task)
