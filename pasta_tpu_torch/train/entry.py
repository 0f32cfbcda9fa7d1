"""Process groups and the data-parallel layout, and the multi-rank dry run:
twin of pasta_tpu/train/entry.py.

The JAX package lays the global batch over a 1-D `data` mesh (`make_mesh`,
`shard_batch`) and replicates the state (`replicate`); with more than one
process, process r holds rows [r * b, (r + 1) * b) of the global batch.
The port runs one process per card in a `torch.distributed` process group
(NCCL on cards, gloo on the CPU), rank r with the same rows, its state
broadcast from rank 0; `train/dist.py` holds the step's collectives.

`spawn` pins each rank's fp32 numerics first (`ops/_build.py::
pin_fp32_numerics`): a spawned rank does not inherit the parent's flags.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..ops._build import pin_fp32_numerics

# A rank that builds the kernels or writes a snapshot keeps the others
# waiting at the next collective: far longer than gloo's default 30 s.
TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(rank, world, init_method, device="cuda", backend=None,
                     local_world=None):
    """Join the default process group as `rank` of `world` through
    `init_method` (`file://...` or `tcp://host:port`); returns this rank's
    device. `device="cuda"` puts rank r on card r % the card count, over
    NCCL, which needs a card for each of the `local_world` ranks on this
    host (default: all of them) and raises with fewer: no rank is carried
    on the CPU. `device="cpu"` uses gloo, and the host's ranks share its
    threads. `backend="gloo"` with `device="cuda"` runs gloo on CUDA
    tensors and lets ranks share a card. Ends with a warm-up collective."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    local = world if local_world is None else local_world
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // local))
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0 or (backend == "nccl" and count < local):
            raise RuntimeError(
                f"{local} ranks on this host need {local} CUDA devices over "
                f"NCCL; {count} found")
        device = torch.device("cuda", rank % count)
        torch.cuda.set_device(device)
    # this rank's place among the host's (torchrun's name): the kernels'
    # build (ops/_build.py) runs on the host's first rank alone
    os.environ["LOCAL_RANK"] = str(rank % local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    warmup_collectives(device)
    return device


def warmup_collectives(device):
    """One all-reduce of ones over every rank, checked: the communicators
    exist before the first step (twin of pasta_tpu/cli/train.py::
    _warmup_collectives)."""
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if int(x.item()) != dist.get_world_size():
        raise RuntimeError(f"warm-up all-reduce gave {x.item()}, not "
                           f"{dist.get_world_size()}")


def barrier():
    """Wait for every rank: gloo's monitored barrier, which names a rank
    that does not arrive, or NCCL's barrier on this rank's card; both
    under the process group's long timeout. Nothing without a group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=TIMEOUT)
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def shard_batch(batch, rank, world):
    """Rank `rank`'s contiguous rows [r * b, (r + 1) * b) of each array or
    tensor of a global batch (b = batch / world)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"batch {n} of {k!r} does not divide into "
                             f"{world} ranks")
        b = n // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def _broadcast(tensors, device):
    """Rank 0's values of `tensors` into every rank's, in place: one
    broadcast for each dtype, through a flat buffer on `device`."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group])
        dist.broadcast(flat, 0)
        at = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()


def replicate(state):
    """Rank 0's training state on every rank, in place: the four modules'
    parameters and buffers, the Adam moments and steps, `ada_p`,
    `pl_mean`, the step and the image count. Every rank must hold the same
    structure (the same config; after a resume, the same file). Returns
    the state; nothing happens without a process group."""
    if not dist.is_initialized():
        return state
    device = state.ada_p.device
    tensors = []
    for m in (state.g, state.d, state.dp, state.g_ema):
        tensors += list(m.parameters()) + list(m.buffers())
    for opt in (state.g_opt, state.d_opt, state.dp_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    counters = torch.tensor([state.step, state.cur_nimg], dtype=torch.int64)
    tensors += [state.ada_p, state.pl_mean, counters]
    _broadcast(tensors, device)
    state.step, state.cur_nimg = (int(v) for v in counters.tolist())
    return state


def _pinned_rank(rank, fn, *args):
    pin_fp32_numerics()
    fn(rank, *args)


def spawn(fn, world, *args):
    """Run fn(rank, world, *args) in `world` new processes (spawned: a fresh
    interpreter each, its fp32 numerics pinned first) and wait for all; an
    exception in any rank is raised here."""
    import torch.multiprocessing as mp

    mp.start_processes(_pinned_rank, args=(fn, world) + args, nprocs=world,
                       join=True, start_method="spawn")


def _dryrun_rank(rank, world, init_method, device):
    from .config import smoke_config
    from .state import batch_to, example_batch, init_state
    from .steps import fetch_metrics, make_train_step

    device = init_distributed(rank, world, init_method, device)
    try:
        cfg = smoke_config(world)
        state = replicate(init_state(cfg, seed=0, device=device))
        step = make_train_step(cfg)
        batch = batch_to(shard_batch(
            example_batch(cfg, np.random.RandomState(0)), rank, world),
            device)
        gen = torch.Generator(device=device).manual_seed(1 + rank)
        _, metrics = step(state, batch, gen, do_r1_d=True, do_r1_dp=True)
        metrics = fetch_metrics([metrics])[0]
        if rank == 0:
            print(f"dryrun({world}) OK:",
                  {k: round(v, 4) for k, v in sorted(metrics.items())[:6]},
                  flush=True)
    finally:
        dist.destroy_process_group()


def dryrun(n_ranks, device="cuda"):
    """One full data-parallel training step (G, D, DP, both R1 phases, EMA,
    ADA) at the smoke config over `n_ranks` spawned ranks: on the cards,
    one each, or with `device="cpu"` over gloo (twin of
    pasta_tpu/train/entry.py::dryrun)."""
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dryrun_rank, n_ranks,
              "file://" + os.path.join(tmp, "rendezvous"), device)
