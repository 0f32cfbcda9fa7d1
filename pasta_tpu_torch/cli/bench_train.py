"""Time the training step of the fashion preset on one NVIDIA GPU.

Twin of scripts/bench_train.py for the port: builds the preset
(`TrainConfig` defaults at full widths; seeded random G, D, parsing D and
VGG19 weights; a seeded random batch with the training schema), runs one
warm-up step, then `--steps` regular steps and one lazy-R1 step
(do_r1_d and do_r1_dp), each timed with CUDA events and the host clock
(no step waits for the card; each timed run ends in one device sync and
fetches its metrics there). Prints s/step, sec/kimg, the peak device memory and the kernels'
launch counts, ADA's geometric stage (two-pass against the gather oracle)
and that stage's parts, each timed alone; `--profile` adds a torch.profiler
breakdown of one regular step (device idle share, kernel time by name).
TF32 is off.

`--devices N` (N > 1) times the data-parallel step instead: N processes,
one card each, in an NCCL process group (train/entry.py), each with
`--batch` rows of the global batch of N x `--batch` and the state
broadcast from rank 0. Each rank runs a warm-up step, `--steps` regular
steps and one R1 step, timed as above, and times each phase's gradient
all-reduce (train/dist.py::reduce_phase) with CUDA events around it: from
the phase's gradients queued on this rank to the reduced buffer, which
includes the wait for the slowest rank. Prints per rank s/step, sec/kimg
of the global batch, the all-reduce ms and MB per phase, the peak device
memory and the launches per step, and one JSON line of them all.

Run from the repository root:
    python3 -m pasta_tpu_torch.cli.bench_train [--batch 4] [--steps 3]
        [--res 512] [--skip-r1] [--no-vgg] [--profile] [--devices N]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOP_KERNELS = 25


def kernel_counts():
    """(K1 forward, K1 dX, K2, K3) launch counts."""
    from pasta_tpu_torch.ops import affine_warp, conv3x3

    return (conv3x3.conv3x3_valid.launches,
            conv3x3.conv3x3_valid.launches_bwd,
            affine_warp.shift_fwd.launches, affine_warp.shift_bwd.launches)


def reset_kernel_counts():
    from pasta_tpu_torch.ops import affine_warp, conv3x3

    conv3x3.conv3x3_valid.launches = 0
    conv3x3.conv3x3_valid.launches_bwd = 0
    conv3x3.conv3x3_valid.launches_fp32 = 0
    affine_warp.shift_fwd.launches = 0
    affine_warp.shift_bwd.launches = 0


def setup(cfg, device, seed=0, use_vgg=True):
    """(state, train_step, batch, generator) for `cfg` on `device`; in a
    process group, this rank's rows of the batch, rank 0's state and a
    generator of its own."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.dist import rank, world_size
    from pasta_tpu_torch.train.entry import replicate, shard_batch
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import make_train_step

    state = replicate(init_state(cfg, seed=seed, device=device))
    vgg = None
    if use_vgg and cfg.vgg_weight > 0:
        vgg = VGG19Features(seed=seed + 3).to(device).requires_grad_(False)
    step = make_train_step(cfg, vgg)
    batch = batch_to(shard_batch(example_batch(
        cfg, np.random.RandomState(seed)), rank(), world_size()), device)
    generator = torch.Generator(device=device).manual_seed(seed + rank())
    return state, step, batch, generator


def timed_steps(step, state, batch, generator, n, do_r1=False):
    """n steps; returns (host s/step, CUDA-event s/step, [metrics of each
    step], fetched once at the end)."""
    from pasta_tpu_torch.train.steps import fetch_metrics

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    metrics = [step(state, batch, generator, do_r1_d=do_r1,
                    do_r1_dp=do_r1)[1] for _ in range(n)]
    b.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n
    return host, a.elapsed_time(b) / 1e3 / n, fetch_metrics(metrics)


# the phases whose gradients one step all-reduces, in order
PHASES = ("Gmain", "Dmain", "DPmain")
R1_PHASES = PHASES + ("Dr1", "DPr1")


@contextlib.contextmanager
def timed_reductions():
    """Inside, every phase's all-reduce (train/dist.py::reduce_phase) is
    timed by two CUDA events around it; yields the list that receives
    (values reduced, start event, end event) of each."""
    from pasta_tpu_torch.train import dist as tdist

    original = tdist.reduce_phase
    record = []

    def timed(grads, metrics, phase=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = original(grads, metrics, phase)
        b.record()
        record.append((sum(g.numel() for g in grads), a, b))
        return out

    tdist.reduce_phase = timed
    try:
        yield record
    finally:
        tdist.reduce_phase = original


def rank_bench(cfg, steps, device, use_vgg=True):
    """This rank's data-parallel step at `cfg`, on its card: a warm-up
    step, `steps` timed regular steps and one R1 step (the ranks start
    each run together). Returns its times, all-reduce ms and MB per phase,
    peak GiB, launches per step and metrics."""
    from pasta_tpu_torch.train.dist import rank
    from pasta_tpu_torch.train.entry import barrier

    state, step, batch, gen = setup(cfg, device, use_vgg=use_vgg)
    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with timed_reductions() as record:
        barrier()
        host, dev, metrics = timed_steps(step, state, batch, gen, steps)
        counts = kernel_counts()
        reset_kernel_counts()
        n_regular = len(record)
        barrier()
        host_r1, dev_r1, (metrics_r1,) = timed_steps(step, state, batch, gen,
                                                     1, do_r1=True)
        counts_r1 = kernel_counts()
    if n_regular != steps * len(PHASES) \
            or len(record) - n_regular != len(R1_PHASES):
        raise RuntimeError(f"bench_train: {len(record)} all-reduces over "
                           f"{steps} regular steps and one R1 step")
    ms = [a.elapsed_time(b) for _, a, b in record]
    mb = [n * 4 / 1e6 for n, _, _ in record]
    regular = {p: sum(ms[i::len(PHASES)][:steps]) / steps
               for i, p in enumerate(PHASES)}
    return dict(
        rank=rank(), card=torch.cuda.get_device_name(), warm_s=warm,
        s_per_step=host, s_per_step_events=dev,
        sec_per_kimg=host * 1000 / cfg.batch_size, r1_s=host_r1,
        r1_s_events=dev_r1, allreduce_ms=regular,
        allreduce_mb={p: mb[i] for i, p in enumerate(PHASES)},
        r1_allreduce_ms=dict(zip(R1_PHASES, ms[n_regular:])),
        r1_allreduce_mb=dict(zip(R1_PHASES, mb[n_regular:])),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=[c / steps for c in counts], launches_r1=list(counts_r1),
        metrics=metrics[-1], metrics_r1=metrics_r1)


def _bench_rank(rank, world, opts, init_method, out):
    import torch.distributed as dist

    from pasta_tpu_torch.train.config import fashion_config
    from pasta_tpu_torch.train.entry import init_distributed

    device = init_distributed(rank, world, init_method, "cuda")
    try:
        cfg = fashion_config(batch_size=opts["batch"] * world,
                             data_axis_size=world, resolution=opts["res"])
        res = rank_bench(cfg, opts["steps"], device, opts["use_vgg"])
        results = [None] * world
        dist.all_gather_object(results, res)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def bench_ranks(world, batch=4, steps=3, res=512, use_vgg=True):
    """`rank_bench` on `world` spawned ranks, one card each (NCCL), at the
    fashion preset with `batch` rows a rank; the ranks' results in rank
    order."""
    from pasta_tpu_torch.train.entry import spawn

    if torch.cuda.device_count() < world:
        raise RuntimeError(f"bench_train: {world} ranks need {world} CUDA "
                           f"devices, {torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.json")
        spawn(_bench_rank, world, dict(batch=batch, steps=steps, res=res,
                                       use_vgg=use_vgg),
              "file://" + os.path.join(tmp, "rendezvous"), out)
        with open(out) as f:
            return json.load(f)


def print_ranks(results, batch):
    """One line a rank, then one JSON line of them all."""
    world = len(results)
    for r in results:
        print(f"[ranks {world}] rank {r['rank']} ({r['card']}): regular "
              f"{r['s_per_step']:.4f} s/step host, {r['s_per_step_events']:.4f}"
              f" CUDA events, {r['sec_per_kimg']:.1f} sec/kimg of the global "
              f"batch {batch * world} | R1 step {r['r1_s']:.4f} s | "
              f"all-reduce ms (MB) "
              + ", ".join(f"{p} {r['allreduce_ms'][p]:.3f} "
                          f"({r['allreduce_mb'][p]:.1f})" for p in PHASES)
              + " | R1 step " + ", ".join(
                  f"{p} {v:.3f}" for p, v in r["r1_allreduce_ms"].items())
              + f" | peak {r['peak_gib']:.2f} GiB | launches per step K1 "
              f"fwd/dX, K2, K3 {r['launches']}, R1 step {r['launches_r1']}",
              flush=True)
    print(json.dumps({"ranks": world, "batch_per_rank": batch,
                      "results": results}), flush=True)


def _event_ms(fn, iters):
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


def geom_stage(n, res, device="cuda", seed=0, iters=5):
    """ADA's geometric stage on n res^2 images under a 30-degree rotation,
    forward and backward: the two-pass warp (bf16, K2 and K3) against the
    gather oracle (fp32 reflect pad, FIR upsample, bilinear gather, FIR
    downsample: the JAX package's impl='gather'). The images are smooth
    (bilinear upsampling of 16x coarser noise, in [-1, 1]): the two
    resamplers interpolate differently, which white noise would make
    the whole of the difference. Returns (two-pass ms, gather ms, PSNR of
    the two-pass output against the gather's in dB for the [-1, 1]
    range)."""
    from pasta_tpu_torch.ops import downsample2d, setup_filter, upsample2d
    from pasta_tpu_torch.ops.affine_warp import (bilinear_warp_gather,
                                                 geom_resample_twopass)
    from pasta_tpu_torch.train.augment import WAVELETS

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.rand(n, 3, res // 16, res // 16, device=dev, generator=g)
    x = (torch.nn.functional.interpolate(coarse, size=(res, res),
                                         mode="bilinear", align_corners=False)
         * 2 - 1).permute(0, 2, 3, 1).contiguous()
    ct = torch.randn(n, res, res, 3, device=dev, generator=g)
    f = setup_filter(WAVELETS["sym6"]).to(dev)
    m = len(WAVELETS["sym6"]) // 4 * 2
    c = ((res + 2 * m) * 2 - 1) / 2
    th = np.pi / 6
    mat = (np.array([[1, 0, c], [0, 1, c], [0, 0, 1]])
           @ np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
           @ np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1]]))
    mat = torch.tensor(mat, dtype=torch.float32, device=dev).expand(n, 3, 3)

    def twopass(a):
        return geom_resample_twopass(a.to(torch.bfloat16), mat,
                                     f.cpu().numpy(), m).float()

    def gather(a):
        p = torch.nn.functional.pad(a.permute(0, 3, 1, 2), (m, m, m, m),
                                    mode="reflect").permute(0, 2, 3, 1)
        up = bilinear_warp_gather(upsample2d(p, f, up=2), mat)
        return downsample2d(up, f, down=2, padding=-m * 2, flip_filter=True)

    def fwd_bwd(fn):
        a = x.clone().requires_grad_(True)
        torch.autograd.grad(fn(a), a, ct)

    with torch.no_grad():
        mse = (twopass(x) - gather(x)).square().mean().item()
    times = {}
    for fn in (twopass, gather, gather, twopass):
        times.setdefault(fn.__name__, []).append(
            _event_ms(lambda: fwd_bwd(fn), iters))
    return (sum(times["twopass"]) / 2, sum(times["gather"]) / 2,
            10 * np.log10(4.0 / max(mse, 1e-30)))


def geom_breakdown(n, res, device="cuda", seed=0, iters=5):
    """Where the two-pass geometric stage's time goes: CUDA-event times of
    its parts, each replayed alone on the tensors one real forward hands it
    (captured by wrapping `_resample_matrix` and `_row_shift` for that one
    call; the stage's code is not changed). Forward + backward where a
    gradient flows through the part, forward alone where none does (the
    resample matrices, the row positions). Returns (whole stage ms by
    events, whole stage ms by the host clock, [(part, ms)], (device
    kernels of one profiled forward + backward, their busy ms, their span
    ms))."""
    from pasta_tpu_torch.ops import affine_warp as aw
    from pasta_tpu_torch.ops import setup_filter
    from pasta_tpu_torch.train.augment import WAVELETS

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, res, res, 3, device=dev, generator=g) * 2 - 1
    taps = setup_filter(WAVELETS["sym6"]).numpy()
    m = len(WAVELETS["sym6"]) // 4 * 2
    c = ((res + 2 * m) * 2 - 1) / 2
    th = np.pi / 6
    mat = (np.array([[1, 0, c], [0, 1, c], [0, 0, 1]])
           @ np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
           @ np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1]]))
    mat = torch.tensor(mat, dtype=torch.float32, device=dev).expand(n, 3, 3)
    bf16 = torch.bfloat16

    def stage(a):
        return aw.geom_resample_twopass(a.to(bf16), mat, taps, m).float()

    # one forward with the two inner functions wrapped to keep their inputs
    matrices, shifts = [], []
    resample_matrix, row_shift = aw._resample_matrix, aw._row_shift

    def keep_matrix(*args):
        matrices.append(args)
        return resample_matrix(*args)

    def keep_shift(wide, q, out_w):
        shifts.append((wide.detach(), q.detach(), out_w))
        return row_shift(wide, q, out_w)

    aw._resample_matrix, aw._row_shift = keep_matrix, keep_shift
    try:
        with torch.no_grad():
            stage(x)
    finally:
        aw._resample_matrix, aw._row_shift = resample_matrix, row_shift
    npad = res + 2 * m
    side = 2 * npad
    v_dim = shifts[0][0].shape[1]
    u = torch.from_numpy(aw._upsample_matrix(taps, npad)).to(dev, bf16)
    d = torch.from_numpy(aw._downsample_matrix(
        taps, side, extra_pad=-2 * m)).to(dev, bf16)
    b1, b2 = (resample_matrix(*args) for args in matrices)
    plane = torch.randn(n, 3, side, side, device=dev, generator=g).to(bf16)
    swap = torch.arange(n, device=dev) % 2 == 0
    pad = torch.nn.functional.pad

    def fwd_bwd(fn, a):
        def run():
            leaf = a.clone().requires_grad_(True)
            out = fn(leaf)
            torch.autograd.grad(out, leaf, torch.ones_like(out))
        return run

    def prep_plain():
        for wide, q, out_w in shifts:
            base, rem, _ = aw._shift_prep(q, out_w, v_dim)
            aw._row_start(base, rem)

    def k2():
        for wide, q, out_w in shifts:
            aw.shift_fwd(wide, q, out_w)

    k3_douts = [(w[:, :ow].contiguous(), q) for w, q, ow in shifts]

    def k3():
        for dout, q in k3_douts:
            aw.shift_bwd(dout, q, v_dim)

    parts = [
        ("cast to bf16 and back (fwd + bwd)",
         fwd_bwd(lambda a: a.to(bf16).float(), x)),
        ("reflect pad + 2 FIR upsample matmuls (fwd + bwd)",
         fwd_bwd(lambda a: torch.matmul(u, torch.matmul(
             pad(a.permute(0, 3, 1, 2), (m, m, m, m), mode="reflect"),
             u.t())), x.to(bf16))),
        ("quarter turn: transpose, flip, torch.where (fwd + bwd)",
         fwd_bwd(lambda a: torch.where(swap[:, None, None, None],
                                       a.transpose(2, 3).flip(2), a), plane)),
        ("_resample_matrix x2 (fwd; no gradient flows)",
         lambda: [resample_matrix(*args) for args in matrices]),
        ("resample matmul, pass 1 (fwd + bwd)",
         fwd_bwd(lambda a: torch.matmul(a, b1[:, None]), plane)),
        ("resample matmul, pass 2, on the transposed view (fwd + bwd)",
         fwd_bwd(lambda a: torch.matmul(a.transpose(2, 3), b2[:, None]),
                 plane)),
        ("  the same on a contiguous input (the difference is the "
         "transpose's copy)",
         fwd_bwd(lambda a: torch.matmul(a, b2[:, None]), plane)),
        ("the plain route's 40-tap prep, x2: _shift_prep + _row_start "
         "(fwd; not run on the card, K2 and K3 take q)", prep_plain),
        ("K2 x2 (fwd)", k2),
        ("K3 x2 (bwd)", k3),
        ("transpose + 2 FIR downsample matmuls + crop (fwd + bwd)",
         fwd_bwd(lambda a: torch.matmul(d, torch.matmul(
             a.transpose(2, 3), d.t())).permute(0, 2, 3, 1), plane)),
    ]
    times = [(name, _event_ms(fn, iters)) for name, fn in parts]
    whole = fwd_bwd(stage, x)
    t_events = _event_ms(whole, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        whole()
    torch.cuda.synchronize()
    t_host = (time.perf_counter() - t0) * 1e3 / iters
    # the stage's two FIR matrices on the host: filled afresh in a Python
    # loop and uploaded (what every call did before the stage cached them,
    # and what the first call of a shape still does), against the look-up
    # every later call makes
    t0 = time.perf_counter()
    for _ in range(iters):
        torch.from_numpy(aw._upsample_matrix(taps, npad)).to(dev, bf16)
        torch.from_numpy(aw._downsample_matrix(
            taps, side, extra_pad=-2 * m)).to(dev, bf16)
    torch.cuda.synchronize()
    times.append(("host clock: the two FIR matrices built in numpy and "
                  "uploaded, as the first call of a shape does",
                  (time.perf_counter() - t0) * 1e3 / iters))
    key = tuple(float(t) for t in taps)
    t0 = time.perf_counter()
    for _ in range(iters):
        aw._fir_matrix("up", key, npad, 0, dev, bf16)
        aw._fir_matrix("down", key, side, -2 * m, dev, bf16)
    torch.cuda.synchronize()
    times.append(("host clock: the two FIR matrices looked up, as every "
                  "later call does",
                  (time.perf_counter() - t0) * 1e3 / iters))
    return t_events, t_host, times, _device_share(whole)


def _device_share(fn):
    """(device kernels, their busy ms, the span ms from the first to the
    last of them) of one fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pasta_tpu_torch.cli.profile_serving import busy_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.elapsed_us() > 0]
    if not spans:
        raise RuntimeError("bench_train: the trace holds no device time")
    return (len(spans), busy_us(spans) / 1e3,
            (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3)


def profile_step(step, state, batch, generator, do_r1=False):
    """torch.profiler over one step: idle share, kernel time by name, and
    the host ops that launched the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from pasta_tpu_torch.cli.profile_serving import busy_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator, do_r1_d=do_r1, do_r1_dp=do_r1)
        torch.cuda.synchronize()
    print(f"[profile] {'R1' if do_r1 else 'regular'} step", flush=True)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() > 0]
    if not kernels:
        raise RuntimeError("bench_train: the trace holds no device time")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_us(intervals)
    print(f"[profile] device busy {busy / 1e3:.1f} ms over a span of "
          f"{span / 1e3:.1f} ms, idle share {1 - busy / span:.3f} | "
          f"{len(kernels)} device events", flush=True)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())
    print(f"[profile] kernel time {total / 1e3:.1f} ms; top {TOP_KERNELS}:")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"{us / 1e3:9.2f} ms {100 * us / total:5.1f}% x{n:5d}  "
              f"{name[:110]}", flush=True)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print("[profile] host ops by device time (self, ms), top 15:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"{e.self_device_time_total / 1e3:9.2f} ms x{e.count:6d}  "
              f"{e.key}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--skip-r1", action="store_true")
    ap.add_argument("--no-vgg", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks, one card each: the data-parallel step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_train: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from pasta_tpu_torch.train.config import fashion_config
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    if args.devices > 1:
        print_ranks(bench_ranks(args.devices, args.batch, args.steps,
                                args.res, not args.no_vgg), args.batch)
        return
    cfg = fashion_config(batch_size=args.batch, resolution=args.res)
    t0 = time.perf_counter()
    state, step, batch, gen = setup(cfg, "cuda", use_vgg=not args.no_vgg)
    print(f"[setup] res {cfg.resolution} batch {cfg.batch_size} vgg "
          f"{not args.no_vgg} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    print(f"[warm-up] first step {time.perf_counter() - t0:.2f} s "
          "(kernel builds included)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    host, dev, _ = timed_steps(step, state, batch, gen, args.steps)
    counts = kernel_counts()
    print(f"[train] regular x{args.steps}: {host:.4f} s/step host, "
          f"{dev:.4f} s/step CUDA events, {host * 1000 / cfg.batch_size:.1f}"
          f" sec/kimg | launches per step K1 fwd/dX, K2, K3: "
          f"{[c / args.steps for c in counts]}", flush=True)
    if not args.skip_r1:
        reset_kernel_counts()
        host, dev, (metrics,) = timed_steps(step, state, batch, gen, 1,
                                            do_r1=True)
        print(f"[train] R1 step: {host:.4f} s host, {dev:.4f} s CUDA events"
              f" | launches K1 fwd/dX, K2, K3: {list(kernel_counts())} | r1 "
              f"{metrics['r1_penalty']:.4g} dp_r1 "
              f"{metrics['dp_r1_penalty']:.4g}", flush=True)
    print(f"[train] peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB", flush=True)
    n_d = 3 * cfg.batch_size                # Dmain: img + finetune + real
    t_two, t_gather, psnr = geom_stage(n_d, cfg.resolution)
    print(f"[augment] geometric stage, forward + backward, {n_d} x "
          f"{cfg.resolution}^2: two-pass (bf16, K2/K3) {t_two:.3f} ms | "
          f"gather oracle (fp32) {t_gather:.3f} ms | two-pass vs gather "
          f"PSNR {psnr:.2f} dB", flush=True)
    t_events, t_host, parts, (n_kernels, busy, span) = geom_breakdown(
        n_d, cfg.resolution)
    print(f"[augment] two-pass stage alone, forward + backward: "
          f"{t_events:.3f} ms by CUDA events, {t_host:.3f} ms by the host "
          f"clock; profiled once: {n_kernels} device kernels, busy "
          f"{busy:.3f} ms over a span of {span:.3f} ms, idle share "
          f"{1 - busy / span:.3f}; its parts, each replayed alone:",
          flush=True)
    for name, ms in parts:
        print(f"[augment] {ms:9.3f} ms  {name}", flush=True)
    counted = sum(ms for name, ms in parts
                  if not name.startswith(("  the same", "the plain route",
                                          "host clock")))
    print(f"[augment] {counted:9.3f} ms  sum of the parts (without the plain "
          f"route's prep, the contiguous twin and the host's share) | "
          f"{t_events - counted:.3f} ms not attributed: the card waiting "
          f"for the host (the launches), the per-sample scalar ops, "
          f"autograd's bookkeeping",
          flush=True)
    if args.profile:
        profile_step(step, state, batch, gen)
        if not args.skip_r1:
            profile_step(step, state, batch, gen, do_r1=True)


if __name__ == "__main__":
    main()
