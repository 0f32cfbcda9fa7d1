"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives pasta_tpu_torch's two main paths on the card -- 512px try-on serving
(TryonPipeline.run_batch, fashion Generator config, num_bf16_res=3) and the
512px training step of the fashion preset (batch 4, G/D/DP phases, lazy R1,
EMA, ADA) -- with seeded random weights and seeded synthetic inputs, in
phases:

  1. device      -- fails without CUDA; prints the card's name, power limit
  2. build       -- compiles csrc/conv3x3.cu (K1) and csrc/shift.cu (K2, K3)
                    from the sources, in parallel; registers and spills
                    (none allowed in K1's kernels), the fp32 kernel's blocks
                    per SM, the bf16 kernel's tile waste at four widths
  3. kernel      -- K1 against its plain version at the serving shapes
                    (bf16) and, in bf16 and fp32, at two ragged shapes, with
                    the error bound and CUDA-event times
  4. main        -- run_batch on tiled and full-path batches; K1's launch
                    count must equal its in-scope convs per batch
  5. check       -- a small fp32 serving run on the card against the CPU
  6. kernel-train -- K2 and K3 (from the positions q) against their plain
                    versions at the training shapes (bf16) and at ragged
                    shapes in both dtypes, the (s, f) they derive against
                    _shift_prep's, their adjoint identity, no op before the
                    launch, K2's (start, f) entry at the TPU probes' shapes
                    (P1-P3), and K1's
                    forward and input gradient against F.conv2d's autograd
                    at the training shapes (fp32 bound: 1e-5 of the output
                    scale); in bf16 the input gradient is one launch on dY
                    (pad = 2, held against plain on the padded dY, no pad
                    copy among its ops), in fp32 the kernel alone and with
                    the gradient's pad copies; every time beside its bound
                    and, for K1, the one cuDNN call that computes the same
  7. train       -- init_state on the fashion preset at batch 4, a warm-up
                    step, 3 timed regular steps and one R1 step; finite
                    metrics, the ADA controller's move, parameters changed,
                    K1 forward / K1 dX / K2 / K3 launch counts; s/step,
                    sec/kimg, peak memory
  8. train-check -- one fp32 step's per-phase losses and gradients at the
                    narrow 64px config (ada_p 0, no noise), card against CPU

Run from the repository root:  python3 chip_smoke.py
The last line of standard output is {"ok": true, "device": {...}}; the one
before it the card's name and power limit, and before that the kernels'
summary {"kernels": [...]}: per kernel its launches on the main paths, the
largest error against plain, and the sums over the shapes above of its time,
plain's, the bound's (the larger of operations over the card's peak rate --
989 TFLOP/s bf16, 67 fp32 -- and bytes, each input and output once, over
3.35 TB/s) and the library call's. Any failure exits non-zero.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8          # serving batch of the main path and the kernel shapes
N_TIMED = 3        # timed tiled batches after one warm-up batch

# K1's in-scope convs in one fashion-config forward (3x3, stride 1, groups 1,
# C_in in {64,128}, C_out <= 128): b256.conv1; b512 and texture_b512
# conv0 (VALID on the upsampled input) and conv1; spade_b512's three convs
# and three fused gamma/beta convs; spade_b256_{1,2}'s three convs and three
# conv_mlp each; the spade encoder's two 64-ch resblock convs at 512^2 and
# one 128-ch conv at 256^2.
K1_PER_BATCH = 26

# Launches of one regular training step of the fashion preset at batch 4
# (mbstd group 4 divides every sub-batch, so the fake/real streams of one
# phase share one augment and one D call; VGG on):
#   K1 forward: Gmain's G 26 + image D 2 (b512.conv0, b256.conv0) + parsing
#     D 2 + VGG19 6 (conv1_2, conv2_1, conv2_2 on the real and on the
#     [img; finetune] stack); Dmain's no-grad G draw 26 + D 2; DPmain's
#     style-branch draw 3 (b256.conv1, b512.conv0, b512.conv1) + DP 2.
#   K1 dX: Gmain's backward through G 26, D 2, DP 2, VGG 3; Dmain 2; DPmain 2.
#   K2: 2 passes per augment, in Gmain and in Dmain.  K3: Gmain's backward.
# An R1 step adds, for each of Dr1 and DPr1: 2 K1 forwards and 6 dX (the
# input gradient's 2, their 2 in the parameter backward, and the forward
# convs' 2 there); Dr1 adds 2 K2 (augment) + 2 K2 (second backward through
# K3) and 2 K3 (the input gradient through the augment).
TRAIN_K1_FWD = 26 + 2 + 2 + 6 + 26 + 2 + 3 + 2        # 69
TRAIN_K1_DX = 26 + 2 + 2 + 3 + 2 + 2                  # 37
# Of those 106, fp32 (G and VGG19 run in fp32): G's 26 forward + 26 dX in
# Gmain, 26 forward in Dmain's draw, 3 in DPmain's, VGG19's 6 forward + 3 dX;
# the other 16 are D's and DP's, bf16: 4 x 2 forward and 4 x 2 dX.
TRAIN_K1_FP32 = 26 + 26 + 26 + 3 + 6 + 3              # 90
TRAIN_K2, TRAIN_K3 = 4, 2
R1_K1_FWD, R1_K1_DX, R1_K2, R1_K3 = 4, 12, 4, 2
TRAIN_BATCH = 4
N_TRAIN_TIMED = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters, ahead=False):
    """Mean device time of fn() over `iters` launches (CUDA events). With
    `ahead`, a few milliseconds of other work are queued first, so that the
    host has every launch queued before the card reaches the first event: a
    kernel shorter than its wrapper's host time (about 30 us a call) is
    then timed, not the wrapper."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if ahead:
        if cuda_ms.filler is None:
            cuda_ms.filler = torch.zeros(4096, 4096, device="cuda")
        torch.mm(cuda_ms.filler, cuda_ms.filler)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


cuda_ms.filler = None


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def turns(plain, kernel, iters):
    """(kernel ms, plain ms) timed in turns plain-kernel-kernel-plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def conv_bound(n, h, w_out, ci, co, dtype, in_elems, out_elems):
    """(bound ms, what bounds it, FLOP) of a 3x3 conv or its input
    gradient: 2*N*H*W*9*C_in*C_out operations at the dtype's peak against
    input + weights + output once over the device memory rate."""
    flop = 2 * n * h * w_out * 9 * ci * co
    size = torch.finfo(dtype).bits // 8
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = (in_elems + 9 * ci * co + out_elems) * size / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flop)


def row(err, ms, plain_ms, bound_ms, bound_by, library_ms=None, dtype=None):
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, dtype=dtype)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    return smi


def _print_ptxas(tag, log):
    name = "?"
    for line in log.splitlines():          # ptxas -v: registers and spills
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                          m.group(1))[:60]
        elif "registers" in line or "spill stores" in line:
            print(f"[build] {tag} {name}: "
                  f"{line.split(':', 1)[-1].strip()}")
            spill = re.search(r"(\d+) bytes spill stores", line)
            check(not (spill and "conv3x3_" in name and int(spill.group(1))),
                  f"{name} spills: {line.strip()}")


def phase_build(k1, shift):
    """Both sources compile at once, one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {"K1 csrc/conv3x3.cu": pool.submit(k1.build),
                "K2/K3 csrc/shift.cu": pool.submit(shift.build)}
        for tag, job in jobs.items():
            _, seconds, log = job.result()
            print(f"[build] {tag} -> sm_90a in {seconds:.2f} s", flush=True)
            _print_ptxas(tag.split()[0], log)
    lib = k1.build()[0]
    for ci, co in ((64, 64), (64, 128), (128, 64), (128, 128)):
        blocks = lib.pasta_conv3x3_f32_blocks_per_sm(ci, co)
        check(blocks >= 2, f"K1 fp32 {ci}->{co}: {blocks} blocks per SM")
        print(f"[build] K1 fp32 {ci}->{co}: {blocks} blocks of 256 threads "
              f"per SM (occupancy calculator)", flush=True)
    waste = []
    for width in (512, 514, 256, 258):     # square outputs, as on the paths
        tiles = lib.pasta_conv3x3_bf16_tiles(width, width)
        check(tiles > 0, f"K1 bf16 tile plan at {width}: {tiles}")
        waste.append(f"{width}: {100 * (tiles * 64 / width ** 2 - 1):.2f}%")
    print(f"[build] K1 bf16 tile waste (64-pixel tiles computed over pixels "
          f"stored, less 1) at out_w {', '.join(waste)}", flush=True)


def phase_kernel(k1, batch):
    """K1 vs conv3x3_valid_plain in bf16 at the serving path's shapes, and
    its fp32 kernel at two ragged shapes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [  # (N, H, W, C_in, C_out, SAME padding)
        (batch, 514, 514, 128, 64, False),
        (batch, 512, 512, 64, 64, True),
        (batch, 512, 512, 64, 128, True),
        (2 * batch, 256, 256, 128, 128, True),
    ]
    rows = []
    for n, h, w, ci, co, same in shapes:
        x = torch.randn(n, h, w, ci, device=dev, generator=g).to(torch.bfloat16)
        wt = (torch.randn(3, 3, ci, co, device=dev, generator=g)
              / (9 * ci) ** 0.5).to(torch.bfloat16)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1)) if same else x
        got = k1.conv3x3_valid(xp, wt)
        plain = k1.conv3x3_valid_plain(xp, wt)
        ref32 = k1.conv3x3_valid_plain(xp.float(), wt.float())
        torch.cuda.synchronize()
        scale = ref32.abs().max().item()
        err = (got.float() - plain.float()).abs().max().item()
        err32 = (got.float() - ref32).abs().max().item()
        # Both outputs are one bf16 rounding (2^-8 relative) of an fp32 sum:
        # they may differ by 2^-7 of the output scale.
        bound = 2.0 ** -7 * scale
        check(err <= bound and err32 <= bound,
              f"K1 vs plain at {tuple(xp.shape)}->{co}: err {err} / fp32 "
              f"{err32} > bound {bound}")
        xn, wn = xp.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        t_k1, t_plain = turns(lambda: k1.conv3x3_valid_plain(xp, wt),
                              lambda: k1.conv3x3_valid(xp, wt), 10)
        t_lib = cuda_ms(lambda: F.conv2d(xn, wn), 10)
        ho, wo = xp.shape[1] - 2, xp.shape[2] - 2
        t_bound, by, flop = conv_bound(n, ho, wo, ci, co, torch.bfloat16,
                                       xp.numel(), got.numel())
        print(f"[kernel] [{n},{xp.shape[1]},{xp.shape[2]},{ci}]->{co} "
              f"max_abs_err {err:.6g} (vs fp32 {err32:.6g}, bound "
              f"{bound:.6g}) | K1 {t_k1:.4f} ms {flop / t_k1 / 1e9:.1f} "
              f"TFLOP/s | plain {t_plain:.4f} ms | library (F.conv2d) "
              f"{t_lib:.4f} ms | bound_ms {t_bound:.4f} ({by}, "
              f"{100 * t_bound / t_k1:.1f}%)", flush=True)
        rows.append(row(err, t_k1, t_plain, t_bound, by, t_lib,
                        torch.bfloat16))
        del x, xp, xn, got, plain, ref32
    # both kernels at ragged shapes: C_out above 64 and not a multiple of
    # 8; C_out not a multiple of 4 with an odd H and out_w < W' - 2
    for dtype in (torch.float32, torch.bfloat16):
        for n, hp, wp, ci, co, out_w in ((2, 34, 70, 64, 100, None),
                                         (1, 11, 23, 128, 7, 15)):
            x = torch.randn(n, hp, wp, ci, device=dev, generator=g).to(dtype)
            wt = (torch.randn(3, 3, ci, co, device=dev, generator=g)
                  / (9 * ci) ** 0.5).to(dtype)
            ref = k1.conv3x3_valid_plain(x.float(), wt.float(), out_w)
            got = k1.conv3x3_valid(x, wt, out_w)
            e = (got.float() - ref).abs().max().item()
            bound = _bound(ref, dtype)
            check(got.shape == ref.shape and e <= bound,
                  f"K1 {dtype} [{n},{hp},{wp},{ci}]->{co}: err {e} > {bound}")
            print(f"[kernel] {str(dtype)[6:]} [{n},{hp},{wp},{ci}]->{co} "
                  f"out_w {ref.shape[2]} max_abs_err {e:.3g} (bound "
                  f"{bound:.3g}, {'2^-7' if dtype == torch.bfloat16 else '1e-5'}"
                  f" of the output scale)", flush=True)
    torch.cuda.empty_cache()
    return rows


def _items(pipe, seeds, jitter):
    from pasta_tpu_torch.data.synthetic import make_garment, make_person

    return [pipe.prepare(make_person(s, jitter=jitter),
                         make_garment(1000 + s, jitter=jitter))
            for s in seeds]


def phase_main(k1, batch, n_timed):
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Generator(seed=0, num_bf16_res=3).eval().to(dev)
    pipe = TryonPipeline(model, mode="upper")
    n_params = sum(p.numel() for p in model.parameters())
    t1 = time.perf_counter()
    tiled_items = _items(pipe, range(batch), 3.0)
    full_items = _items(pipe, range(100, 100 + batch), 40.0)
    t2 = time.perf_counter()
    check(all(bool(it["tiles_fit"]) for it in tiled_items),
          "the tiled batch does not fit its paste tiles")
    check(not all(bool(it["tiles_fit"]) for it in full_items),
          "the full-path batch fits its paste tiles")
    print(f"[main] Generator fashion config {n_params / 1e6:.2f} M params, "
          f"num_bf16_res=3, built in {t1 - t0:.2f} s | host_prepare "
          f"{2 * batch / (t2 - t1):.2f} pairs/s (1 process)", flush=True)

    out = pipe.run_batch(tiled_items)            # warm-up (first launches)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    k1.conv3x3_valid.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        out = pipe.run_batch(tiled_items)
    torch.cuda.synchronize()
    t_tiled = time.perf_counter() - t0
    tiled_path = pipe.last_tiled
    t0 = time.perf_counter()
    out_full = pipe.run_batch(full_items)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    launches = k1.conv3x3_valid.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    check(tiled_path and not pipe.last_tiled, "path selection")
    for o in (out, out_full):
        check(tuple(o.shape) == (batch, 512, 512, 3), f"shape {o.shape}")
        check(bool(torch.isfinite(o).all()), "non-finite output")
    n_batches = n_timed + 1
    check(launches == K1_PER_BATCH * n_batches,
          f"K1 launches {launches} != {K1_PER_BATCH} x {n_batches}")
    print(f"[main] run_batch x{n_timed} tiled: {batch * n_timed / t_tiled:.2f}"
          f" img/s ({1e3 * t_tiled / n_timed:.1f} ms/batch of {batch}) | full"
          f" path x1: {batch / t_full:.2f} img/s | K1 launches {launches} ="
          f" {K1_PER_BATCH} x {n_batches} batches | peak "
          f"{peak:.2f} GiB | out range [{out.min().item():.3f}, "
          f"{out.max().item():.3f}]", flush=True)
    del model, pipe, out, out_full
    torch.cuda.empty_cache()
    return launches


def phase_check():
    """A small fp32 pipeline (narrow 512px config, batch 1) on the card
    against the same run on the CPU, which the CPU tests hold against the
    JAX package. TF32 is off; the spade encoder's convs go through K1's
    fp32 variant. The SPADE routing argmax may flip on near-ties, so the
    finetune image is held to the CPU tests' budget."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    cfg = dict(channel_base=2048, channel_max=128)
    outs = []
    for dev in ("cuda", "cpu"):
        model = Generator(seed=0, **cfg).eval().to(dev)
        pipe = TryonPipeline(model, mode="upper")
        outs.append(pipe.run_batch(_items(pipe, [7], 3.0)).float().cpu()
                    .numpy())
    gpu, cpu = outs
    span = cpu.max() - cpu.min()
    diff = np.abs(gpu - cpu)
    frac = float(np.mean(diff > 1e-2 * span))
    check(np.all(np.isfinite(gpu)) and frac <= 2e-2
          and diff.mean() <= 1e-3 * span,
          f"card vs CPU: frac {frac}, mean {diff.mean()}, span {span}")
    print(f"[check] narrow 512px fp32 card vs CPU: max {diff.max():.4g} "
          f"mean {diff.mean():.4g} (span {span:.4g}), {100 * frac:.3f}% of "
          f"values beyond 1e-2 of span (budget 2%)", flush=True)


def _shift_case(rows, v_dim, out_w, dtype, g, dev, lines=1048, center=1000):
    """Inputs of K2/K3 shaped as on the training path: per-line positions q
    with a slope of at most 0.9 across each plane of `lines` lines (as
    _warp_core_planar makes them)."""
    line = torch.arange(rows, device=dev, dtype=torch.float32) % lines
    slope = torch.rand(rows // lines + 1, device=dev, generator=g)[
        torch.arange(rows, device=dev) // lines] * 2 - 1
    q = (center + slope * 0.9 * line
         + torch.rand(rows, device=dev, generator=g))
    wide = torch.randn(rows, v_dim, device=dev, generator=g).to(dtype)
    dout = torch.randn(rows, out_w, device=dev, generator=g).to(dtype)
    return q, wide, dout


def _check_row_params(shift, wide, q, out_w, tag):
    """The (s, f) K2 derives from q are `_shift_prep`'s, bit for bit."""
    _, s, f = shift._kernel("shift_fwd", wide, q, None, None, wide.shape[1],
                            out_w, return_rows=True)
    s_ref, f_ref = shift._row_params_plain(q, out_w, wide.shape[1])
    torch.cuda.synchronize()
    check(torch.equal(s, s_ref) and torch.equal(f, f_ref),
          f"{tag}: the kernel's (s, f) differ from _shift_prep's")
    blocks = s.view(-1, 8)
    return (blocks - blocks.amin(1, keepdim=True)).max().item()


def _bound(ref, dtype):
    scale = ref.float().abs().max().item()
    return (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * max(scale, 1e-6)


def phase_kernel_train(k1, shift):
    """K2/K3 at the training path's shapes, the probes' shapes, and K1's
    forward and input gradient at the training shapes, each against its
    plain version."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {"K2": [], "K3": [], "K1": []}
    v_dim, out_w = 3200, 1048
    # R = n * 3 channels * 1048 lines: n = 4 (Dr1), 8 (Gmain), 12 (Dmain).
    # Bytes: the two-tap function reads out_w + 1 columns and q, and writes
    # out_w (K3: reads out_w and q, writes V). Beside it, for comparison with
    # measurements of a 40-tap kernel, that kernel's count: out_w + 40
    # columns read and no q.
    for n in (4, 8, 12):
        r = n * 3 * 1048
        q, wide, dout = _shift_case(r, v_dim, out_w, torch.bfloat16, g, dev)
        spread = _check_row_params(shift, wide, q, out_w, f"K2 R={r}")
        for name, kern, plain, a, dim, nbytes, old_bytes in (
                ("K2", shift.shift_fwd, shift.shift_fwd_plain, wide, out_w,
                 r * (2 * out_w + 1) * 2 + 4 * r, r * (2 * out_w + 40) * 2),
                ("K3", shift.shift_bwd, shift.shift_bwd_plain, dout, v_dim,
                 r * (out_w + v_dim) * 2 + 4 * r, r * (out_w + v_dim) * 2)):
            got = kern(a, q, dim)
            ref = plain(a, q, dim)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            bound = _bound(ref, torch.bfloat16)
            check(err <= bound, f"{name} R={r}: err {err} > bound {bound}")
            t_p1 = cuda_ms(lambda: plain(a, q, dim), 5)
            t_k1 = cuda_ms(lambda: kern(a, q, dim), 20, ahead=True)
            t_k2 = cuda_ms(lambda: kern(a, q, dim), 20, ahead=True)
            t_p2 = cuda_ms(lambda: plain(a, q, dim), 5)
            t_k, t_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
            floor = nbytes / HBM_BYTES_PER_S * 1e3
            # the yardstick of a streaming pass: torch's device-to-device
            # copy moving as many bytes (half read, half written)
            half = torch.empty(nbytes // 4, dtype=torch.bfloat16, device=dev)
            twin = torch.empty_like(half)
            t_copy = cuda_ms(lambda: twin.copy_(half), 20, ahead=True)
            del half, twin
            print(f"[kernel-train] {name} R={r} V={v_dim} out_w={out_w} bf16 "
                  f"from q (largest offset in a block {spread}) max_abs_err "
                  f"{err:.4g} (bound {bound:.4g}) | {t_k:.4f} ms = "
                  f"{100 * floor / t_k:.1f}% of bound_ms {floor:.5f} (bytes; "
                  f"{nbytes / t_k / 1e6:.0f} GB/s; by the 40-tap count "
                  f"{old_bytes / HBM_BYTES_PER_S * 1e3:.5f}) | a copy of as "
                  f"many bytes {t_copy:.4f} ms | plain {t_p:.4f} ms | "
                  f"library_ms null", flush=True)
            rows[name].append(row(err, t_k, t_p, floor, "bytes"))
        del q, wide, dout
    # no op runs before the launch: the path hands K2 the positions as they are
    q, wide, _ = _shift_case(8 * 1048, v_dim, out_w, torch.bfloat16, g, dev)
    ops = _ops_of(lambda: shift._row_shift(wide, q, out_w))
    prep_ops = ops & {"aten::one_hot", "aten::repeat_interleave", "aten::floor",
                      "aten::clamp", "aten::amin", "aten::gather", "aten::mul"}
    check(not prep_ops, f"_row_shift ran {sorted(prep_ops)} before K2")
    print(f"[kernel-train] _row_shift on the card runs {sorted(ops)}",
          flush=True)
    del q, wide
    # ragged shapes from q, positions past both clamps and offsets past 38:
    # widths that are not whole 16-byte chunks (the scalar kernel) and that
    # are, in both dtypes; the adjoint identity in fp32
    for dtype, ow in ((torch.float32, 131), (torch.bfloat16, 131),
                      (torch.float32, 132), (torch.bfloat16, 136)):
        q, wide, dout = _shift_case(1000, 640, ow, dtype, g, dev, lines=200,
                                    center=200)
        q[::5] = 640.0
        q[1::7] = -3.0
        q[2::3] += torch.rand(len(q[2::3]), device=dev, generator=g) * 60
        spread = _check_row_params(shift, wide, q, ow, f"K2 out_w={ow}")
        check(spread == 38, f"largest offset {spread}, wanted the clamp 38")
        k2, k3 = shift.shift_fwd(wide, q, ow), shift.shift_bwd(dout, q, 640)
        r2, r3 = shift.shift_fwd_plain(wide, q, ow), shift.shift_bwd_plain(
            dout, q, 640)
        e2 = (k2.float() - r2.float()).abs().max().item()
        e3 = (k3.float() - r3.float()).abs().max().item()
        check(e2 <= _bound(r2, dtype) and e3 <= _bound(r3, dtype),
              f"K2/K3 {dtype} out_w={ow}: {e2}, {e3}")
        tail = ""
        if dtype == torch.float32:
            lhs = (k2.double() * dout.double()).sum().item()
            rhs = (wide.double() * k3.double()).sum().item()
            check(abs(lhs - rhs) <= 1e-5 * abs(lhs), f"adjoint {lhs} vs {rhs}")
            tail = f" | <K2 x, y> {lhs:.10g} vs <x, K3 y> {rhs:.10g}"
        print(f"[kernel-train] {str(dtype)[6:]} R=1000 V=640 out_w={ow} from "
              f"q: K2 err {e2:.3g} K3 err {e3:.3g} (bound "
              f"{_bound(r2, dtype):.3g}), (s, f) equal _shift_prep's, largest"
              f" offset {spread}{tail}", flush=True)
    # the TPU probes of K2 through the (start, f) entry: a start per row, fp32
    for probe, r, k_hi in (("P1", 4 * 1048, 4224 - 3144 - 1),
                           ("P2", 32, 4224 - 3144 - 257),
                           ("P3", 32, 4224 - 3144 - 257)):
        src = torch.rand(r, 4224, device=dev, generator=g)
        k = torch.randint(0, k_hi, (r,), device=dev, generator=g,
                          dtype=torch.int32)
        f = torch.rand(r, device=dev, generator=g)
        wt = shift._two_taps(f)
        idx = k.long()[:, None] + torch.arange(3144, device=dev)[None]
        want = (torch.gather(src, 1, idx) * (1 - f)[:, None]
                + torch.gather(src, 1, idx + 1) * f[:, None])
        got = shift.shift_fwd_rows(src, k, f, 3144)
        err = (got - want).abs().max().item()
        check(err <= 1e-5, f"{probe}: err {err}")
        t_k = cuda_ms(lambda: shift.shift_fwd_rows(src, k, f, 3144), 20,
                      ahead=True)
        t_p = cuda_ms(lambda: shift._shift_rows_plain(src, k, wt, 3144), 5)
        nbytes = r * (3144 + 1) * 4 + r * 3144 * 4 + 8 * r
        floor = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[kernel-train] {probe} R={r} L=4224 W=3144 fp32 (start, f) "
              f"entry max_abs_err {err:.3g} | K2 {t_k:.4f} ms = "
              f"{100 * floor / t_k:.1f}% of bound_ms {floor:.5f} (bytes; "
              f"{nbytes / t_k / 1e6:.0f} GB/s) | plain {t_p:.4f} ms | "
              f"library_ms null", flush=True)
        rows["K2"].append(row(err, t_k, t_p, floor, "bytes"))
    # K1 forward and input gradient at the training shapes, against
    # F.conv2d's autograd: the fp32 G at batch 4, the bf16 D at Dmain's 12
    F = torch.nn.functional
    for n, hw, ci, co, dtype in ((4, 512, 128, 64, torch.float32),
                                 (4, 512, 64, 64, torch.float32),
                                 (4, 512, 64, 128, torch.float32),
                                 (4, 256, 128, 128, torch.float32),
                                 (12, 512, 64, 64, torch.bfloat16),
                                 (12, 256, 128, 128, torch.bfloat16)):
        x = torch.randn(n, hw + 2, hw + 2, ci, device=dev, generator=g).to(
            dtype).requires_grad_(True)
        wt = (torch.randn(3, 3, ci, co, device=dev, generator=g)
              / (9 * ci) ** 0.5).to(dtype).requires_grad_(True)
        dy = torch.randn(n, hw, hw, co, device=dev, generator=g).to(dtype)
        y = k1.conv3x3_valid(x, wt)
        dx, dw = torch.autograd.grad(y, (x, wt), dy)
        xn = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
        wn = wt.detach().permute(3, 2, 0, 1).requires_grad_(True)
        yr = F.conv2d(xn, wn)
        dxr, dwr = torch.autograd.grad(yr, (xn, wn), dy.permute(0, 3, 1, 2))
        dxr, dwr = dxr.permute(0, 2, 3, 1), dwr.permute(2, 3, 1, 0)
        errs = []
        for what, got, ref in (("y", y, yr.permute(0, 2, 3, 1)),
                               ("dX", dx, dxr), ("dW", dw, dwr)):
            err = (got.float() - ref.float()).abs().max().item()
            # y and dX are the kernel's: 1e-5 of the output scale in fp32.
            # dW is cuDNN's on both sides, summed over N*H*W in another
            # order: 1e-4.
            bound = _bound(ref, dtype) * (10 if what == "dW" and dtype
                                          == torch.float32 else 1)
            check(err <= bound, f"K1 {what} [{n},{hw + 2},{hw + 2},{ci}]->"
                  f"{co} {dtype}: err {err} > bound {bound}")
            errs.append(err)
        xd, wd = x.detach(), wt.detach()
        xnd, wnd, dyn = xn.detach(), wn.detach(), dy.permute(0, 3, 1, 2)
        wr = wd.flip(0, 1).transpose(2, 3).contiguous()
        it = 5 if dtype == torch.float32 else 10
        # bf16: the input gradient is the kernel with pad = 2 on dY as it
        # lies, and no pad copy runs; fp32 pads dY first
        pads = "aten::constant_pad_nd" in _ops_of(
            lambda: k1._input_grad(dy, wd, hw + 2))
        check(pads == (dtype == torch.float32),
              f"K1 {dtype} input gradient: pad copy {pads}")
        if dtype == torch.bfloat16:
            _check_pad2(k1, dy, wr, hw + 2)
        # forward: the wrapper is the kernel alone; plain adds the layout
        # copy around cuDNN's call, the library time is that call alone
        t_f, t_fp = turns(lambda: k1.conv3x3_valid_plain(xd, wd),
                          lambda: k1.conv3x3_valid(xd, wd), it)
        t_fl = cuda_ms(lambda: F.conv2d(xnd, wnd), it)
        # dX: _input_grad launches the kernel on the rotated weights, in
        # fp32 on a padded copy of dY (timed with it, and the kernel alone
        # beside), in bf16 on dY itself; plain is F.conv2d on the padded dY
        t_x, t_xp = turns(
            lambda: k1.conv3x3_valid_plain(F.pad(dy, (0, 0, 2, 2, 2, 2)), wr),
            lambda: k1._input_grad(dy, wd, hw + 2), it)
        alone = ""
        if dtype == torch.float32:
            dyp = F.pad(dy, (0, 0, 2, 2, 2, 2))
            t_xk = cuda_ms(lambda: k1._kernel(dyp, wr, hw + 2), it)
            alone = f"; kernel alone {t_xk:.3f}"
            del dyp
        t_xl = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            xn.shape, wnd, dyn), it)
        bf, by, flop = conv_bound(n, hw, hw, ci, co, dtype, x.numel(),
                                  y.numel())
        bx, _, _ = conv_bound(n, hw, hw, ci, co, dtype, dy.numel(),
                              x.numel())
        tag = "fp32" if dtype == torch.float32 else "bf16"
        print(f"[kernel-train] K1 {tag} [{n},{hw + 2},{hw + 2},{ci}]->{co} "
              f"max_abs_err y {errs[0]:.3g} dX {errs[1]:.3g} dW "
              f"{errs[2]:.3g} | fwd K1 {t_f:.3f} ms "
              f"({flop / t_f / 1e9:.1f} TFLOP/s, {100 * bf / t_f:.1f}% of "
              f"bound_ms {bf:.3f} {by}) plain {t_fp:.3f} library "
              f"(F.conv2d) {t_fl:.3f} | dX K1 {t_x:.3f} ms "
              f"({flop / t_x / 1e9:.1f} TFLOP/s, {100 * bx / t_x:.1f}% of "
              f"bound_ms {bx:.3f}{alone}) plain {t_xp:.3f}"
              f" library (conv2d_input) {t_xl:.3f}", flush=True)
        rows["K1"].append(row(errs[0], t_f, t_fp, bf, by, t_fl, dtype))
        rows["K1"].append(row(errs[1], t_x, t_xp, bx, by, t_xl, dtype))
        del x, wt, dy, y, dx, dw, xn, wn, yr, dxr, dwr, xd, wd, xnd, wnd, dyn
        del wr
    # pad = 2 at a ragged shape: out_w past the last column dY reaches, C_out
    # not a multiple of 8, a width with columns left over by the 64-pixel
    # tiles
    dy = torch.randn(2, 37, 131, 128, device=dev, generator=g).to(
        torch.bfloat16)
    wr = (torch.randn(3, 3, 128, 100, device=dev, generator=g) / 34).to(
        torch.bfloat16)
    _check_pad2(k1, dy, wr, 137)
    cuda_ms.filler = None
    torch.cuda.empty_cache()
    return rows


def _ops_of(fn):
    """Names of the ATen ops that fn() runs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def _check_pad2(k1, dy, wr, out_w):
    """K1 bf16 with its implicit 2-px halo against the plain conv of the
    padded copy (zero columns on the right up to out_w + 2)."""
    F = torch.nn.functional
    got = k1._kernel(dy, wr, out_w, 2)
    right = out_w - dy.shape[2]
    ref = k1.conv3x3_valid_plain(
        F.pad(dy, (0, 0, 2, right, 2, 2)).float(), wr.float())
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    bound = _bound(ref, torch.bfloat16)
    check(got.shape == ref.shape and err <= bound,
          f"K1 bf16 pad 2 {tuple(dy.shape)}->{wr.shape[3]}: err {err} > "
          f"{bound}")
    print(f"[kernel-train] K1 bf16 pad 2 {list(dy.shape)}->{wr.shape[3]} "
          f"out_w {out_w} vs plain on the padded copy: max_abs_err "
          f"{err:.3g} (bound {bound:.3g})", flush=True)


def _flat_params(module):
    return torch.cat([p.detach().float().reshape(-1)
                      for p in module.parameters()])


def phase_train(k1):
    """The fashion preset's training step at batch 4 on the card."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.train.config import fashion_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = fashion_config(batch_size=TRAIN_BATCH)
    t0 = time.perf_counter()
    state, step, batch, gen = bench_train.setup(cfg, "cuda")
    before = [_flat_params(m) for m in (state.g, state.d, state.dp)]
    n_params = [b.numel() for b in before]
    print(f"[train] fashion preset batch {TRAIN_BATCH}: G {n_params[0] / 1e6:.2f}"
          f" M, D {n_params[1] / 1e6:.2f} M, DP {n_params[2] / 1e6:.2f} M "
          f"params, built in {time.perf_counter() - t0:.1f} s", flush=True)
    delta = cfg.batch_size / (cfg.ada_kimg * 1000)
    torch.cuda.reset_peak_memory_stats()
    bench_train.reset_kernel_counts()

    def stepped(p0, metrics):
        """Finite metrics; ada_p moved by exactly one controller step, or
        stayed where the clip to [0, 1] holds it."""
        for k, v in metrics.items():
            check(np.isfinite(v), f"train metric {k} = {v}")
        p1 = metrics["ada_p"]
        moved = abs(p1 - p0)
        check(abs(moved - delta) <= 1e-12 or (moved == 0 and p1 in (0, 1)),
              f"ada_p {p0} -> {p1}, step {delta}")
        return p1

    t0 = time.perf_counter()
    _, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    p = stepped(cfg.augment_p_init, metrics)
    host, dev, steps = bench_train.timed_steps(step, state, batch, gen,
                                               N_TRAIN_TIMED)
    for metrics in steps:
        p = stepped(p, metrics)
    host_r1, dev_r1, (metrics_r1,) = bench_train.timed_steps(
        step, state, batch, gen, 1, do_r1=True)
    stepped(p, metrics_r1)
    counts = bench_train.kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = [_flat_params(m) for m in (state.g, state.d, state.dp)]
    for name, b, a in zip(("G", "D", "DP"), before, after):
        check(bool(torch.isfinite(a).all()), f"{name} parameters not finite")
        check(bool((a != b).any()), f"{name} parameters did not change")
    n_steps = 1 + N_TRAIN_TIMED + 1       # every step runs the main phases
    want = (n_steps * TRAIN_K1_FWD + R1_K1_FWD, n_steps * TRAIN_K1_DX
            + R1_K1_DX, n_steps * TRAIN_K2 + R1_K2, n_steps * TRAIN_K3
            + R1_K3)
    check(counts == want, f"train launches K1 fwd/dX, K2, K3 {counts} != "
          f"{want}")
    # R1 differentiates D and DP only (bf16): no fp32 launch is added
    n_fp32 = k1.conv3x3_valid.launches_fp32
    check(n_fp32 == n_steps * TRAIN_K1_FP32,
          f"K1 fp32 launches {n_fp32} != {n_steps} x {TRAIN_K1_FP32}")
    print(f"[train] warm-up {t_warm:.2f} s | regular x{N_TRAIN_TIMED}: "
          f"{host:.4f} s/step host, {dev:.4f} s/step CUDA events, "
          f"{host * 1000 / cfg.batch_size:.1f} sec/kimg | R1 step "
          f"{host_r1:.4f} s host, {dev_r1:.4f} s events | peak {peak:.2f} "
          f"GiB | launches K1 fwd {counts[0]}, K1 dX {counts[1]}, K2 "
          f"{counts[2]}, K3 {counts[3]} over {n_steps} steps (K1 fp32 "
          f"{n_fp32}, bf16 {counts[0] + counts[1] - n_fp32}) | ada_p "
          f"{state.ada_p:.6g} | r1 {metrics_r1['r1_penalty']:.4g} dp_r1 "
          f"{metrics_r1['dp_r1_penalty']:.4g} | metrics {metrics}",
          flush=True)
    del state, step, batch, before, after
    torch.cuda.empty_cache()
    return counts, n_fp32


def phase_train_check():
    """Per-phase losses and gradients of one fp32 step at the narrow 64px
    config (ada_p 0, no noise) on the card against the same on the CPU,
    which the CPU tests hold against the JAX package."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import phase_losses

    cfg = smoke_config(1, batch_size=4, use_noise=False, vgg_weight=20.0,
                       vgg_bf16=False)
    res = {}
    for dev in ("cuda", "cpu"):
        state = init_state(cfg, seed=0, device=dev)
        vgg = VGG19Features(seed=3).to(dev).requires_grad_(False)
        batch = batch_to(example_batch(cfg, np.random.RandomState(0)), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        res[dev] = phase_losses(cfg, state, batch, gen, vgg)
    worst = []
    for phase in res["cpu"]:
        (lg, _, gg), (lc, _, gc) = res["cuda"][phase], res["cpu"][phase]
        lerr = abs(lg.item() - lc.item()) / max(abs(lc.item()), 1e-6)
        gnum = sum(((a.cpu() - b).square().sum() for a, b in zip(gg, gc)))
        gden = sum((b.square().sum() for b in gc))
        gerr = (gnum / gden.clamp_min(1e-30)).sqrt().item()
        # the CPU tests' budgets: losses 1e-3 relative, gradients 2e-2 of
        # their norm (the bf16 two-pass augment rounds differently)
        check(lerr <= 1e-3 and gerr <= 2e-2,
              f"train-check {phase}: loss rel {lerr}, grad rel {gerr}")
        worst.append(f"{phase} loss {lerr:.2g} grad {gerr:.2g}")
    print(f"[train-check] narrow 64px fp32 card vs CPU, relative: "
          f"{' | '.join(worst)}", flush=True)


def main():
    smi = phase_device()
    from pasta_tpu_torch.ops import affine_warp as shift
    from pasta_tpu_torch.ops import conv3x3 as k1

    phase_build(k1, shift)
    rows = phase_kernel(k1, BATCH)
    launches = phase_main(k1, BATCH, N_TIMED)
    phase_check()
    train_rows = phase_kernel_train(k1, shift)
    counts, n_fp32 = phase_train(k1)
    phase_train_check()
    k1_rows = rows + train_rows["K1"]

    def total(rs, key):
        return sum(r[key] for r in rs)

    def entry(name, source, replaces, launched, rs, **extra):
        """Sums over the shapes held against plain above; `bound_by` is the
        side (operations or bytes) that makes up more of the summed bound."""
        by = collections.Counter()
        for r in rs:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in rs]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launched,
                    max_abs_err=max(r["err"] for r in rs),
                    ms=total(rs, "ms"), plain_ms=total(rs, "plain_ms"),
                    bound_ms=total(rs, "bound_ms"),
                    bound_by=by.most_common(1)[0][0],
                    library_ms=None if None in lib else sum(lib), **extra)

    fp32 = [r for r in k1_rows if r["dtype"] == torch.float32]
    bf16 = [r for r in k1_rows if r["dtype"] == torch.bfloat16]
    k1_total = counts[0] + counts[1]
    print(json.dumps({"kernels": [
        entry("conv3x3_valid", "pasta_tpu_torch/csrc/conv3x3.cu",
              "pasta_tpu/ops/pallas_conv.py:139", launches + k1_total,
              k1_rows, launches_serving=launches, launches_train=counts[0],
              launches_dx=counts[1], launches_train_fp32=n_fp32,
              launches_train_bf16=k1_total - n_fp32,
              ms_fp32=total(fp32, "ms"), ms_bf16=total(bf16, "ms"),
              bound_ms_fp32=total(fp32, "bound_ms"),
              bound_ms_bf16=total(bf16, "bound_ms"),
              library_ms_fp32=total(fp32, "library_ms"),
              library_ms_bf16=total(bf16, "library_ms")),
        entry("shift_fwd", "pasta_tpu_torch/csrc/shift.cu",
              "pasta_tpu/ops/affine_warp.py:142", counts[2],
              train_rows["K2"]),
        entry("shift_bwd", "pasta_tpu_torch/csrc/shift.cu",
              "pasta_tpu/ops/affine_warp.py:181", counts[3],
              train_rows["K3"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
