"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives pasta_tpu_torch's 512px try-on serving path (TryonPipeline.run_batch,
full fashion Generator config, num_bf16_res=3, seeded random weights,
seeded synthetic records) on the card, in phases:

  1. device  -- fails without CUDA; prints the card's name and power limit
  2. build   -- compiles the K1 kernel (csrc/conv3x3.cu) from the sources
  3. kernel  -- K1 against its plain PyTorch version at the main path's
                shapes (bf16), with the error bound and CUDA-event times
  4. main    -- run_batch on tiled and full-path batches; K1's launch count
                must equal its in-scope convs per batch; img/s, peak memory
  5. check   -- a small fp32 run on the card against the same run on the CPU

Run from the repository root:  python3 chip_smoke.py
The last line of standard output is {"ok": true, "device": {...}}; the line
before it, the K1 summary {"kernels": [...]}. Any failure exits non-zero.
"""

from __future__ import annotations

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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` launches (CUDA events)."""
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


def phase_build(k1):
    _, seconds, log = k1.build()
    print(f"[build] K1 csrc/conv3x3.cu -> sm_90a in {seconds:.2f} s",
          flush=True)
    name = "?"
    for line in log.splitlines():          # ptxas -v: registers and spills
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
            name = f"bf16<C_in {t[1]}, BN {t[2]}>" if t else "fp32"
        elif "registers" in line or "spill stores" in line:
            print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")


def phase_kernel(k1, batch):
    """K1 vs conv3x3_valid_plain in bf16 at the main path's shapes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)) if same else x
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
        iters = 10
        t_plain1 = cuda_ms(lambda: k1.conv3x3_valid_plain(xp, wt), iters)
        t_k1a = cuda_ms(lambda: k1.conv3x3_valid(xp, wt), iters)
        t_k1b = cuda_ms(lambda: k1.conv3x3_valid(xp, wt), iters)
        t_plain2 = cuda_ms(lambda: k1.conv3x3_valid_plain(xp, wt), iters)
        t_k1 = (t_k1a + t_k1b) / 2
        t_plain = (t_plain1 + t_plain2) / 2
        flop = 2 * n * (xp.shape[1] - 2) * (xp.shape[2] - 2) * ci * co * 9
        print(f"[kernel] [{n},{xp.shape[1]},{xp.shape[2]},{ci}]->{co} "
              f"max_abs_err {err:.6g} (vs fp32 {err32:.6g}, bound "
              f"{bound:.6g}) | K1 {t_k1:.4f} ms {flop / t_k1 / 1e9:.1f} "
              f"TFLOP/s | plain {t_plain:.4f} ms {flop / t_plain / 1e9:.1f} "
              f"TFLOP/s", flush=True)
        rows.append((err, t_k1, t_plain))
        del x, xp, got, plain, ref32
    # the fp32 FMA variant, at a short shape
    x = torch.randn(2, 34, 70, 64, device=dev, generator=g)
    wt = torch.randn(3, 3, 64, 100, device=dev, generator=g) / 24
    e = (k1.conv3x3_valid(x, wt) - k1.conv3x3_valid_plain(x, wt)).abs().max()
    check(e.item() <= 1e-4, f"K1 fp32 variant err {e.item()}")
    print(f"[kernel] fp32 variant [2,34,70,64]->100 max_abs_err "
          f"{e.item():.3g} (bound 1e-4)", flush=True)
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


def main():
    smi = phase_device()
    from pasta_tpu_torch.ops import conv3x3 as k1

    phase_build(k1)
    rows = phase_kernel(k1, BATCH)
    launches = phase_main(k1, BATCH, N_TIMED)
    phase_check()
    print(json.dumps({"kernels": [{
        "name": "conv3x3_valid",
        "route": "cuda",
        "source": "pasta_tpu_torch/csrc/conv3x3.cu",
        "replaces": "pasta_tpu/ops/pallas_conv.py:139",
        "launches": launches,
        "max_abs_err": max(r[0] for r in rows),
        "ms": sum(r[1] for r in rows),
        "plain_ms": sum(r[2] for r in rows),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
