"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives pasta_tpu_torch's main paths on the card -- 512px try-on serving
(TryonPipeline.run_batch, fashion Generator config, num_bf16_res=3), the
try-on inference run through cli/test.py (both pipelines, run_stream), the
512px training step of the fashion preset (batch 4, G/D/DP phases, lazy R1,
EMA, ADA), a training run through the command line (dataset files on
disk, both loaders, the loop, snapshots, an exact resume) and the training
options (grad_accum, Gpl, the contextual loss, the doubled parsing-D
phase, freeze-D, the shared and the reused fakes), data-parallel training
over ranks, evaluation (cli.calc_metrics's five metrics and the
in-training metrics of cli.train), the training run's try-on grid and
trace, the patch D and the legacy layers, and a serving batch split over devices
(TryonPipeline(mesh=...)) -- with seeded random weights and seeded
synthetic inputs, in phases:

  1. device      -- fails without CUDA; prints the card's name, power limit
  2. build       -- compiles csrc/conv3x3.cu (K1), csrc/shift.cu (K2, K3),
                    csrc/upfirdn2d.cu (the FIR resampling kernel) and
                    csrc/spade_norm.cu (the SPADE pair) from the sources,
                    in parallel; registers and spills
                    (none allowed in K1's kernels), the fp32 kernel's blocks
                    per SM, the bf16 kernel's tile waste at four widths
  3. kernel      -- K1 against its plain version at the serving shapes
                    (bf16) and, in bf16 and fp32, at two ragged shapes, with
                    the error bound and CUDA-event times
 3b. kernel-fir  -- the FIR resampling kernel: one eager serving forward at
                    batch 8 (fp32, published widths) launches it 28 times
                    and takes the plain route never; each of its calls, and
                    D's filter pass and skip down 2 at batch 4 (top three
                    resolutions, bf16 and fp32) and their input gradients,
                    against upfirdn2d_plain forward, input gradient and
                    double backward (fp32 1e-5, bf16 2^-7 of the scale);
                    each call's time beside its byte bound, the plain
                    version's and cuDNN's grouped conv alone
 3c. kernel-spade -- the SPADE pair (csrc/spade_norm.cu): one fp32 serving
                    batch of 8 (published widths, run_batch on one card)
                    launches it 21 times in its eager run and takes the
                    plain chain never, and two replays of its CUDA graph
                    trace 21 of its kernels each; each of its calls,
                    and [8,512,512,64] with an NHWC gb and [8,256,256,128]
                    with an NCHW-backed gb where the batch makes no such
                    call, forward, dx and dgb, against
                    spade_norm_act_plain's autograd
                    (fp32: y and dgb 1e-5, dx 1e-4 of the scale, the
                    gradients away from the relu / clamp kinks), twice
                    bit for bit; forward and backward timed in turns with
                    the plain chain, beside their byte bound
  4. main        -- run_batch on tiled and full-path batches; K1's and the
                    FIR kernel's kernels in a CUDA trace of those batches
                    (CUDA graph replays) must number their calls per batch
                    (26 and 28), and the FIR counters from 0 before the
                    first batch 28 launches for each eagerly run batch
                    key, none plain; the SPADE counters from 0 (the bf16
                    blocks keep the chain): no launch, 9 plain calls for
                    each eagerly run batch key, none of its kernels traced
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
                    K1 forward / K1 dX / K2 / K3 launch counts, the FIR
                    kernel's from 0 before the warm-up step (each regular
                    step the warm-up's, more gradient launches in the R1
                    step, R1's double backward; none plain), the SPADE
                    pair's likewise (G's forwards 21 launches each, its
                    backward 27; the R1 step a regular step's), the dy
                    and gb layouts G's backward hands the pair; s/step,
                    sec/kimg, peak memory
  8. train-check -- one fp32 step's per-phase losses and gradients at the
                    narrow 64px config (no noise), card against CPU: at
                    ada_p 0, and at ada_p 1 with the augment's
                    debug_percentile, so that K2/K3 shift rows by real
                    offsets inside a step
  9. train-run   -- writes a synthetic dataset root of 24 persons (directory
                    and zip); the loaders' items/s with 1 and 8 threads;
                    upload + assembly ms a batch; the device assembler on
                    the card against the CPU and against the host loader;
                    then cli.train.main on the card, fashion preset, batch
                    4: 6 steps with the device loader on the zip, and a
                    resume from its checkpoint for 3 more with the host
                    loader on the directory. Holds stats.jsonl, the grids,
                    the checkpoint, the resume bit-equal to what was saved,
                    and K1 / K2 / K3 launches per step equal to phase 7's;
                    then a run with --pl_weight 2 --contextual_weight 1
                    --grad-accum 2 for 4 steps (Gpl and R1 at step 0): its
                    launches, pl_penalty in stats.jsonl, pl_mean in the
                    checkpoint
 10. train-options -- options A (grad_accum 2, Gpl, contextual loss,
                    doubled parsing D, freeze-D 5) at 512 px, batch 4: a
                    regular step and one with Gpl and both R1 phases; exact
                    launches (K1's fp32 share too) and synthesis runs,
                    pl_mean moved, the frozen D layers bit-equal with no
                    Adam moments, every other D parameter moved; s/step,
                    peak memory. Then B (strict_phase_noise=False) with and
                    without reuse_g_fakes beside the default preset, timed
                    in turns, with their launches, synthesis runs and peak
                    memory, and the no-grad G draws B and reuse drop. The
                    phase's launches are those of its steps alone
 11. options-kernels -- every shape K1, K2 and K3 took in phase 10 (G at a
                    microbatch of 2, Gpl's style branch and its double
                    backward, D per microbatch, ...) against plain
 12. options-check -- A, B and B with reuse at 512 px, narrow widths, fp32,
                    batch 2: one whole step card against CPU; A's per-phase
                    losses and gradients (Gpl's, the contextual term's) at
                    64 px
 13. dist        -- data parallelism (train/entry.py, train/dist.py), each
                    part in processes of its own: (i) the narrow fp32 step
                    (phase 8's config, batch 4, both R1 phases) in an NCCL
                    group of one rank, bit-equal to the same step without a
                    group (run twice, deterministic cuDNN, to show that it
                    reproduces); (ii) two gloo ranks on CUDA tensors on the
                    one card, 2 rows each, against (i)'s step at the
                    global batch (phase 12's whole-step budget), the ranks
                    bit-equal, each rank's K1 / K2 / K3 launches equal to
                    one process's; (iii) with two cards or more, min(4,
                    cards) NCCL ranks at the fashion preset, batch 4 a
                    card (cli/bench_train.py --devices): a warm-up, 3
                    regular steps and an R1 step, s/step, sec/kimg of the
                    global batch, each phase's all-reduce ms, peak GiB and
                    launches per rank (one card's, exactly); on one card a
                    line says that (iii) needs more
 14. inference   -- the try-on run as users start it: whether the native
                    plugin built (else its build error); a synthetic root
                    of 16 persons with a test_pairs.txt of 16 pairs;
                    cli.test.main at batch 8 with --pipeline parity (fp32),
                    --pipeline serving --g-bf16-res 3 and --pipeline
                    serving in fp32: one composite PNG per pair of its
                    size, finite outputs, K1's kernels in a CUDA trace of
                    each run (26 a batch, all fp32 where the generator is,
                    a CUDA graph's replays among them), serving in fp32 against
                    parity within the serving budget (bf16 serving's gap
                    printed); every K1 shape those runs launched against
                    plain with times, bound and cuDNN's (fp32 also at N =
                    1); run_stream over 32 pairs against run_batch on the
                    same items, bit for bit, img/s of each and of
                    run_stream with 1, 2 and 4 prep threads; host prep
                    pairs/s at 1 and 8 threads with the plugin and
                    without; cli/bench.py's JSON line
 15. evaluation  -- seeded detectors at full width written as .npz;
                    cli.test --pipeline serving --g-bf16-res 3 on a root of
                    16 persons, each with 4 others' garments (64
                    composites; K1's kernels in its trace, 26 a batch);
                    cli.calc_metrics --metrics
                    fid,kid,inception_score,pr,ppl --crop-generated
                    against the persons' real images (pr on VGG16 fc7, ppl
                    on VGG16 LPIPS over the fashion Generator), each
                    value finite, each metric's seconds, K1 launches = 4 a
                    Inception batch + 3 a VGG16 one + 26 a generator
                    forward; FID of the reals against themselves within
                    1e-3; Inception features card vs CPU within 1e-4 of
                    their scale; the detectors' images/s at batch 32;
                    cli.train (fashion, batch 4, 2 steps) with --metrics
                    fid,kid,fid_tryon --metric-items 16 --metric-ticks 1:
                    the metrics in stats.jsonl, no held-out item sampled,
                    one evaluation's seconds, exact launches; every K1
                    shape the detectors launched (Inception 64->96 at
                    35x35, VGG16 at 224 and LPIPS at 256) against plain,
                    timed in turns with plain and cuDNN, with its bound
 16. surface     -- cli.dataset_tool packs a synthetic root into a zip
                    and cli.train --data <zip> runs 2 steps at 512 px with
                    --tryon-grid 3 --trace DIR (the grid's size and
                    seconds, the Chrome trace parsed and naming K1, exact
                    launches); the patch D and five legacy layers forward
                    and backward, card against CPU (1e-5 of the scale)
 17. mesh        -- TryonPipeline(mesh=...) with the fashion G in fp32 and
                    in bf16 (top 3), batch 8 a shard, noise strengths 0.05:
                    (a) [cuda:0], its model copied from the host, bit-equal
                    to the pipeline without a mesh, "const" and "random";
                    (b) [cuda:0, cuda:0] against batch 8 at the JAX
                    package's split budget (mean 1e-4 of the range, 1e-3
                    of values off by 1%), max diff and bit-equality
                    printed; (c) run_stream through it over 64 pairs
                    bit-equal to its run_batch; (d) K1's launches, 26 a
                    shard, exact; (e) with two cards or more, min(4, cards)
                    cards against one card at the same global batch, with
                    run_batch and run_stream img/s, the host's ms to queue
                    a batch and each card's idle share, K1 launched on
                    each card against plain; one card prints that (e)
                    needs more. Before (b): K1 at N = 4 bit-equal to rows
                    of N = 8 at the serving shapes, and the first modules
                    of the G whose outputs part between batch 4 and 8
                    (printed)

Run from the repository root:  python3 chip_smoke.py
(`--only spade`: phases 1, 2, 3c, 4 and 7 alone; `--only mesh`: phase 17.)
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
import contextlib
import copy
import functools
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
K1_KERNELS = ("conv3x3_f32_kernel", "conv3x3_bf16_kernel")

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

# The FIR resampling kernel's calls in one serving forward (all in its
# scope): the synthesis blocks' conv0 and torgb's image upsamples, up 2, 7
# each; the filter pass ahead of every stride-2 conv of the encoders and
# the SPADE encoder, 13; the SPADE encoder's 1x1 skip, down 2, 1. And D's
# resampling at the training batch and its top three resolutions: the
# filter pass ahead of conv1's stride-2 conv and the skip's down 2.
FIR_PER_BATCH = 28
FIR_KERNEL = "upfirdn2d_kernel"
FIR_D_SHAPES = ((TRAIN_BATCH, 512, 512, 64), (TRAIN_BATCH, 256, 256, 128),
                (TRAIN_BATCH, 128, 128, 256))
FIR_D_CALLS = ((1, (2, 2, 2, 2)), (2, (1, 1, 1, 1)))     # (down, padding)
# fp32: sums of at most 16 products in another order; bf16: the kernel's
# one rounding of an fp32 sum against the plain version in fp32 on the
# same rounded inputs and taps
FIR_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
FIR_ITERS = 20

# The SPADE pair in one fp32 serving forward: each of the three SPADE
# res-blocks takes the moments of its x once for spade_skip and spade0 and
# once for spade1's x (two launches each: the blocks' partials, their
# merge) and runs three applies (one each): 21 launches, 9 calls. A
# backward launches 3 a call, 27 for G's.
SPADE_PER_BATCH = 21
SPADE_CALLS = 9
SPADE_BWD = 27
SPADE_KERNEL = "spade_norm"
# the calls the kernels were designed for, checked and timed whether or not
# a serving batch makes them: texture_b512's 64 channels with K1's NHWC gb,
# spade_b256's 128 with an NCHW-backed gb (a permuted F.conv2d output)
SPADE_SHAPES = (((BATCH, 512, 512, 64), "nhwc"),
                ((BATCH, 256, 256, 128), "nchw"))
# fp32, of the plain chain's scale (the card tests' tolerances): y and dgb
# 1e-5, the moments summed in another order; dx 1e-4, since an element
# next to a kink moves its (n, c)'s two sums. The gradients are compared
# away from the relu and clamp kinks (under 1e-3 of the elements), where
# the routes may round to either side.
SPADE_TOL, SPADE_DX_TOL = 1e-5, 1e-4
SPADE_ITERS = 20

# The training options (phase 10), each on the fashion preset at batch 4.
# A: every option that changes the step's work but the shared fakes; B: the
# shared no-grad forward of the D phases, with and without Gmain's own
# fakes in its place; C: the options of the command-line run.
OPTIONS = {
    "A": dict(grad_accum=2, pl_weight=2.0, contextual_weight=1.0,
              double_d_parsing=True, freeze_d_layers=5),
    "B": dict(strict_phase_noise=False),
    "B reuse": dict(strict_phase_noise=False, reuse_g_fakes=True),
    "C": dict(grad_accum=2, pl_weight=2.0, contextual_weight=1.0),
}
# (K1 fwd, K1 dX, K2, K3, K1 fp32) of one step, by options and the lazy
# phases it runs; tests/test_torch_train_options_parts.py counts the same
# on the CPU at 32 px, where the same convs lie in K1's scope.
#   grad_accum 2: two microbatches of 2, each with Gmain, Dmain and DPmain,
#     the D calls apart (the mbstd group of 4 exceeds 2): 77 fwd, 45 dX,
#     10 K2, 4 K3 each.
#   Gpl: +3 fwd (the style branch on 2 samples), +9 dX (its first backward
#     through those 3 convs, the second through the forward's and the
#     first backward's), all fp32.
#   contextual: +6 fwd (VGG19's 3 on finetune and on real), +3 dX, fp32.
#   double_d_parsing: +1 DPmain (3 fwd of the style branch + the DP's).
#   freeze_d_layers 5: Dmain's backward stops above b512 and b256.conv0,
#     so Dmain's D dX go, and Dr1 loses 2 of its 12 dX.
#   shared fakes: one full G forward (26) in place of Dmain's (26) and
#     DPmain's style branch (3); with reuse neither runs.
STEP_LAUNCHES = {
    ("default", "regular"): (TRAIN_K1_FWD, TRAIN_K1_DX, TRAIN_K2, TRAIN_K3,
                             TRAIN_K1_FP32),
    ("default", "r1"): (TRAIN_K1_FWD + R1_K1_FWD, TRAIN_K1_DX + R1_K1_DX,
                        TRAIN_K2 + R1_K2, TRAIN_K3 + R1_K3, TRAIN_K1_FP32),
    ("A", "regular"): (180, 92, 20, 8, 204),
    ("A", "pl"): (183, 101, 20, 8, 216),
    ("A", "pl_r1"): (187, 111, 24, 10, 216),
    ("B", "regular"): (66, 37, 4, 2, 87),
    ("B reuse", "regular"): (40, 37, 4, 2, 61),
    ("C", "regular"): (166, 96, 20, 8, 198),
    ("C", "pl_r1"): (173, 117, 24, 10, 210),
}
# runs of G's synthesis network in one regular step (a hook counts them):
# strict draws for Gmain, Dmain and DPmain (its style branch); A each per
# microbatch, DPmain twice, one more for Gpl
SYNTHESIS_RUNS = {"default": 3, "B": 2, "B reuse": 1, "A": 8}
N_TURNS = 2        # steps of each of default, B, B reuse per turn


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


def turns(plain, kernel, iters, ahead=False):
    """(kernel ms, plain ms) timed in turns plain-kernel-kernel-plain."""
    p1 = cuda_ms(plain, iters, ahead)
    k1 = cuda_ms(kernel, iters, ahead)
    k2 = cuda_ms(kernel, iters, ahead)
    p2 = cuda_ms(plain, iters, ahead)
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


def phase_build(k1, shift, fir, sn):
    """The sources compile at once, one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = {"K1 csrc/conv3x3.cu": pool.submit(k1.build),
                "K2/K3 csrc/shift.cu": pool.submit(shift.build),
                "FIR csrc/upfirdn2d.cu": pool.submit(fir.build),
                "SPADE csrc/spade_norm.cu": pool.submit(sn.build)}
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


def _fir_counts(fir):
    """The FIR kernel's (launches, gradient launches, plain calls)."""
    u = fir.upfirdn2d
    return u.launches, u.launches_bwd, u.launches_plain


def _fir_reset(fir):
    u = fir.upfirdn2d
    u.launches = u.launches_bwd = u.launches_plain = 0


def _fir_three_ways(fir, x0, f, p, g):
    """The largest error, over the plain version's scale, of the kernel's
    forward, input gradient and gradient of that gradient (the Function's,
    as R1 runs it) against the plain version's in fp32 on the same rounded
    inputs and taps; each held to FIR_TOL, and the kernel launched once
    forward and twice for the gradients, never plain."""
    dtype, dev = x0.dtype, x0.device
    fr = None if f is None else f.to(dtype).float()
    before = _fir_counts(fir)
    x = x0.clone().requires_grad_(True)
    y = fir._Upfirdn2d.apply(x, f, p, False)
    dy0 = torch.randn(y.shape, generator=g, device=dev).to(dtype)
    v0 = torch.randn(x0.shape, generator=g, device=dev).to(dtype)
    dy = dy0.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
    (ddy,) = torch.autograd.grad(dx, dy, v0)
    counts = tuple(a - b for a, b in zip(_fir_counts(fir), before))
    xr = x0.float().requires_grad_(True)
    yr = fir._plain(xr, fr, p)
    dyr = dy0.float().requires_grad_(True)
    (dxr,) = torch.autograd.grad(yr, xr, dyr, create_graph=True)
    (ddyr,) = torch.autograd.grad(dxr, dyr, v0.float())
    errs = []
    for what, got, want in (("forward", y, yr), ("dX", dx, dxr),
                            ("ddY", ddy, ddyr)):
        want = want.detach()
        check(got.shape == want.shape and got.dtype == dtype
              and got.is_contiguous(),
              f"FIR {what} {list(x0.shape)} {p[:8]}: {got.dtype} "
              f"{tuple(got.shape)}, plain {tuple(want.shape)}")
        e = ((got.float() - want).abs().max() / want.abs().max()).item()
        check(e <= FIR_TOL[dtype], f"FIR {what} {str(dtype)[6:]} "
              f"{list(x0.shape)} {p[:8]}: error {e:.3g} of the scale > "
              f"{FIR_TOL[dtype]:.3g}")
        errs.append(e)
    check(counts == (1, 2, 0), f"FIR {list(x0.shape)} {p[:8]}: launches, "
          f"gradient launches, plain {counts} != (1, 2, 0)")
    return max(errs)


def _fir_library(x, f, p):
    """cuDNN's depthwise conv of the plain version alone: its prepared
    input (zero-inserted, padded, cropped, NCHW) and repeated taps made here,
    outside the timing."""
    F = torch.nn.functional
    upx, upy, downx, downy, px0, px1, py0, py1, flip, gain = p
    n, h, w, c = x.shape
    xn = x.permute(0, 3, 1, 2)
    if upx > 1 or upy > 1:
        xn = F.pad(xn.reshape(n, c, h, 1, w, 1),
                   [0, upx - 1, 0, 0, 0, upy - 1]).reshape(
                       n, c, h * upy, w * upx)
    xn = F.pad(xn, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    xn = xn[:, :, max(-py0, 0):xn.shape[2] - max(-py1, 0),
            max(-px0, 0):xn.shape[3] - max(-px1, 0)].contiguous()
    taps = f if flip else f.flip([0, 1])
    wk = (taps * gain).to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return lambda: F.conv2d(xn, wk, stride=(downy, downx), groups=c)


def _fir_row(fir, tag, x, f, p, calls, g):
    """One FIR call checked three ways (`_fir_three_ways`) and timed: the
    kernel and the plain version in turns, cuDNN's grouped conv alone, the
    bound (input and output once over the device memory rate); times for
    `calls` such calls."""
    err = _fir_three_ways(fir, x, f, p, g)
    with torch.no_grad():
        out = fir._kernel(x, f, p)
        t_k, t_plain = turns(lambda: fir._plain(x, f, p),
                             lambda: fir._kernel(x, f, p), FIR_ITERS, True)
        t_lib = cuda_ms(_fir_library(x, f, p), FIR_ITERS, True)
    t_bound = ((x.numel() + out.numel()) * x.element_size()
               / HBM_BYTES_PER_S * 1e3)
    print(f"[kernel-fir] {tag} {str(x.dtype)[6:]} {list(x.shape)}->"
          f"{list(out.shape)} up {p[:2]} down {p[2:4]} pad {p[4:8]}"
          f"{' x' + str(calls) if calls > 1 else ''} | error {err:.3g} of "
          f"the scale | kernel {t_k:.4f} ms, bound {t_bound:.4f} ms "
          f"({100 * t_bound / t_k:.1f}%) | plain {t_plain:.4f} ms | library "
          f"(grouped conv) {t_lib:.4f} ms", flush=True)
    return row(err, calls * t_k, calls * t_plain, calls * t_bound, "bytes",
               calls * t_lib, x.dtype)


def _fir_serving_calls(fir, batch):
    """(shape, dtype, filter, parameters) of every FIR call of one serving
    forward at `batch` (the fashion generator at published widths, fp32,
    through a one-card mesh, which runs eagerly), with the counters at 0
    just before it: FIR_PER_BATCH launches, none for a gradient, none
    plain."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0).eval().to("cuda")
    pipe = TryonPipeline(model, mode="upper", mesh=["cuda"])
    items = _items(pipe, range(batch), 3.0)
    seen, launch = [], fir._launch

    def record(x, f, p, bwd):
        seen.append((tuple(x.shape), x.dtype, f, p))
        return launch(x, f, p, bwd)

    _fir_reset(fir)
    fir._launch = record
    try:
        with pipe:
            pipe.run_batch(items)
        torch.cuda.synchronize()
    finally:
        fir._launch = launch
    counts = _fir_counts(fir)
    check(counts == (FIR_PER_BATCH, 0, 0) and len(seen) == FIR_PER_BATCH,
          f"serving forward at batch {batch}: FIR launches, gradient "
          f"launches, plain {counts}, calls {len(seen)}; want "
          f"({FIR_PER_BATCH}, 0, 0)")
    del model, pipe
    torch.cuda.empty_cache()
    return seen


def phase_kernel_fir(fir, batch):
    """The FIR kernel at every call of a serving forward at `batch` and at
    D's resampling at the training batch, forward and input gradient,
    against its plain version. Returns (its rows, the serving forward's
    rows)."""
    from pasta_tpu_torch.ops import setup_filter

    dev = torch.device("cuda")
    calls = _fir_serving_calls(fir, batch)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (shape, dtype, p), k in collections.Counter(
            (c[0], c[1], c[3]) for c in calls).items():
        f = next(c[2] for c in calls if (c[0], c[1], c[3]) == (shape, dtype, p))
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        rows.append(_fir_row(fir, "serving", x, f, p, k, g))
    serving = list(rows)
    f = setup_filter([1, 3, 3, 1]).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in FIR_D_SHAPES:
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for down, pad in FIR_D_CALLS:
                p = (1, 1, down, down, *pad, False, 1.0)
                rows.append(_fir_row(fir, "D", x, f, p, 1, g))
                out_hw = fir._out_hw(shape[1], shape[2], f, p)
                dy = torch.randn((shape[0], *out_hw, shape[3]), generator=g,
                                 device=dev).to(dtype)
                t = fir._transposed(p, f, shape[1:3], out_hw)
                rows.append(_fir_row(fir, "D dX", dy, f, t, 1, g))
                del dy
            del x
    sums = {k: sum(r[k] for r in serving)
            for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    print(f"[kernel-fir] serving forward at batch {batch}: {FIR_PER_BATCH} "
          f"calls, {len(serving)} distinct | kernel {sums['ms']:.4f} ms, "
          f"bound {sums['bound_ms']:.4f} ms "
          f"({100 * sums['bound_ms'] / sums['ms']:.1f}%) | plain "
          f"{sums['plain_ms']:.4f} ms | library {sums['library_ms']:.4f} ms",
          flush=True)
    torch.cuda.empty_cache()
    return rows, serving


def _spade_counts(sn):
    """The SPADE pair's (launches, gradient launches, plain calls)."""
    f = sn.spade_norm_act
    return f.launches, f.launches_bwd, f.launches_plain


def _spade_reset(sn):
    f = sn.spade_norm_act
    f.launches = f.launches_bwd = f.launches_plain = 0


def _spade_layout(gb_strides):
    """"nhwc" where gb's channels are contiguous (read as vectors), else
    "nchw" (W contiguous: staged through shared memory)."""
    return "nhwc" if gb_strides[3] == 1 else "nchw"


def _spade_serving_calls(sn, batch):
    """(x shape, gb layout, gain, clamp) of every SPADE call of one fp32
    serving batch at `batch` (the fashion generator at published widths,
    run_batch on one card), with the counters at 0 just before it: its
    eager run SPADE_PER_BATCH launches, none for a gradient, none plain,
    its capture none counted; then two replays of its CUDA graph, in a
    trace, SPADE_PER_BATCH of the pair's kernels each and no count."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0).eval().to("cuda")
    pipe = TryonPipeline(model, mode="upper")
    items = _items(pipe, range(batch), 3.0)
    seen, apply = [], sn._apply

    def record(x, gb, mean, rstd, gain, clamp):
        if not sn._capturing(x):
            seen.append((tuple(x.shape), _spade_layout(gb.stride()), gain,
                         clamp))
        return apply(x, gb, mean, rstd, gain, clamp)

    _spade_reset(sn)
    sn._apply = record
    try:
        pipe.run_batch(items)            # the eager run, then the capture
        torch.cuda.synchronize()
    finally:
        sn._apply = apply
    counts = _spade_counts(sn)
    check(counts == (SPADE_PER_BATCH, 0, 0) and len(seen) == SPADE_CALLS,
          f"fp32 serving batch of {batch}: SPADE launches, gradient "
          f"launches, plain {counts}, calls {len(seen)}; want "
          f"({SPADE_PER_BATCH}, 0, 0), {SPADE_CALLS} calls")
    with _k1_traced("cuda") as traced:
        for _ in range(2):
            pipe.run_batch(items)
    check(traced["spade"] == 2 * SPADE_PER_BATCH
          and _spade_counts(sn) == counts,
          f"two replays: SPADE kernels traced {traced['spade']} != 2 x "
          f"{SPADE_PER_BATCH}, or counted {_spade_counts(sn)}")
    print(f"[kernel-spade] fp32 serving batch of {batch}: eager run "
          f"{counts[0]} launches, 0 plain, {len(seen)} calls (x shape, gb "
          f"layout: {dict(collections.Counter(c[:2] for c in seen))}); two "
          f"graph replays: {traced['spade']} of its kernels traced, none "
          f"counted", flush=True)
    del model, pipe
    torch.cuda.empty_cache()
    return seen


def _spade_inputs(shape, layout, g):
    """x, gb (NHWC-contiguous, or the permuted view of an NCHW tensor) and
    dy on the card."""
    n, h, w, c = shape
    x = torch.randn(shape, generator=g, device="cuda") * 3 + 1
    if layout == "nhwc":
        gb = torch.randn((n, h, w, 2 * c), generator=g, device="cuda")
    else:
        gb = torch.randn((n, 2 * c, h, w), generator=g,
                         device="cuda").permute(0, 2, 3, 1)
    return x, gb * 0.5, torch.randn(shape, generator=g, device="cuda")


def _spade_kinks(x, gb, gain, clamp):
    """Where the affine's output or the scaled relu lies within 1e-4 of a
    kink (relu's 0, the clamp), from float64 moments."""
    c = x.shape[-1]
    x64 = x.double()
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = (x64 - mean).square().mean(dim=(1, 2), keepdim=True)
    gb64 = gb.double()
    z = ((x64 - mean) * torch.rsqrt(var + 1e-5) * (1 + gb64[..., :c])
         + gb64[..., c:])
    del x64, gb64
    u = z.clamp_min(0) * gain
    near = z.abs() < 1e-4
    if clamp is not None:
        near |= (u - clamp).abs() < 1e-4 * clamp
    return near


def _spade_check(sn, x, gb, dy, gain, clamp):
    """The largest error, of the plain chain's scale, of the kernels' y, dx
    and dgb against autograd through spade_norm_act_plain, each held to its
    tolerance; two kernel runs bit for bit; 3 forward and 3 gradient
    launches, none plain."""

    def run(fn):
        xa = x.detach().requires_grad_(True)
        gba = gb.detach().requires_grad_(True)     # keeps gb's strides
        y = fn(xa, gba, gain, clamp)
        y.backward(dy)
        return y.detach(), xa.grad, gba.grad

    before = _spade_counts(sn)
    got = run(sn.spade_norm_act)
    counts = tuple(a - b for a, b in zip(_spade_counts(sn), before))
    again = run(sn.spade_norm_act)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"SPADE {list(x.shape)}: two runs differ")
    del again
    want = run(sn.spade_norm_act_plain)
    kinks = _spade_kinks(x, gb, gain, clamp)
    share = kinks.float().mean().item()
    check(share < 1e-3, f"SPADE {list(x.shape)}: {share:.3g} of the "
          f"elements at a kink")
    errs = []
    for what, a, b, keep, tol in (
            ("y", got[0], want[0], None, SPADE_TOL),
            ("dgb", got[2], want[2], ~torch.cat([kinks, kinks], dim=-1),
             SPADE_TOL),
            ("dx", got[1], want[1], ~kinks, SPADE_DX_TOL)):
        check(a.shape == b.shape and a.dtype == torch.float32,
              f"SPADE {what} {list(x.shape)}: {a.dtype} {tuple(a.shape)}")
        d = (a - b).abs()
        if keep is not None:
            d = d[keep]
        e = d.max().item() / b.abs().max().item()
        check(e <= tol, f"SPADE {what} {list(x.shape)}: error {e:.3g} of "
              f"the scale > {tol:.3g}")
        errs.append(e)
    check(counts == (3, 3, 0), f"SPADE {list(x.shape)}: launches, gradient "
          f"launches, plain {counts} != (3, 3, 0)")
    return max(errs)


def _spade_times(sn, x, gb, dy, gain, clamp):
    """(kernels, plain) ms of the forward (moments and apply, no grad) and
    of the backward (the kernels' three launches; autograd through the
    plain chain), each pair in turns."""
    with torch.no_grad():
        fwd = turns(lambda: sn.spade_norm_act_plain(x, gb, gain, clamp),
                    lambda: sn.spade_norm_act(x, gb, gain, clamp),
                    SPADE_ITERS, True)
        mean, rstd = sn._stats(x)
    gbr, cl = sn._readable(gb), float("inf") if clamp is None else clamp
    xp = x.detach().requires_grad_(True)
    gbp = gb.detach().requires_grad_(True)
    yp = sn.spade_norm_act_plain(xp, gbp, gain, clamp)
    bwd = turns(lambda: torch.autograd.grad(yp, (xp, gbp), dy,
                                            retain_graph=True),
                lambda: sn._backward(dy, x, gbr, mean, rstd, gain, cl),
                SPADE_ITERS, True)
    return fwd, bwd


def phase_kernel_spade(sn, batch):
    """The SPADE pair at every call of an fp32 serving batch at `batch`,
    forward and gradients against the plain chain, timed. Returns (rows
    at the batch's calls: forward, then backward; the eager batch's
    launches; its replays' kernels traced)."""
    calls = _spade_serving_calls(sn, batch)
    cases = collections.Counter(calls)
    for shape, layout in SPADE_SHAPES:     # if not a serving call: x0
        if not any(c[:2] == (shape, layout) for c in calls):
            gain, clamp = next(c[2:] for c in calls if c[0] == shape)
            cases[(shape, layout, gain, clamp)] = 0
    g = torch.Generator(device="cuda").manual_seed(0)
    fwd_rows, bwd_rows = [], []
    for (shape, layout, gain, clamp), k in sorted(cases.items(), key=str):
        x, gb, dy = _spade_inputs(shape, layout, g)
        err = _spade_check(sn, x, gb, dy, gain, clamp)
        (t_f, t_fp), (t_b, t_bp) = _spade_times(sn, x, gb, dy, gain, clamp)
        # x, gb in and y out once: 16 B an element; the backward's dy, x,
        # gb in and dx, dgb out once: 28 B
        b_f = x.numel() * 16 / HBM_BYTES_PER_S * 1e3
        b_b = x.numel() * 28 / HBM_BYTES_PER_S * 1e3
        print(f"[kernel-spade] {list(shape)} gb {layout} gain {gain:.4g} "
              f"clamp {clamp} x{k} | error {err:.3g} of the scale | forward "
              f"{t_f:.4f} ms, bound {b_f:.4f} ms ({100 * b_f / t_f:.1f}%), "
              f"plain {t_fp:.4f} ms | backward {t_b:.4f} ms, bound "
              f"{b_b:.4f} ms ({100 * b_b / t_b:.1f}%), plain {t_bp:.4f} ms",
              flush=True)
        fwd_rows.append(row(err, k * t_f, k * t_fp, k * b_f, "bytes",
                            dtype=torch.float32))
        bwd_rows.append(row(err, k * t_b, k * t_bp, k * b_b, "bytes",
                            dtype=torch.float32))
        del x, gb, dy
        torch.cuda.empty_cache()
    sums = {k: sum(r[k] for r in fwd_rows)
            for k in ("ms", "bound_ms", "plain_ms")}
    # the rows weigh each case by its calls in a batch; each call timed with its own moments; the batch shares one moments
    # pass between spade_skip and spade0 in each of its three blocks
    print(f"[kernel-spade] serving forward at batch {batch}: "
          f"{SPADE_CALLS} calls, {sum(k > 0 for k in cases.values())} "
          f"distinct | kernels "
          f"{sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
          f"({100 * sums['bound_ms'] / sums['ms']:.1f}%) | plain "
          f"{sums['plain_ms']:.4f} ms", flush=True)
    return fwd_rows + bwd_rows, SPADE_PER_BATCH, 2 * SPADE_PER_BATCH


def _items(pipe, seeds, jitter):
    from pasta_tpu_torch.data.synthetic import make_garment, make_person

    return [pipe.prepare(make_person(s, jitter=jitter),
                         make_garment(1000 + s, jitter=jitter))
            for s in seeds]


def phase_main(fir, sn, batch, n_timed):
    """Returns K1's kernels traced, the FIR kernel's (counted launches,
    kernels traced) and the SPADE pair's."""
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

    _fir_reset(fir)
    _spade_reset(sn)
    out = pipe.run_batch(tiled_items)            # warm-up (first launches)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    with _k1_traced(dev) as seen:
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
    launches = seen["launches"]
    fir_counts = _fir_counts(fir)
    spade_counts = _spade_counts(sn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    check(tiled_path and not pipe.last_tiled, "path selection")
    for o in (out, out_full):
        check(tuple(o.shape) == (batch, 512, 512, 3), f"shape {o.shape}")
        check(bool(torch.isfinite(o).all()), "non-finite output")
    n_batches = n_timed + 1
    check(launches == K1_PER_BATCH * n_batches,
          f"K1 kernels traced {launches} != {K1_PER_BATCH} x {n_batches}")
    check(seen["fir"] == FIR_PER_BATCH * n_batches,
          f"FIR kernels traced {seen['fir']} != {FIR_PER_BATCH} x "
          f"{n_batches}")
    # the counters see the eager run ahead of each key's capture: the tiled
    # warm-up and the full path's batch
    check(fir_counts == (2 * FIR_PER_BATCH, 0, 0),
          f"FIR launches, gradient launches, plain {fir_counts} != "
          f"({2 * FIR_PER_BATCH}, 0, 0)")
    # num_bf16_res=3 puts the SPADE res-blocks (256 and 512) in bf16, which
    # keeps the plain chain: 9 calls for each eager batch, no kernel
    check(spade_counts == (0, 0, 2 * SPADE_CALLS) and seen["spade"] == 0,
          f"SPADE launches, gradient launches, plain {spade_counts}, "
          f"kernels traced {seen['spade']}; want (0, 0, {2 * SPADE_CALLS}), "
          f"0 (bf16 blocks)")
    print(f"[main] run_batch x{n_timed} tiled: {batch * n_timed / t_tiled:.2f}"
          f" img/s ({1e3 * t_tiled / n_timed:.1f} ms/batch of {batch}) | full"
          f" path x1: {batch / t_full:.2f} img/s | K1 kernels traced "
          f"{launches} ="
          f" {K1_PER_BATCH} x {n_batches} batches | FIR kernels traced "
          f"{seen['fir']} = {FIR_PER_BATCH} x {n_batches}, launches counted "
          f"{fir_counts[0]} (2 eager batches), plain {fir_counts[2]} | "
          f"SPADE (bf16 blocks) launches {spade_counts[0]}, plain "
          f"{spade_counts[2]}, kernels traced {seen['spade']} | peak "
          f"{peak:.2f} GiB | out range [{out.min().item():.3f}, "
          f"{out.max().item():.3f}]", flush=True)
    del model, pipe, out, out_full
    torch.cuda.empty_cache()
    return launches, (fir_counts[0], seen["fir"]), spade_counts


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


def phase_train(k1, fir, sn):
    """The fashion preset's training step at batch 4 on the card. Returns
    K1 / K2 / K3's launches, K1's fp32 ones, the host s/step, and the FIR
    kernel's and the SPADE pair's (launches, gradient launches) of a
    regular step and of the R1 step."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.train.config import fashion_config
    from pasta_tpu_torch.train.steps import fetch_metrics

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
    _fir_reset(fir)
    _spade_reset(sn)
    # the layouts of the dy and gb that G's backward hands the SPADE pair:
    # (x shape, dy's, gb's: "nhwc" where the channels are contiguous, else
    # "nchw") -> calls, in the warm-up step
    dy_layouts, backward = collections.Counter(), sn._backward

    def record_dy(dy, x, gb, *args):
        dy_layouts[(tuple(x.shape), _spade_layout(dy.stride()),
                    _spade_layout(gb.stride()))] += 1
        return backward(dy, x, gb, *args)

    def stepped(p0, metrics):
        """Finite metrics; ada_p moved by exactly one controller step, or
        stayed where the clip to [0, 1] holds it."""
        for k, v in metrics.items():
            check(np.isfinite(v), f"train metric {k} = {v}")
        p1 = metrics["ada_p"]
        moved = abs(p1 - p0)
        # ada_p is float32 on the card, as in the JAX step
        check(abs(moved - delta) <= 1e-9 or (moved == 0 and p1 in (0, 1)),
              f"ada_p {p0} -> {p1}, step {delta}")
        return p1

    t0 = time.perf_counter()
    sn._backward = record_dy
    try:
        _, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
    finally:
        sn._backward = backward
    t_warm = time.perf_counter() - t0
    fir_step = _fir_counts(fir)
    spade_step = _spade_counts(sn)
    p = stepped(cfg.augment_p_init, fetch_metrics([metrics])[0])
    host, dev, steps = bench_train.timed_steps(step, state, batch, gen,
                                               N_TRAIN_TIMED)
    for metrics in steps:
        p = stepped(p, metrics)
    fir_timed = tuple(a - b for a, b in zip(_fir_counts(fir), fir_step))
    spade_timed = tuple(a - b for a, b in zip(_spade_counts(sn),
                                              spade_step))
    host_r1, dev_r1, (metrics_r1,) = bench_train.timed_steps(
        step, state, batch, gen, 1, do_r1=True)
    stepped(p, metrics_r1)
    fir_r1 = tuple(a - b - c for a, b, c in zip(_fir_counts(fir), fir_step,
                                                 fir_timed))
    spade_r1 = tuple(a - b - c for a, b, c in zip(
        _spade_counts(sn), spade_step, spade_timed))
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
    # every regular step makes the warm-up step's FIR calls, none plain; the
    # R1 step adds D's and DP's forwards and their double backward
    check(fir_step[0] > 0 and fir_step[1] > 0 and fir_step[2] == 0
          and fir_timed == tuple(N_TRAIN_TIMED * n for n in fir_step),
          f"FIR launches, gradient launches, plain of the warm-up step "
          f"{fir_step}, of {N_TRAIN_TIMED} regular steps {fir_timed}")
    check(fir_r1[0] >= fir_step[0] and fir_r1[1] > fir_step[1]
          and fir_r1[2] == 0,
          f"FIR launches, gradient launches, plain of the R1 step {fir_r1} "
          f"against a regular step's {fir_step}")
    # G's forwards (Gmain's, and the D phases' no-grad draw) 21 launches
    # each, its backward 27, none plain; R1 never reaches G
    check(spade_step[0] > 0 and spade_step[0] % SPADE_PER_BATCH == 0
          and spade_step[1] > 0 and spade_step[1] % SPADE_BWD == 0
          and spade_step[2] == 0 and spade_r1 == spade_step
          and spade_timed == tuple(N_TRAIN_TIMED * n for n in spade_step),
          f"SPADE launches, gradient launches, plain of the warm-up step "
          f"{spade_step}, of {N_TRAIN_TIMED} regular steps {spade_timed}, "
          f"of the R1 step {spade_r1}")
    check(sum(dy_layouts.values()) * 3 == spade_step[1],
          f"SPADE backward calls {dict(dy_layouts)} against "
          f"{spade_step[1]} gradient launches")
    print(f"[train] SPADE pair a step: launches {spade_step[0]}, gradient "
          f"launches {spade_step[1]}, plain 0, the R1 step the same | "
          f"G's backward, x shape dy gb layouts: "
          f"{ {' '.join(map(str, k)): v for k, v in dy_layouts.items()} }",
          flush=True)
    print(f"[train] warm-up {t_warm:.2f} s | regular x{N_TRAIN_TIMED}: "
          f"{host:.4f} s/step host, {dev:.4f} s/step CUDA events, "
          f"{host * 1000 / cfg.batch_size:.1f} sec/kimg | R1 step "
          f"{host_r1:.4f} s host, {dev_r1:.4f} s events | peak {peak:.2f} "
          f"GiB | launches K1 fwd {counts[0]}, K1 dX {counts[1]}, K2 "
          f"{counts[2]}, K3 {counts[3]} over {n_steps} steps (K1 fp32 "
          f"{n_fp32}, bf16 {counts[0] + counts[1] - n_fp32}) | FIR "
          f"launches, gradient launches a regular step {fir_step[:2]}, R1 "
          f"step {fir_r1[:2]}, plain 0 | ada_p "
          f"{float(state.ada_p):.6g} | r1 {metrics_r1['r1_penalty']:.4g} dp_r1 "
          f"{metrics_r1['dp_r1_penalty']:.4g} | metrics {metrics}",
          flush=True)
    del state, step, batch, before, after
    torch.cuda.empty_cache()
    return (counts, n_fp32, host, (fir_step[:2], fir_r1[:2]),
            (spade_step[:2], spade_r1[:2]))


@contextlib.contextmanager
def _augment_percentile(percentile):
    """Inside: the train step's augment draws nothing and takes every
    parameter at `percentile` of its distribution (the reference's
    debug_percentile), the same constant on every device."""
    from pasta_tpu_torch.train import augment, loss_terms

    original = loss_terms.augment_pipe
    loss_terms.augment_pipe = functools.partial(
        augment.augment_pipe, debug_percentile=percentile)
    try:
        yield
    finally:
        loss_terms.augment_pipe = original


def phase_train_check(shift):
    """Per-phase losses and gradients of one fp32 step at the narrow 64px
    config (no noise) on the card against the same on the CPU, which the
    CPU tests hold against the JAX package: once with ADA's p at 0 (every
    transform the identity), once at p = 1 with the augment's
    debug_percentile (a quarter turn, translations, a scale, a rotation:
    K2 and K3 shift rows by real offsets inside the step)."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import phase_losses

    def run(cfg):
        res = {}
        for dev in ("cuda", "cpu"):
            state = init_state(cfg, seed=0, device=dev)
            vgg = VGG19Features(seed=3).to(dev).requires_grad_(False)
            batch = batch_to(example_batch(cfg, np.random.RandomState(0)),
                             dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            res[dev] = phase_losses(cfg, state, batch, gen, vgg)
        return res

    common = dict(batch_size=4, use_noise=False, vgg_weight=20.0,
                  vgg_bf16=False)
    for tag, p_init, percentile in (("ada_p 0", 0.0, None),
                                    ("ada_p 1, percentile 0.35", 1.0, 0.35)):
        cfg = smoke_config(1, augment_p_init=p_init, **common)
        k2, k3 = shift.shift_fwd.launches, shift.shift_bwd.launches
        with (_augment_percentile(percentile) if percentile is not None
              else contextlib.nullcontext()):
            res = run(cfg)
        k2, k3 = shift.shift_fwd.launches - k2, shift.shift_bwd.launches - k3
        check(k2 > 0 and k3 > 0, f"train-check {tag}: K2 {k2}, K3 {k3} "
              f"launches on the card")
        worst = []
        for phase in res["cpu"]:
            (lg, _, gg), (lc, _, gc) = res["cuda"][phase], res["cpu"][phase]
            lerr = abs(lg.item() - lc.item()) / max(abs(lc.item()), 1e-6)
            gnum = sum(((a.cpu() - b).square().sum() for a, b in zip(gg, gc)))
            gden = sum((b.square().sum() for b in gc))
            gerr = (gnum / gden.clamp_min(1e-30)).sqrt().item()
            # the CPU tests' budgets: losses 1e-3 relative, gradients 2e-2
            # of their norm (the bf16 two-pass augment rounds differently)
            check(lerr <= 1e-3 and gerr <= 2e-2,
                  f"train-check {tag} {phase}: loss rel {lerr}, grad rel "
                  f"{gerr}")
            worst.append(f"{phase} loss {lerr:.2g} grad {gerr:.2g}")
        print(f"[train-check] narrow 64px fp32 card vs CPU, {tag} (K2 x{k2},"
              f" K3 x{k3} on the card), relative: {' | '.join(worst)}",
              flush=True)


def _launches(k1):
    """(K1 fwd, K1 dX, K2, K3, K1 fp32) launched so far."""
    from pasta_tpu_torch.cli import bench_train

    return bench_train.kernel_counts() + (k1.conv3x3_valid.launches_fp32,)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _k1_traced(dev):
    """K1's kernels that ran on the cards inside the block, read from a
    torch.profiler (CUPTI) trace of it, so those of a replayed CUDA graph
    too, which K1's launch counters do not see: the dict yielded gets
    `launches` and `fp32` at the block's end (0 and 0 off a card), `fir`,
    the FIR resampling kernel's, and `spade`, the SPADE pair's."""
    seen = {"launches": 0, "fp32": 0, "fir": 0, "spade": 0}
    if torch.device(dev).type != "cuda":
        yield seen
        return
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield seen
        _sync_cards()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    seen["fp32"] = sum(K1_KERNELS[0] in n for n in names)
    seen["launches"] = seen["fp32"] + sum(K1_KERNELS[1] in n for n in names)
    seen["fir"] = sum(FIR_KERNEL in n for n in names)
    seen["spade"] = sum(SPADE_KERNEL in n for n in names)


def _one_step(k1, state, step, batch, gen, dev, **kw):
    """One train step: its metrics (fetched), host seconds, launches and
    the runs of G's synthesis network (counted by a forward hook)."""
    from pasta_tpu_torch.train.steps import fetch_metrics

    runs = []
    hook = state.g.synthesis.register_forward_hook(lambda *_: runs.append(1))
    _sync(dev)
    before = _launches(k1)
    t0 = time.perf_counter()
    try:
        _, metrics = step(state, batch, gen, **kw)
        _sync(dev)
    finally:
        hook.remove()
    host = time.perf_counter() - t0
    counts = tuple(a - b for a, b in zip(_launches(k1), before))
    metrics = fetch_metrics([metrics])[0]
    for k, v in metrics.items():
        check(np.isfinite(v), f"train metric {k} = {v}")
    return dict(metrics=metrics, s=host, counts=counts, runs=len(runs))


def _free(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _peak_gib(dev):
    if torch.device(dev).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 30


@contextlib.contextmanager
def _path_shapes(k1, shift, shapes):
    """Inside the block, records each distinct shape K1 and K2/K3 launch
    at: K1's (x, w, dtype, out_w, pad) in shapes["K1"]; K2's and K3's
    (name, rows, dtype, V, out_w) in shapes["K2/K3"] with the positions q
    of its first launch. The launches and their counts are unchanged."""
    conv, rows = k1._kernel, shift._kernel

    def conv_seen(x, w, out_w, pad=0):
        shapes["K1"].add((tuple(x.shape), tuple(w.shape), x.dtype, out_w,
                          pad))
        return conv(x, w, out_w, pad)

    def rows_seen(name, a, q, start, f, v_dim, out_w, return_rows=False):
        key = (name, tuple(a.shape), a.dtype, v_dim, out_w)
        if q is not None and key not in shapes["K2/K3"]:
            shapes["K2/K3"][key] = q.clone()
        return rows(name, a, q, start, f, v_dim, out_w, return_rows)

    k1._kernel, shift._kernel = conv_seen, rows_seen
    try:
        yield
    finally:
        k1._kernel, shift._kernel = conv, rows


def phase_train_options(k1, shift, dev="cuda"):
    """The training options on the fashion preset at batch 4. A: a warm-up,
    a regular step, a step with Gpl and one with Gpl and both R1 phases;
    the launches of each, G's synthesis runs, pl_mean moved, the frozen D
    layers untouched (bit for bit, no Adam moments) and every other D
    parameter moved; s/step and peak memory of each. B and B with reuse
    beside the default preset, all three built first and timed in turns;
    their launches, synthesis runs and peak memory. Returns the launches of
    the phase's steps (K1 fwd, K1 dX, K2, K3, K1 fp32), counted from 0 and
    held equal to the sum of STEP_LAUNCHES over them, and the shapes the
    kernels took (`_path_shapes`)."""
    shapes = {"K1": set(), "K2/K3": {}}
    with _path_shapes(k1, shift, shapes):
        counts = _options_steps(k1, dev)
    return counts, shapes


def _options_steps(k1, dev):
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.train.config import fashion_config
    from pasta_tpu_torch.train.state import freeze_d_mask

    bench_train.reset_kernel_counts()
    cfg = fashion_config(batch_size=TRAIN_BATCH, **OPTIONS["A"])
    state, step, batch, gen = bench_train.setup(cfg, dev)
    trained = freeze_d_mask(cfg, state.d)
    before = {m: {n: p.detach().clone() for n, p in
                  getattr(state, m).named_parameters()}
              for m in ("g", "d", "dp")}
    t0 = time.perf_counter()
    _one_step(k1, state, step, batch, gen, dev)
    t_warm = time.perf_counter() - t0
    steps = {}
    for kind, kw in (("regular", {}), ("pl", dict(do_pl=True)),
                     ("pl_r1", dict(do_pl=True, do_r1_d=True,
                                    do_r1_dp=True))):
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps[kind] = r = _one_step(k1, state, step, batch, gen, dev, **kw)
        r["peak"] = _peak_gib(dev)
        want = STEP_LAUNCHES["A", kind]
        check(r["counts"] == want, f"A {kind} step: launches K1 fwd/dX, K2, "
              f"K3, K1 fp32 {r['counts']} != {want}")
        runs = SYNTHESIS_RUNS["A"] + (kind != "regular")
        check(r["runs"] == runs, f"A {kind} step: {r['runs']} synthesis runs")
    reg, pl = steps["regular"], steps["pl_r1"]
    pl_mean = float(state.pl_mean)
    check(np.isfinite(pl_mean) and pl_mean != 0, f"pl_mean {pl_mean}")
    check(pl["metrics"]["pl_penalty"] > 0 and "pl_penalty" in reg["metrics"],
          "pl_penalty")
    frozen = 0
    for m in ("g", "d", "dp"):
        for name, p in getattr(state, m).named_parameters():
            same = torch.equal(p.detach(), before[m][name])
            if m == "d" and not trained[name]:
                check(same and p not in state.d_opt.state,
                      f"frozen D {name} moved or has Adam moments")
                frozen += 1
            else:
                check(not same, f"{m} {name} did not move")
    check(frozen == 9, f"{frozen} frozen D tensors, wanted 9")
    print(f"[train-options] A {OPTIONS['A']} at batch {TRAIN_BATCH}: warm-up"
          f" {t_warm:.2f} s | "
          + " | ".join(f"{k} step {r['s']:.4f} s, peak {r['peak']:.2f} GiB, "
                       f"launches K1 fwd/dX, K2, K3, K1 fp32 {r['counts']}, "
                       f"{r['runs']} synthesis runs"
                       for k, r in steps.items())
          + f" | pl_mean {pl_mean:.6g}, pl_penalty "
          f"{pl['metrics']['pl_penalty']:.4g} | {frozen} frozen D tensors "
          f"bit-equal without moments; the other "
          f"{sum(map(len, before.values())) - frozen} tensors of G, D and DP "
          f"moved", flush=True)
    del state, step, batch, gen, before
    _free(dev)

    built = {}
    for name in ("default", "B", "B reuse"):
        cfg = fashion_config(batch_size=TRAIN_BATCH, **OPTIONS.get(name, {}))
        built[name] = bench_train.setup(cfg, dev)
        _one_step(k1, *built[name], dev)               # warm-up
    times = {name: [] for name in built}
    peaks = dict.fromkeys(built, 0.0)
    resident = (torch.cuda.memory_allocated() / 2 ** 30
                if torch.device(dev).type == "cuda" else float("nan"))
    for name in ("default", "B", "B reuse", "B reuse", "B", "default"):
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(N_TURNS):
            r = _one_step(k1, *built[name], dev)
            want = STEP_LAUNCHES[name, "regular"]
            check(r["counts"] == want, f"{name}: launches {r['counts']} != "
                  f"{want}")
            check(r["runs"] == SYNTHESIS_RUNS[name],
                  f"{name}: {r['runs']} synthesis runs")
            times[name].append(r["s"])
        peaks[name] = max(peaks[name], _peak_gib(dev))
    # the steps' own launches, read before the draws timed below: A's
    # warm-up and three steps, each of default, B, B reuse warmed up once
    # and run 2 x N_TURNS times
    counts = _launches(k1)
    kinds = [("A", "regular"), ("A", "regular"), ("A", "pl"), ("A", "pl_r1")]
    kinds += [(name, "regular") for name in built] * (1 + 2 * N_TURNS)
    want = tuple(sum(STEP_LAUNCHES[k][i] for k in kinds) for i in range(5))
    check(counts == want, f"options steps: launches {counts} != {want}")
    # the median: a host hiccup slows one step in a call now and then
    median = {k: float(np.median(v)) for k, v in times.items()}
    if torch.device(dev).type == "cuda":
        # what B and B reuse leave out: DPmain's draw of the style branch
        # (encoders, mapping, style blocks) and Dmain's whole forward
        from pasta_tpu_torch.train.steps import _run_g

        state, _, batch, gen = built["default"]
        z = torch.zeros((TRAIN_BATCH, 0), device=dev)
        with torch.no_grad():
            t_draw = cuda_ms(lambda: state.g.parsing(
                z, batch["style_input"], batch["retain"], batch["pose"],
                generator=gen), 5)
            t_full = cuda_ms(lambda: _run_g(state.g, batch, gen,
                                            update_w_avg=False), 5)
        print(f"[train-options] no-grad G draws at batch {TRAIN_BATCH}, "
              f"CUDA events: the style branch (DPmain's) {t_draw:.2f} ms, a "
              f"whole forward (Dmain's, or the shared one) {t_full:.2f} ms",
              flush=True)
    print(f"[train-options] s/step in turns (default, B, B reuse, B reuse, "
          f"B, default; {N_TURNS} steps each), host clock, median: "
          + " | ".join(f"{k} {v:.4f} ({100 * (v / median['default'] - 1):+.1f}"
                       f"%; peak {peaks[k]:.2f} GiB; {SYNTHESIS_RUNS[k]} "
                       f"synthesis runs, launches "
                       f"{STEP_LAUNCHES[k, 'regular']})"
                       for k, v in median.items())
          + f" | the three states resident: {resident:.2f} GiB | every "
          f"step: {times} | launches of the phase's {len(kinds)} steps "
          f"K1 fwd/dX, K2, K3, K1 fp32 {counts}", flush=True)
    del built
    _free(dev)
    return counts


def phase_options_kernels(k1, shift, shapes, dev="cuda"):
    """Each shape K1, K2 and K3 took in the options steps, held against the
    plain version at phase 6's budget: K1 (either dtype and pad) on random
    inputs of that shape, K2/K3 on random rows with the path's own q.
    Returns the largest error of each kernel."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    share = dict.fromkeys(worst, 0.0)
    for xs, ws, dtype, out_w, pad in sorted(shapes["K1"], key=str):
        x = torch.randn(xs, device=dev, generator=g).to(dtype)
        w = (torch.randn(ws, device=dev, generator=g)
             / (9 * xs[3]) ** 0.5).to(dtype)
        got = k1._kernel(x, w, out_w, pad)
        ref = k1.conv3x3_valid_plain(x.float(), w.float(), out_w, pad)
        err = (got.float() - ref).abs().max().item()
        bound = _bound(ref, dtype)
        check(got.shape == ref.shape and err <= bound,
              f"K1 {list(xs)}->{ws[3]} {dtype} out_w {out_w} pad {pad}: err "
              f"{err} > bound {bound}")
        worst["K1"] = max(worst["K1"], err)
        share["K1"] = max(share["K1"], err / bound)
        del x, w, got, ref
    for (name, a_shape, dtype, v_dim, out_w), q in sorted(
            shapes["K2/K3"].items(), key=lambda kv: str(kv[0])):
        a = torch.randn(a_shape, device=dev, generator=g).to(dtype)
        got = shift._kernel(name, a, q, None, None, v_dim, out_w)
        ref = (shift.shift_fwd_plain(a, q, out_w) if name == "shift_fwd"
               else shift.shift_bwd_plain(a, q, v_dim))
        err = (got.float() - ref.float()).abs().max().item()
        bound = _bound(ref, dtype)
        check(err <= bound, f"{name} {list(a_shape)} {dtype}: err {err} > "
              f"bound {bound}")
        tag = "K2" if name == "shift_fwd" else "K3"
        worst[tag] = max(worst[tag], err)
        share[tag] = max(share[tag], err / bound)
        del a, got, ref
    _sync(dev)
    k1_kinds = collections.Counter(
        (str(d)[6:], p, xs[0]) for xs, _, d, _, p in shapes["K1"])
    rows_n = sorted({(k[0][6:9], k[1][0]) for k in shapes["K2/K3"]})
    print(f"[options-kernels] every shape the options steps launched, "
          f"against plain: K1 {len(shapes['K1'])} shapes (dtype, pad, N: "
          f"count {dict(sorted(k1_kinds.items()))}), K2/K3 "
          f"{len(shapes['K2/K3'])} (kernel, R: {rows_n}) | max_abs_err "
          f"{', '.join(f'{k} {v:.3g}' for k, v in worst.items())} | largest "
          f"error / bound {', '.join(f'{k} {v:.3f}' for k, v in share.items())}",
          flush=True)
    _free(dev)
    return worst


def _options_step(cfg, dev, noise):
    """One whole step with both R1 phases (and Gpl when cfg has it, on the
    directions `noise`) from seed 0: (metrics, each module's parameters,
    pl_mean, w_avg, K1 / K2 / K3 launches)."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.ops import affine_warp as shift
    from pasta_tpu_torch.ops import conv3x3 as k1
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import fetch_metrics, make_train_step

    kw = dict(do_r1_d=True, do_r1_dp=True, do_pl=bool(cfg.pl_weight))
    state = init_state(cfg, seed=0, device=dev)
    vgg = VGG19Features(seed=3).to(dev).requires_grad_(False)
    batch = batch_to(example_batch(cfg, np.random.RandomState(0)), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = (k1.conv3x3_valid.launches + k1.conv3x3_valid.launches_bwd,
              shift.shift_fwd.launches, shift.shift_bwd.launches)
    _, m = make_train_step(cfg, vgg)(state, batch, gen,
                                     pl_noise=noise.to(dev), **kw)
    after = (k1.conv3x3_valid.launches + k1.conv3x3_valid.launches_bwd,
             shift.shift_fwd.launches, shift.shift_bwd.launches)
    return (fetch_metrics([m])[0],
            {k: {n: p.detach().cpu() for n, p in
                 getattr(state, k).named_parameters()}
             for k in ("g", "d", "dp")},
            float(state.pl_mean), state.g.mapping.w_avg.cpu(),
            tuple(x - y for x, y in zip(after, before)))


def phase_options_check(dev="cuda"):
    """A, B and B with reuse at 512 px and narrow widths (channel_base
    2048: 4 channels at 512 px, K1's 64 and 128 at 32 and 16 px; fp32, no
    noise, ADA p = 0, batch 2, so A's microbatches are single samples and
    Gpl runs on one): one whole step with both R1 phases (and Gpl in A, on
    the same directions) on the card against the same on the CPU, at the
    CPU tests' whole-step budget (metrics 1e-2 relative or 2e-3 absolute,
    each module's parameters 1e-4 of its norm). The VGG loss is off: A's
    contextual loss runs VGG19 at its full width at 512 px all the same.
    Then A's per-phase losses and gradients (Gpl's and the contextual
    term's included) at 64 px, batch 4, at phase_train_check's budget
    (1e-3, 2e-2)."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import phase_losses

    narrow = dict(resolution=512, batch_size=2, use_noise=False,
                  vgg_weight=0.0, vgg_bf16=False)
    noise = torch.from_numpy(np.random.RandomState(1).randn(
        1, 512, 512, 3).astype(np.float32))
    for name in ("A", "B", "B reuse"):
        cfg = smoke_config(1, **narrow, **OPTIONS[name])
        t0 = time.perf_counter()
        mg, pg, lg, wg, launched = _options_step(cfg, dev, noise)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        mc, pc, lc, wc, _ = _options_step(cfg, "cpu", noise)
        t_cpu = time.perf_counter() - t0
        if torch.device(dev).type == "cuda":
            check(min(launched) > 0, f"{name} at 512 px: K1, K2, K3 launches "
                  f"{launched} on the card")
        for k, v in mc.items():
            check(abs(mg[k] - v) <= max(2e-3, 1e-2 * abs(v)),
                  f"{name} card vs CPU: {k} {mg[k]} vs {v}")
        errs = {}
        for k in pc:
            num = sum((pg[k][n] - t).square().sum() for n, t in pc[k].items())
            den = sum(t.square().sum() for t in pc[k].values())
            errs[k] = (num / den).sqrt().item()
            check(errs[k] <= 1e-4, f"{name} card vs CPU: {k} parameters "
                  f"{errs[k]}")
        errs["w_avg"] = ((wg - wc).norm() / wc.norm()).item()
        check(errs["w_avg"] <= 1e-4 and abs(lg - lc) <= 1e-3 * max(abs(lc),
                                                                   1e-12),
              f"{name} card vs CPU: w_avg {errs['w_avg']}, pl_mean {lg} vs "
              f"{lc}")
        print(f"[options-check] narrow 512px fp32 {name}, batch 2, one step "
              f"with R1{' and Gpl' if cfg.pl_weight else ''}, card vs CPU "
              f"(K1, K2, K3 x{launched} on the card; {t_card:.1f} s, CPU "
              f"{t_cpu:.1f} s): largest metric gap "
              f"{max(abs(mg[k] - v) for k, v in mc.items()):.3g}, parameters "
              f"relative {', '.join(f'{k} {v:.2g}' for k, v in errs.items())}",
              flush=True)

    cfg = smoke_config(1, batch_size=4, use_noise=False, vgg_weight=20.0,
                       vgg_bf16=False, **OPTIONS["A"])
    noise = torch.from_numpy(np.random.RandomState(1).randn(
        2, 64, 64, 3).astype(np.float32))
    phases = {}
    for d in (dev, "cpu"):
        state = init_state(cfg, seed=0, device=d)
        vgg = VGG19Features(seed=3).to(d).requires_grad_(False)
        batch = batch_to(example_batch(cfg, np.random.RandomState(0)), d)
        gen = torch.Generator(device=d).manual_seed(0)
        phases[d] = phase_losses(cfg, state, batch, gen, vgg,
                                 pl_noise=noise.to(d))
    worst = []
    for phase in phases["cpu"]:
        (lg, _, gg), (lc, _, gc) = phases[dev][phase], phases["cpu"][phase]
        lerr = abs(lg.item() - lc.item()) / max(abs(lc.item()), 1e-6)
        gnum = sum((a.cpu() - b).square().sum() for a, b in zip(gg, gc))
        gden = sum(b.square().sum() for b in gc)
        gerr = (gnum / gden.clamp_min(1e-30)).sqrt().item()
        check(lerr <= 1e-3 and gerr <= 2e-2, f"options-check A {phase}: "
              f"loss rel {lerr}, grad rel {gerr}")
        worst.append(f"{phase} {lerr:.2g}/{gerr:.2g}")
    print(f"[options-check] narrow 64px fp32 A, batch 4, per phase, card vs "
          f"CPU, loss/grad relative: {', '.join(worst)}", flush=True)


N_PERSONS = 24          # the synthetic dataset root of the training run
RUN_STEPS, RESUME_STEPS, RUN_TICK = 6, 3, 3
G_FWD_K1 = 26           # one generator forward (a snapshot's G-EMA draw)


class _GatesShut:
    """Stands in for a loader's RandomState with every draw at 0.9: the
    erasure gate (< 0.8) and the occlusion gate (< 0.9) stay shut on the
    host and on the device loader alike, whatever their draw order."""

    def rand(self):
        return 0.9

    def randint(self, low, high=None, size=None):
        return low


def _loader_rates(ts, tloop, root):
    """items/s of the two loaders through ParallelLoader with 1 and 8
    threads (host clock; the first batch, which starts the pool, apart)."""
    rates = {}
    for impl in ("host", "device"):
        for workers in (1, 8):
            ds = ts.TryonTrainDataset(root, seed=0, loader_impl=impl)
            loader = tloop.ParallelLoader(ds, TRAIN_BATCH, workers, seed=0)
            batches = iter(loader)
            next(batches)
            t0 = time.perf_counter()
            n = 4
            for _ in range(n):
                next(batches)
            rates[impl, workers] = n * TRAIN_BATCH / (time.perf_counter() - t0)
            loader.close()
    return rates


def _assemble_checks(ts, tloop, root):
    """The device assembler on the card against itself on the CPU (tiled
    both ways) and against the host loader's batch of the same persons with
    the draws held equal; upload + assembly ms a batch for both loaders."""
    from pasta_tpu_torch.data import preprocess as pp

    names = pp.as_root(root).list("image")[:TRAIN_BATCH]
    lean_items, host_items = [], []
    for name in names:
        rec = pp.load_person(root, name, with_garment_parsing=True,
                             pose_raster="device")
        lean_items.append(ts.preprocess_person_train_lean(rec, _GatesShut()))
        rec = pp.load_person(root, name, with_garment_parsing=True)
        host_items.append(ts.preprocess_person_train(rec, _GatesShut()))
    lean_np, tiled = ts.batch_to_lean_inputs(lean_items)
    check(tiled, "the synthetic persons do not fit the paste tiles")
    raw_np = ts.batch_to_raw_inputs(host_items)

    exact = ("real_img", "gt_parsing")
    masks = ("denorm_upper_mask", "denorm_lower_mask")
    worst = {}
    for use_tiles in (True, False):
        outs = [ts.assemble_train_batch_lean(
            tloop.upload_batch(lean_np, dev), tiled=use_tiles)
            for dev in ("cuda", "cpu")]
        for k, cpu in outs[1].items():
            gpu = outs[0][k].cpu()
            check(gpu.shape == cpu.shape and bool(torch.isfinite(gpu).all()),
                  f"assembler {k}: shape or non-finite")
            diff = (gpu - cpu).abs()
            if k in exact:
                # the card divides by 127.5 through the reciprocal: 1 ulp
                check(diff.max().item() <= 2.4e-7, f"assembler {k} differs "
                      f"by {diff.max().item()}")
            elif k in masks:      # an eroded edge pixel at its threshold
                frac = (diff > 0).float().mean().item()
                check(frac <= 1e-4, f"assembler {k}: {frac} of pixels differ")
                worst[k] = max(worst.get(k, 0.0), frac)
            else:                 # phase_check's budget for the serving warps
                span = (cpu.max() - cpu.min()).item()
                frac = (diff > 1e-2 * span).float().mean().item()
                check(frac <= 2e-2 and diff.mean().item() <= 1e-3 * span,
                      f"assembler {k}: frac {frac}, mean {diff.mean()}")
                worst[k] = max(worst.get(k, 0.0), diff.max().item())
    lean = {k: v.cpu().numpy() for k, v in ts.assemble_train_batch_lean(
        tloop.upload_batch(lean_np, "cuda"), tiled=True).items()}
    host = ts.batch_to_train_inputs(host_items)
    check(set(lean) == set(host), "assembler keys differ from the host's")
    # the JAX package's budgets for its device loader against its host one
    for k in exact:
        check(np.abs(lean[k] - host[k]).max() <= 1e-5, f"lean vs host {k}")
    check(np.abs(lean["pose"][..., 3:] - host["pose"][..., 3:]).max() <= 1e-5,
          "lean vs host: label and bound planes")
    far = lambda k, sl, tol: float(np.mean(
        np.abs(lean[k][..., sl] - host[k][..., sl]) > tol))
    every = slice(None)
    budgets = [("pose", slice(0, 3), 1e-3, 2e-3), ("retain", every, 1e-3, 1e-3),
               ("style_input", every, 0.02, 0.03),
               ("denorm_upper_input", every, 0.02, 0.03),
               ("denorm_lower_input", every, 0.02, 0.03),
               ("denorm_upper_mask", every, 0, 0.005),
               ("denorm_lower_mask", every, 0, 0.005)]
    fracs = {k: far(k, sl, tol) for k, sl, tol, _ in budgets}
    for k, _, tol, budget in budgets:
        check(fracs[k] < budget, f"lean vs host {k}: {fracs[k]} of values "
              f"beyond {tol} (budget {budget})")
    t_lean = cuda_ms(lambda: ts.assemble_train_batch_lean(
        tloop.upload_batch(lean_np, "cuda"), tiled=True), 5)
    t_host = cuda_ms(lambda: ts.assemble_train_batch(
        tloop.upload_batch(raw_np, "cuda")), 5)
    mb = lambda b: sum(v.nbytes for v in b.values()) / 2 ** 20
    print(f"[train-run] assemble_train_batch_lean card vs CPU (tiled and "
          f"full canvas): real_img, gt_parsing equal to 2 ulp | worst "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (masks: "
          f"share of pixels; planes: max abs on [-1, 1]) | vs the host "
          f"loader, share beyond its budget's threshold: "
          f"{ {k: float(f'{v:.3g}') for k, v in fracs.items()} }", flush=True)
    print(f"[train-run] upload + assemble, batch {TRAIN_BATCH} (CUDA events, "
          f"host->card copy included): device loader {t_lean:.2f} ms "
          f"({mb(lean_np):.1f} MiB raw) | host loader {t_host:.2f} ms "
          f"({mb(raw_np):.1f} MiB raw)", flush=True)


def phase_train_run(k1, step_s):
    """A training run from files on disk to a checkpoint and back, through
    cli.train.main; `step_s`: phase 7's s/step on resident tensors."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.cli import train as cli_train
    from pasta_tpu_torch.data import trainsets as ts
    from pasta_tpu_torch.data.synthetic import write_dataset_root
    from pasta_tpu_torch.train import loop as tloop

    tmp = tempfile.mkdtemp(prefix="pasta_smoke_")
    steps, waits, snaps = [], [], []
    originals = (tloop.make_train_step, tloop.ParallelLoader,
                 tloop._save_snapshot)

    def counted_step(cfg, vgg=None):
        """The loop's train step with its launches and CUDA events kept."""
        step = originals[0](cfg, vgg)

        def run(state, batch, generator, **kw):
            first = None
            if snaps and steps[-1]["run"] == 0:
                # the resumed run's first step: keep its state as loaded
                first = {n: {k: v.detach().to("cpu", copy=True) for k, v in
                             getattr(state, n).state_dict().items()}
                         for n in ("g", "d", "dp", "g_ema")}
                first.update({n: {i: {k: v.detach().to("cpu", copy=True)
                                      for k, v in st.items()}
                                  for i, st in getattr(state, n).state_dict()[
                                      "state"].items()}
                              for n in ("g_opt", "d_opt", "dp_opt")})
                first.update(step=state.step, ada_p=float(state.ada_p))
            before = bench_train.kernel_counts()
            fp32 = k1.conv3x3_valid.launches_fp32
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = step(state, batch, generator, **kw)
            e1.record()
            steps.append(dict(
                run=len(snaps), index=state.step - 1, t0=t0, e0=e0, e1=e1,
                r1=bool(kw.get("do_r1_d")), first=first,
                fp32=k1.conv3x3_valid.launches_fp32 - fp32,
                counts=tuple(a - b for a, b in zip(
                    bench_train.kernel_counts(), before))))
            return out
        return run

    class TimedLoader(originals[1]):
        def __iter__(self):
            batches = super().__iter__()
            while True:
                t0 = time.perf_counter()
                item = next(batches)
                waits.append(time.perf_counter() - t0)
                yield item

    def timed_snapshot(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        originals[2](*args)
        torch.cuda.synchronize()
        snaps.append(time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        root, zroot = os.path.join(tmp, "root"), os.path.join(tmp, "root.zip")
        write_dataset_root(root, N_PERSONS, 500)
        write_dataset_root(zroot, N_PERSONS, 500, as_zip=True)
        print(f"[train-run] {N_PERSONS} synthetic persons written as a "
              f"directory and as a zip in {time.perf_counter() - t0:.1f} s",
              flush=True)
        rates = _loader_rates(ts, tloop, root)
        print(f"[train-run] loader items/s (host clock, 512 px): host loader "
              f"{rates['host', 1]:.1f} with 1 thread, {rates['host', 8]:.1f} "
              f"with 8 | device loader's host half {rates['device', 1]:.1f} "
              f"with 1, {rates['device', 8]:.1f} with 8 | one step needs "
              f"{TRAIN_BATCH / step_s:.1f} items/s", flush=True)
        _assemble_checks(ts, tloop, root)

        tloop.make_train_step = counted_step
        tloop.ParallelLoader = TimedLoader
        tloop._save_snapshot = timed_snapshot
        common = ["--outdir", os.path.join(tmp, "runs"), "--cfg", "fashion",
                  "--batch", str(TRAIN_BATCH), "--tick", str(RUN_TICK),
                  "--snap", "100", "--workers", "8"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bench_train.reset_kernel_counts()
        run1 = cli_train.main(common + [
            "--data", zroot, "--loader-impl", "device", "--max-steps",
            str(RUN_STEPS)])
        ckpt = os.path.join(run1, f"ckpt-{RUN_STEPS:06d}.pt")
        check(os.path.isfile(ckpt), f"no checkpoint {ckpt}")
        run2 = cli_train.main(common + [
            "--data", root, "--loader-impl", "host", "--aug", "fixed", "--p",
            "0.5", "--resume", ckpt, "--max-steps",
            str(RUN_STEPS + RESUME_STEPS)])
        torch.cuda.synchronize()
        totals = bench_train.kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        (tloop.make_train_step, tloop.ParallelLoader,
         tloop._save_snapshot) = originals

    try:
        # stats.jsonl: one finite row a tick
        for run, want in ((run1, [3, 6]), (run2, [9])):
            with open(os.path.join(run, "stats.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            check([r["step"] for r in rows] == want,
                  f"{run}: rows at steps {[r['step'] for r in rows]}")
            for r in rows:
                check(r["kimg"] == r["step"] * TRAIN_BATCH / 1000
                      and np.isfinite(r["sec_per_kimg"]), f"row {r['step']}")
                for k in ("g_loss", "d_loss", "ada_p", "g_vgg", "r1_penalty"):
                    check(np.isfinite(r[k]["mean"]) and r[k]["num"] == 3,
                          f"row {r['step']}: {k} = {r[k]}")
            last = rows[-1]["step"]
            import PIL.Image
            for suffix, n_rows in (("", 2), ("_parsing", 1),
                                   ("_parsing_color", 1)):
                img = PIL.Image.open(os.path.join(
                    run, f"fakes{last:06d}{suffix}.png"))
                check(img.size == (TRAIN_BATCH * 512, n_rows * 512)
                      and img.mode == "RGB",
                      f"grid {suffix}: {img.size} {img.mode}")
            check(os.path.isfile(os.path.join(run, "log.txt"))
                  and os.path.isfile(os.path.join(run, f"ckpt-{last:06d}.pt")),
                  f"{run}: log or checkpoint missing")
        with open(os.path.join(run1, "stats.jsonl")) as f:
            tick2 = [json.loads(line) for line in f][1]

        # the step numbers, the lazy-R1 cadence and the launches of each step
        check([s["index"] for s in steps]
              == list(range(RUN_STEPS + RESUME_STEPS)),
              f"steps {[s['index'] for s in steps]}")
        check([s["r1"] for s in steps] == [True] + [False] * (len(steps) - 1),
              "the lazy R1 phases ran elsewhere than at step 0 alone")
        regular = (TRAIN_K1_FWD, TRAIN_K1_DX, TRAIN_K2, TRAIN_K3)
        with_r1 = tuple(a + b for a, b in zip(
            regular, (R1_K1_FWD, R1_K1_DX, R1_K2, R1_K3)))
        for s in steps:
            want = with_r1 if s["r1"] else regular
            check(s["counts"] == want and s["fp32"] == TRAIN_K1_FP32,
                  f"step {s['index']}: launches K1 fwd/dX, K2, K3 "
                  f"{s['counts']} (fp32 {s['fp32']}) != {want}")
        in_steps = tuple(sum(s["counts"][i] for s in steps) for i in range(4))
        want_total = (in_steps[0] + 2 * G_FWD_K1,) + in_steps[1:]
        check(totals == want_total, f"launches over both runs {totals} != "
              f"the steps' {in_steps} + two snapshot draws of G")

        # the resumed run started from exactly what was saved
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        first = steps[RUN_STEPS]["first"]
        check(first is not None and first["step"] == saved["step"]
              == RUN_STEPS and first["ada_p"] == saved["ada_p"],
              "the resumed run's step or ada_p")
        n_tensors = 0
        for name in ("g", "d", "dp", "g_ema"):
            check(sorted(first[name]) == sorted(saved[name]), f"{name} keys")
            for k, v in saved[name].items():
                check(torch.equal(first[name][k], v), f"resume: {name}.{k}")
                n_tensors += 1
        for name in ("g_opt", "d_opt", "dp_opt"):
            for idx, st in saved[name]["state"].items():
                for k, v in st.items():
                    check(torch.equal(first[name][idx][k], v),
                          f"resume: {name}[{idx}].{k}")
                    n_tensors += 1

        # times: the second tick of the first run is three regular steps
        reg = [s for s in steps if s["run"] == 0 and s["index"] >= RUN_TICK]
        dev_step = sum(s["e0"].elapsed_time(s["e1"]) for s in reg) / len(reg)
        gaps = [a["e1"].elapsed_time(b["e0"]) for a, b in zip(reg, reg[1:])]
        span = reg[0]["e0"].elapsed_time(reg[-1]["e1"])
        loop_s = tick2["sec_per_kimg"] * TRAIN_BATCH / 1000
        gaps_host = [a["e1"].elapsed_time(b["e0"]) for a, b in zip(
            steps[RUN_STEPS:], steps[RUN_STEPS + 1:])]
        print(f"[train-run] device loader on the zip, {RUN_STEPS} steps, then "
              f"resumed with the host loader on the directory for "
              f"{RESUME_STEPS}: {n_tensors} tensors of the resumed state "
              f"bit-equal to the checkpoint | launches per step K1 fwd/dX, "
              f"K2, K3: R1 step {with_r1}, regular {regular}, as the bare "
              f"step's; over both runs {totals}", flush=True)
        print(f"[train-run] s/step inside the loop (tick 2 of run 1, from "
              f"stats.jsonl) {loop_s:.4f} against {step_s:.4f} on resident "
              f"tensors | the step alone {dev_step / 1e3:.4f} s by CUDA "
              f"events | between two steps the card spends "
              f"{sum(gaps) / len(gaps):.2f} ms (upload, assembly, waiting), "
              f"{100 * sum(gaps) / span:.2f}% of the tick; with the host "
              f"loader {sum(gaps_host) / len(gaps_host):.2f} ms | the host "
              f"waited for a batch {1e3 * sum(waits) / len(waits):.1f} ms on "
              f"average, {1e3 * max(waits):.1f} ms at most | snapshot "
              f"{snaps[0]:.2f} s and {snaps[1]:.2f} s | peak {peak:.2f} GiB",
              flush=True)
        options = _options_run(k1, cli_train, common, root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del steps
        torch.cuda.empty_cache()
    return totals, options


def _options_run(k1, cli_train, common, root):
    """cli.train.main with Gpl, the contextual loss and two microbatches
    (options C) for 4 steps on the directory root: Gpl and R1 at step 0.
    Holds every step's launches (and the snapshot's G-EMA draw), the stats
    rows' pl_penalty and the checkpoint's pl_mean."""
    from pasta_tpu_torch.cli import bench_train

    bench_train.reset_kernel_counts()
    t0 = time.perf_counter()
    run = cli_train.main(common + [
        "--data", root, "--loader-impl", "host", "--pl_weight", "2",
        "--contextual_weight", "1", "--grad-accum", "2", "--max-steps", "4",
        "--tick", "2"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launches(k1)
    first, rest = STEP_LAUNCHES["C", "pl_r1"], STEP_LAUNCHES["C", "regular"]
    snapshot = (G_FWD_K1, 0, 0, 0, G_FWD_K1)
    want = tuple(a + 3 * b + c for a, b, c in zip(first, rest, snapshot))
    check(counts == want, f"options run: launches {counts} != {want} (Gpl "
          f"and R1 at step 0, 3 regular steps, the snapshot's G-EMA draw)")
    with open(os.path.join(run, "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check([r["step"] for r in rows] == [2, 4], f"options run rows {rows}")
    pen = [r["pl_penalty"] for r in rows]
    check(all(p["num"] == 2 for p in pen) and pen[0]["mean"] > 0
          and pen[1]["mean"] == 0, f"options run pl_penalty {pen}")
    saved = torch.load(os.path.join(run, "ckpt-000004.pt"),
                       map_location="cpu", weights_only=True)
    check(np.isfinite(saved["pl_mean"]) and saved["pl_mean"] != 0,
          f"options run checkpoint pl_mean {saved.get('pl_mean')}")
    opts = json.load(open(os.path.join(run, "training_options.json")))
    check(all(opts[k] == v for k, v in OPTIONS["C"].items()),
          "options run: training_options.json")
    loop_s = rows[1]["sec_per_kimg"] * TRAIN_BATCH / 1000
    print(f"[train-run] options run {OPTIONS['C']} (cli: --pl_weight 2 "
          f"--contextual_weight 1 --grad-accum 2), 4 steps in {seconds:.1f} s"
          f" | launches K1 fwd/dX, K2, K3, K1 fp32 {counts} = Gpl + R1 step "
          f"{first} + 3 x {rest} + the snapshot's draw | stats rows "
          f"pl_penalty {[round(p['mean'], 6) for p in pen]} (Gpl at step 0 "
          f"only) | checkpoint pl_mean {saved['pl_mean']:.6g} | s/step of "
          f"steps 3-4 from stats.jsonl {loop_s:.4f}", flush=True)
    return counts


def _narrow_dist_config(world):
    """The narrow fp32 config of phase 8 (64 px, no noise, ADA p = 0, VGG
    19 in fp32), global batch 4 over `world` ranks."""
    from pasta_tpu_torch.train.config import smoke_config

    return smoke_config(world, batch_size=4, use_noise=False,
                        vgg_weight=20.0, vgg_bf16=False)


def _narrow_dist_step(cfg, dev):
    """One step with both R1 phases from seed 0 on this rank's rows (the
    whole batch without a process group), its launches counted from 0 just
    before it: (metrics, each module's parameters flat, w_avg, ada_p,
    K1 fwd / K1 dX / K2 / K3 launches)."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.dist import rank, world_size
    from pasta_tpu_torch.train.entry import replicate, shard_batch
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import fetch_metrics, make_train_step

    state = replicate(init_state(cfg, seed=0, device=dev))
    vgg = VGG19Features(seed=3).to(dev).requires_grad_(False)
    batch = batch_to(shard_batch(example_batch(cfg, np.random.RandomState(0)),
                                 rank(), world_size()), dev)
    gen = torch.Generator(device=dev).manual_seed(rank())
    step = make_train_step(cfg, vgg)
    _sync(dev)
    bench_train.reset_kernel_counts()
    _, m = step(state, batch, gen, do_r1_d=True, do_r1_dp=True)
    _sync(dev)
    counts = bench_train.kernel_counts()
    return dict(metrics=fetch_metrics([m])[0],
                params={k: _flat_params(getattr(state, k)).cpu()
                        for k in ("g", "d", "dp", "g_ema")},
                w_avg=state.g.mapping.w_avg.cpu(), ada_p=float(state.ada_p),
                counts=counts)


def _dist_group_of_one(rank, world, init_method, out, dev):
    """(i), in a process of its own: the step twice without a process group
    and once in a group of one rank (NCCL on the card), deterministic
    cuDNN and torch ops throughout."""
    import torch.distributed as dist

    from pasta_tpu_torch.train.entry import init_distributed

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = _narrow_dist_config(1)
    plain = [_narrow_dist_step(cfg, dev) for _ in range(2)]
    dev = init_distributed(rank, world, init_method, dev)
    try:
        grouped = _narrow_dist_step(cfg, dev)
        grouped["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    torch.save(dict(plain=plain, grouped=grouped), out)


def _dist_gloo_rank(rank, world, init_method, out, dev):
    """(ii): one of `world` gloo ranks, on CUDA tensors all on card 0."""
    import torch.distributed as dist

    from pasta_tpu_torch.train.entry import init_distributed

    dev = init_distributed(rank, world, init_method, dev, backend="gloo")
    try:
        res = _narrow_dist_step(_narrow_dist_config(world), dev)
        res["backend"], res["device"] = dist.get_backend(), str(dev)
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{out}.{rank}")


def _same_bits(a, b):
    """Tensors (or dicts of them) equal bit for bit; the number that are
    not."""
    if isinstance(a, dict):
        return sum(_same_bits(v, b[k]) for k, v in a.items())
    return int(not torch.equal(a, b))


def phase_dist(dev="cuda"):
    """Data parallelism on the card (train/entry.py, train/dist.py):
    (i) an NCCL group of one rank, (ii) two gloo ranks on the one card,
    (iii) with two cards or more, min(4, cards) NCCL ranks at the fashion
    preset (cli/bench_train.py's data-parallel bench). Returns the
    launches each part made, summed over its ranks, and (iii)'s
    results or None."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.train.entry import spawn

    card = torch.device(dev).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="pasta_smoke_dist_")
    launched = [0, 0, 0, 0]
    # cuBLAS's deterministic workspace for (i)'s process, set before it
    # starts
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        # (i) the step in a group of one is the step without a group
        t0 = time.perf_counter()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        try:
            spawn(_dist_group_of_one, 1, "file://" + os.path.join(tmp, "rdv1"),
                  os.path.join(tmp, "one.pt"), dev)
        finally:
            if env is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        one = torch.load(os.path.join(tmp, "one.pt"), weights_only=False)
        a, a2, b = one["plain"][0], one["plain"][1], one["grouped"]
        repro = _same_bits(a["params"], a2["params"])
        check(repro == 0 and a["metrics"] == a2["metrics"],
              f"dist (i): the step without a group is not bit-reproducible "
              f"on the card ({repro} of 4 modules differ), so bit-equality "
              "with the grouped step cannot be held")
        diff = _same_bits(a["params"], b["params"])
        check(diff == 0 and _same_bits(a["w_avg"], b["w_avg"]) == 0
              and a["metrics"] == b["metrics"] and a["ada_p"] == b["ada_p"],
              f"dist (i): the step in an NCCL group of one differs from the "
              f"step without a group ({diff} of 4 modules; metrics "
              f"{a['metrics']} vs {b['metrics']})")
        check(b["backend"] == ("nccl" if card else "gloo"), b["backend"])
        check(b["counts"] == a["counts"] and (min(b["counts"]) > 0
                                              or not card),
              f"dist (i): launches {b['counts']} vs {a['counts']}")
        launched = [x + y for x, y in zip(launched, b["counts"])]
        print(f"[dist] (i) {b['backend']} group of one rank, narrow 64px "
              f"fp32 step "
              f"with R1 at batch 4: bit-equal to the step without a group "
              f"(parameters of G, D, DP, G-EMA, w_avg, ada_p, "
              f"{len(a['metrics'])} metrics; the plain step twice bit-equal "
              f"too) | launches K1 fwd/dX, K2, K3 {list(b['counts'])} | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (ii) two gloo ranks on CUDA tensors, one card, against (i)'s step
        # at the global batch
        t0 = time.perf_counter()
        out = os.path.join(tmp, "gloo.pt")
        spawn(_dist_gloo_rank, 2, "file://" + os.path.join(tmp, "rdv2"), out,
              dev)
        ranks = [torch.load(f"{out}.{r}", weights_only=False)
                 for r in range(2)]
        for r in ranks:
            check(r["backend"] == "gloo" and r["device"] == (
                "cuda:0" if card else "cpu"), (r["backend"], r["device"]))
            check(_same_bits(r["params"], ranks[0]["params"]) == 0
                  and r["metrics"] == ranks[0]["metrics"],
                  "dist (ii): the ranks' states differ")
            check(r["counts"] == a["counts"],
                  f"dist (ii): a rank launched {r['counts']}, one process "
                  f"{a['counts']}")
            launched = [x + y for x, y in zip(launched, r["counts"])]
        got = ranks[0]
        # phase 12's whole-step budget: metrics 1e-2 relative or 2e-3
        # absolute, parameters 1e-4 of each module's norm
        for k, v in a["metrics"].items():
            check(abs(got["metrics"][k] - v) <= max(2e-3, 1e-2 * abs(v)),
                  f"dist (ii): {k} {got['metrics'][k]} vs {v}")
        errs = {k: ((got["params"][k] - v).norm() / v.norm()).item()
                for k, v in a["params"].items()}
        errs["w_avg"] = ((got["w_avg"] - a["w_avg"]).norm()
                         / a["w_avg"].norm()).item()
        check(max(errs.values()) <= 1e-4 and got["ada_p"] == a["ada_p"],
              f"dist (ii): parameters {errs}, ada_p {got['ada_p']} vs "
              f"{a['ada_p']}")
        print(f"[dist] (ii) two gloo ranks on CUDA tensors on one card, "
              f"batch 2 a rank: ranks bit-equal; against one process at the "
              f"global batch 4: largest metric gap "
              f"{max(abs(got['metrics'][k] - v) for k, v in a['metrics'].items()):.3g}"
              f", parameters relative "
              f"{', '.join(f'{k} {v:.2g}' for k, v in errs.items())} | "
              f"launches a rank {list(got['counts'])} | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (iii) the fashion preset over the cards
    cards = torch.cuda.device_count()
    if not card:
        return launched, None
    if cards < 2:
        print(f"[dist] (iii) needs 2 CUDA devices or more, {cards} here: "
              "python3 -m pasta_tpu_torch.cli.bench_train --devices 4 on "
              "four cards runs it", flush=True)
        return launched, None
    world = min(4, cards)
    t0 = time.perf_counter()
    results = bench_train.bench_ranks(world, TRAIN_BATCH, N_TRAIN_TIMED)
    one_card = (TRAIN_K1_FWD, TRAIN_K1_DX, TRAIN_K2, TRAIN_K3)
    with_r1 = tuple(x + y for x, y in zip(one_card, (R1_K1_FWD, R1_K1_DX,
                                                      R1_K2, R1_K3)))
    for r in results:
        check(tuple(r["launches"]) == one_card
              and tuple(r["launches_r1"]) == with_r1,
              f"dist (iii) rank {r['rank']}: launches {r['launches']}, R1 "
              f"{r['launches_r1']}, not one card's {one_card}, {with_r1}")
        for k, v in list(r["metrics"].items()) + list(
                r["metrics_r1"].items()):
            check(np.isfinite(v), f"dist (iii) rank {r['rank']}: {k} = {v}")
        launched = [x + int(round(y * N_TRAIN_TIMED)) + z for x, y, z in
                    zip(launched, r["launches"], r["launches_r1"])]
    bench_train.print_ranks(results, TRAIN_BATCH)
    print(f"[dist] (iii) {world} NCCL ranks, fashion preset, batch "
          f"{TRAIN_BATCH} a card: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launched, results


N_INFER = 16           # persons of phase 14's synthetic root and its pairs
N_STREAM = 32          # pairs of the run_stream check (the 16 twice)
# cli.test with --g-bf16-res 3 against the fp32 parity run: at most this
# share of values beyond 1e-2 of the range and this mean over the range;
# 1.4x and 1.5x the reading on an H100 (10.712%, 4.97e-3 of the range).
BF16_GAP = (0.15, 7.5e-3)


def _composites(outdir, pairs):
    """The composites cli.test wrote: one PNG per pair, each [clothes |
    person | generated] of 320 columns, 512 rows."""
    import cv2

    names = sorted(os.listdir(outdir))
    want = sorted(f"{p[:-4]}___{c[:-4]}.png" for p, c in pairs)
    check(names == want, f"cli.test wrote {len(names)} files, not one PNG "
          f"per pair ({len(want)})")
    for name in names:
        img = cv2.imread(os.path.join(outdir, name))
        check(img is not None and img.shape == (512, 960, 3),
              f"composite {name}: {None if img is None else img.shape}")
    return len(names)


def _cli_test_run(k1, shift, shapes, argv, dev):
    """cli.test.main on `argv`: the generator's finetune outputs (every
    batch's: the parity pipeline's through a subclass put in place of
    models.Generator, the serving pipeline's as `run_batch` returns them,
    since a replayed CUDA graph calls no forward), K1's kernels and those
    in fp32 in a CUDA trace of the run, host seconds."""
    from pasta_tpu_torch import models
    from pasta_tpu_torch.cli import test as cli_test
    from pasta_tpu_torch.serving import TryonPipeline

    outs = []
    generator = models.Generator
    run_batch = TryonPipeline.run_batch
    serving = []

    class Recorded(generator):
        def forward(self, *args, **kw):
            res = super().forward(*args, **kw)
            if not serving:
                outs.append(res[1].float().cpu())
            return res

    def recorded_run_batch(pipe, items):
        serving.append(1)
        try:
            out = run_batch(pipe, items)
        finally:
            serving.pop()
        outs.append(out.float().cpu())
        return out

    models.Generator = Recorded
    TryonPipeline.run_batch = recorded_run_batch
    t0 = time.perf_counter()
    try:
        with _k1_traced(dev) as seen, _path_shapes(k1, shift, shapes):
            cli_test.main(argv + ["--device", dev])
            _sync(dev)
            secs = time.perf_counter() - t0
    finally:
        models.Generator = generator
        TryonPipeline.run_batch = run_batch
    return torch.cat(outs), seen["launches"], seen["fp32"], secs


def _budget(a, b):
    """(share of values off by more than 1e-2 of b's range, mean |a - b|
    over the range): the serving parity budget is 2e-2 and 1e-3."""
    span = float(b.max() - b.min())
    diff = (a - b).abs()
    return float((diff > 1e-2 * span).float().mean()), float(diff.mean()) / span


def _k1_rows(k1, shapes, dev, tag, phase="inference"):
    """Each K1 shape in `shapes` against plain on random inputs (fp32 1e-5,
    bf16 2^-7 of the output scale), K1 and plain timed in turns, cuDNN's
    F.conv2d on the same input, the bound. Returns phase 3's rows."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for xs, ws, dtype, out_w, pad in sorted(shapes, key=str):
        x = torch.randn(xs, device=dev, generator=g).to(dtype)
        w = (torch.randn(ws, device=dev, generator=g)
             / (9 * xs[3]) ** 0.5).to(dtype)
        got = k1._kernel(x, w, out_w, pad)
        ref = k1.conv3x3_valid_plain(x.float(), w.float(), out_w, pad)
        err = (got.float() - ref).abs().max().item()
        bound = _bound(ref, dtype)
        check(got.shape == ref.shape and err <= bound,
              f"{tag} K1 {list(xs)}->{ws[3]} {dtype} out_w {out_w}: err "
              f"{err} > bound {bound}")
        t_k1 = t_plain = t_lib = float("nan")
        if torch.device(dev).type == "cuda":
            t_k1, t_plain = turns(
                lambda: k1.conv3x3_valid_plain(x, w, out_w, pad),
                lambda: k1._kernel(x, w, out_w, pad), 5)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            t_lib = cuda_ms(lambda: F.conv2d(xn, wn), 5)
        ho, wo = got.shape[1], got.shape[2]
        t_bound, by, flop = conv_bound(xs[0], ho, wo, xs[3], ws[3], dtype,
                                       x.numel(), got.numel())
        print(f"[{phase}] {tag} K1 {str(dtype)[6:]} {list(xs)}->{ws[3]} "
              f"out_w {out_w}: max_abs_err {err:.3g} (bound {bound:.3g}) | "
              f"K1 {t_k1:.4f} ms ({flop / t_k1 / 1e9:.1f} TFLOP/s) | plain "
              f"{t_plain:.4f} | cuDNN {t_lib:.4f} | bound {t_bound:.4f} "
              f"({by}, {100 * t_bound / t_k1:.1f}%)", flush=True)
        rows.append(row(err, t_k1, t_plain, t_bound, by, t_lib, dtype))
        del x, w, got, ref
    _free(dev)
    return rows


def _prep_rates(pipe, root, pairs, native):
    """Host prep pairs/s with 1 and 8 threads, the plugin as it built and
    with its available() patched to False (cv2 / PIL)."""
    from pasta_tpu_torch.cli import bench

    rates = {}
    built = native.available
    for plugin in ((True, False) if built() else (False,)):
        native.available = built if plugin else (lambda: False)
        try:
            for threads in (1, 8):
                rates[(plugin, threads)] = bench.host_throughput(
                    pipe, root, pairs, num_workers=threads, reps=1)
        finally:
            native.available = built
    return rates


def phase_inference(k1, shift, dev="cuda"):
    """The try-on inference run (cli/test.py, data/testsets.py,
    TryonPipeline.run_stream, native/, cli/bench.py) on a synthetic root
    of N_INFER persons with a test_pairs.txt of as many pairs. Returns
    (K1 kernels traced in the cli.test runs, their fp32 share, the rows
    of every K1 shape they launched)."""
    from pasta_tpu_torch import native
    from pasta_tpu_torch.cli import bench
    from pasta_tpu_torch.data.synthetic import write_tryon_root
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    built = native.available()
    print(f"[inference] native plugin (g++ -ljpeg -lpng): "
          f"{'built' if built else 'not built: ' + str(native.build_error())}"
          f" in {time.perf_counter() - t0:.2f} s", flush=True)
    tmp = tempfile.mkdtemp(prefix="pasta_smoke_infer_")
    try:
        root = os.path.join(tmp, "root")
        pairs = write_tryon_root(root, N_INFER)
        shapes = {"K1": set(), "K2/K3": {}}
        runs = {}
        n_batches = -(-len(pairs) // BATCH)
        for tag, extra in (("parity", ["--pipeline", "parity"]),
                           ("serving", ["--pipeline", "serving",
                                        "--g-bf16-res", "3"]),
                           ("parity bf16", ["--pipeline", "parity",
                                            "--g-bf16-res", "3"]),
                           ("serving fp32", ["--pipeline", "serving"])):
            outdir = os.path.join(tmp, tag.replace(" ", "_"))
            argv = ["--dataroot", root, "--testtxt", "test_pairs.txt",
                    "--testpart", "upper", "--batchsize", str(BATCH),
                    "--outdir", outdir] + extra
            out, launches, fp32, secs = _cli_test_run(k1, shift, shapes,
                                                      argv, dev)
            n = _composites(outdir, pairs)
            check(tuple(out.shape) == (n_batches * BATCH, 512, 512, 3)
                  and bool(torch.isfinite(out).all()),
                  f"cli.test {tag}: outputs {tuple(out.shape)}, finite "
                  f"{bool(torch.isfinite(out).all())}")
            card = torch.device(dev).type == "cuda"
            check(not card or launches == K1_PER_BATCH * n_batches,
                  f"cli.test {tag}: K1 kernels traced {launches} != "
                  f"{K1_PER_BATCH} x {n_batches}")
            in_fp32 = "--g-bf16-res" not in extra
            check(not card or fp32 == (launches if in_fp32 else 0),
                  f"cli.test {tag}: {fp32} of {launches} K1 kernels took "
                  f"the fp32 kernel (fp32 run: {in_fp32})")
            runs[tag] = dict(out=out[:len(pairs)], launches=launches,
                             fp32=fp32)
            print(f"[inference] cli.test --pipeline {tag} --batchsize "
                  f"{BATCH}: {n} composites, {secs:.1f} s "
                  f"({n / secs:.2f} img/s with the model's build) | K1 "
                  f"kernels traced {launches} ({fp32} fp32) = "
                  f"{K1_PER_BATCH} x {n_batches} batches", flush=True)
        # The pipelines against each other in fp32, at the serving budget;
        # the bf16 serving run against the fp32 reference at BF16_GAP. bf16
        # in the top three resolutions moves the output more than the two
        # pipelines' differences do, and amplifies those: the pairs at one
        # precision in bf16, and bf16 against fp32 on the same inputs, are
        # printed beside them.
        held = {("serving fp32", "parity"): (2e-2, 1e-3),
                ("serving", "parity"): BF16_GAP}
        gaps = {}
        for got, ref in (("serving fp32", "parity"), ("serving", "parity"),
                         ("serving", "parity bf16"),
                         ("serving", "serving fp32"),
                         ("parity bf16", "parity")):
            gaps[got, ref] = _budget(runs[got]["out"], runs[ref]["out"])
            limit = held.get((got, ref))
            print(f"[inference] {got} against {ref}: "
                  f"{100 * gaps[got, ref][0]:.3f}% of values beyond 1e-2 of "
                  f"the range, mean {gaps[got, ref][1]:.3g} of the range ("
                  + (f"held: {100 * limit[0]:g}%, {limit[1]:g}" if limit
                     else "printed") + ")", flush=True)
        for (got, ref), (frac, mean) in held.items():
            check(gaps[got, ref][0] <= frac and gaps[got, ref][1] <= mean,
                  f"{got} against {ref}: {gaps[got, ref]} beyond "
                  f"{(frac, mean)}")
        launched = (sum(r["launches"] for r in runs.values()),
                    sum(r["fp32"] for r in runs.values()))
        k1_rows = _k1_rows(k1, shapes["K1"], dev, "path")
        fp32_n8 = {s for s in shapes["K1"] if s[2] == torch.float32}
        _k1_rows(k1, {((1,) + s[0][1:],) + s[1:] for s in fp32_n8}, dev,
                 "batch 1")
        del runs

        # run_stream against run_batch on the same items, bit for bit (the
        # rates come from cli.bench's measurements below)
        model = Generator(seed=0, num_bf16_res=3).eval().to(dev)
        pipe = TryonPipeline(model, mode="upper")
        stream_pairs = (pairs * 2)[:N_STREAM]
        streamed = list(pipe.run_stream(root, stream_pairs, BATCH))
        batched = []
        for i in range(0, len(stream_pairs), BATCH):
            items = [pipe.prepare_pair(root, p)
                     for p in stream_pairs[i:i + BATCH]]
            batched.append(pipe.run_batch(items).float().cpu().numpy())
        check([c for c, _ in streamed] == [stream_pairs[i:i + BATCH] for i
                                           in range(0, N_STREAM, BATCH)],
              "run_stream: chunks out of order")
        same = all(np.array_equal(o, b) for (_, o), b in
                   zip(streamed, batched))
        check(same, "run_stream outputs differ from run_batch's")
        rates = _prep_rates(pipe, root, pairs, native)
        print(f"[inference] run_stream {N_STREAM} pairs at batch {BATCH}: "
              f"bit-equal to run_batch on the same items | host prep "
              "pairs/s (cli.bench.host_throughput) "
              + ", ".join(f"{'plugin' if p else 'cv2/PIL'} {t} thread"
                          f"{'s' if t > 1 else ''} {r:.2f}"
                          for (p, t), r in rates.items()), flush=True)
        del model, pipe
        _free(dev)
        if torch.device(dev).type == "cuda":
            # run_stream's img/s: one pass over bench.STREAM_PAIRS pairs
            print(json.dumps(bench.run(batch=BATCH, iters=10, dataroot=root,
                                       also_batches=())), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[inference] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launched, k1_rows


EVAL_PERSONS = 16       # phase 15's synthetic root (its real images)
EVAL_GARMENTS = 4       # each person with 4 others' garments: 64 pairs
EVAL_BATCH = 32         # the detectors' batch (cli.calc_metrics --batch)
EVAL_ITEMS = 16         # held-out items of phase 15's training run
EVAL_STEPS = 2          # its steps: one tick, one evaluation
INCEPTION_K1, VGG16_K1 = 4, 3   # K1 launches a detector batch


@contextlib.contextmanager
def _detector_calls(k1, shapes, calls):
    """Inside the block, counts the detectors' batches (InceptionV3
    forwards, VGG16 backbones: calls["inception"], calls["vgg16"]) and
    records each distinct shape K1 launches at inside them in `shapes`.
    The launches and their counts are unchanged."""
    from pasta_tpu_torch.metrics.inception import InceptionV3
    from pasta_tpu_torch.metrics.vgg16 import VGG16

    conv, inc_fwd, vgg_bb = k1._kernel, InceptionV3.forward, VGG16.backbone
    inside = []

    def conv_seen(x, w, out_w, pad=0):
        if inside:
            shapes.add((tuple(x.shape), tuple(w.shape), x.dtype, out_w,
                        pad))
        return conv(x, w, out_w, pad)

    def counted(fn, name):
        def run(*args, **kw):
            calls[name] += 1
            inside.append(name)
            try:
                return fn(*args, **kw)
            finally:
                inside.pop()
        return run

    k1._kernel = conv_seen
    InceptionV3.forward = counted(inc_fwd, "inception")
    VGG16.backbone = counted(vgg_bb, "vgg16")
    try:
        yield
    finally:
        k1._kernel = conv
        InceptionV3.forward, VGG16.backbone = inc_fwd, vgg_bb


def phase_evaluation(k1, shift, dev="cuda", small=False):
    """Evaluation as users run it: cli.test's serving pipeline writes the
    composites of 64 pairs; cli.calc_metrics computes fid, kid,
    inception_score, pr (VGG16 fc7) and ppl (VGG16 LPIPS, the fashion
    Generator) against the persons' real images with seeded detectors at
    full width (.npz); cli.train runs 2 steps with the in-training metrics
    (fid, kid, fid_tryon over 16 held-out items). Then every K1 shape the
    detectors launched against plain, with times. `small` shrinks the
    roots, the batches and the training config (a CPU rehearsal).
    Returns (K1 launches of the three runs, the detector shapes' rows)."""
    import PIL.Image

    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.cli import calc_metrics as cli_metrics
    from pasta_tpu_torch.cli import test as cli_test
    from pasta_tpu_torch.cli import train as cli_train
    from pasta_tpu_torch.data.synthetic import write_dataset_root
    from pasta_tpu_torch.metrics import metric_main as mm
    from pasta_tpu_torch.metrics.inception import random_inception_state
    from pasta_tpu_torch.metrics.vgg16 import random_vgg16_state
    from pasta_tpu_torch.nn import synthesis as nsyn
    from pasta_tpu_torch.train import loop as tloop

    card = torch.device(dev).type == "cuda"
    persons = 4 if small else EVAL_PERSONS
    batch = 4 if small else EVAL_BATCH
    items = 2 if small else EVAL_ITEMS
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pasta_smoke_eval_")
    shapes, calls = set(), collections.Counter()
    launched = 0
    try:
        t0 = time.perf_counter()
        inc_npz = os.path.join(tmp, "inception.npz")
        vgg_npz = os.path.join(tmp, "vgg16.npz")
        np.savez(inc_npz, **{k: v.numpy() for k, v in
                             random_inception_state(0).items()})
        np.savez(vgg_npz, **{k: v.numpy() for k, v in
                             random_vgg16_state(0).items()
                             if not k.startswith("lins")})
        print(f"[evaluation] seeded detectors (InceptionV3 fp32, VGG16 fp32, "
              f"full widths) written as .npz in {time.perf_counter() - t0:.1f}"
              " s", flush=True)

        # (ii) the composites, then the five metrics through the CLI
        root = os.path.join(tmp, "root")
        names = write_dataset_root(root, persons, 600)
        pairs = [(names[i], names[(i + k) % persons])
                 for k in range(1, EVAL_GARMENTS + 1)
                 for i in range(persons)]
        with open(os.path.join(root, "test_pairs.txt"), "w") as f:
            f.write("".join(f"{c} {p}\n" for p, c in pairs))
        gen = os.path.join(tmp, "composites")
        serve_batch = 8
        t0 = time.perf_counter()
        with _k1_traced(dev) as seen:
            cli_test.main(["--dataroot", root, "--testtxt", "test_pairs.txt",
                           "--testpart", "upper", "--batchsize",
                           str(serve_batch), "--outdir", gen, "--pipeline",
                           "serving", "--g-bf16-res", "3", "--device", dev])
        served = seen["launches"]
        n = _composites(gen, pairs)
        print(f"[evaluation] cli.test --pipeline serving --g-bf16-res 3: {n} "
              f"composites of {persons} persons x {EVAL_GARMENTS} garments in "
              f"{time.perf_counter() - t0:.1f} s | K1 kernels traced "
              f"{served}",
              flush=True)
        check(not card or served == K1_PER_BATCH * -(-n // serve_batch),
              f"evaluation: cli.test K1 kernels traced {served}")

        launched += served
        k1.conv3x3_valid.launches = k1.conv3x3_valid.launches_fp32 = 0
        g_runs = []
        texture_fwd = nsyn.SynthesisBlockTexture.forward

        def texture_counted(self, *args, **kw):
            g_runs.append(1)
            return texture_fwd(self, *args, **kw)

        nsyn.SynthesisBlockTexture.forward = texture_counted
        t0 = time.perf_counter()
        try:
            with _detector_calls(k1, shapes, calls):
                records = cli_metrics.main([
                    "--metrics", "fid,kid,inception_score,pr,ppl",
                    "--real", os.path.join(root, "image"), "--gen", gen,
                    "--detector", inc_npz, "--vgg16-detector", vgg_npz,
                    "--crop-generated", "--dataroot", root, "--testtxt",
                    "test_pairs.txt", "--batch", str(batch), "--run-dir",
                    os.path.join(tmp, "metrics"), "--device", dev])
            _sync(dev)
        finally:
            nsyn.SynthesisBlockTexture.forward = texture_fwd
        seconds = time.perf_counter() - t0
        metric_k1 = k1.conv3x3_valid.launches
        launched += metric_k1
        values = {k: v for r in records for k, v in r["results"].items()}
        check(set(values) == {"fid", "kid", "is_mean", "is_std", "precision",
                              "recall", "ppl"}
              and all(np.isfinite(v) for v in values.values()),
              f"evaluation: calc_metrics results {values}")
        want = (INCEPTION_K1 * calls["inception"] + VGG16_K1 * calls["vgg16"]
                + G_FWD_K1 * len(g_runs))
        check(not card or (metric_k1 == want
                           and k1.conv3x3_valid.launches_fp32 == want),
              f"evaluation: calc_metrics K1 launches {metric_k1} "
              f"({k1.conv3x3_valid.launches_fp32} fp32) != {want}")
        print(f"[evaluation] cli.calc_metrics --crop-generated over {n} "
              f"composites and {persons} reals, --batch {batch}, in "
              f"{seconds:.1f} s: "
              + ", ".join(f"{r['metric']} {r['total_time']:.2f} s "
                          f"{json.dumps(r['results'])}" for r in records)
              + f" | K1 launches {metric_k1} (all fp32) = {INCEPTION_K1} x "
              f"{calls['inception']} Inception batches + {VGG16_K1} x "
              f"{calls['vgg16']} VGG16 + {G_FWD_K1} x {len(g_runs)} "
              "generator forwards (ppl)", flush=True)

        runner = mm.DetectorRunner(mm.load_detector(inc_npz, dev), batch)
        t0 = time.perf_counter()
        same = mm.calc_metric("fid", runner, os.path.join(root, "image"),
                              os.path.join(root, "image"))["results"]["fid"]
        check(abs(same) <= 1e-3, f"evaluation: FID of a folder against "
              f"itself {same}")

        crops = []
        for name in sorted(os.listdir(gen))[:batch]:
            crops.append(np.asarray(PIL.Image.open(os.path.join(
                gen, name)).convert("RGB"))[:, 640:960])
        imgs = torch.from_numpy(np.stack(crops)).to(dev)
        feats = runner._features(imgs[:8])[0].cpu()
        cpu = mm.DetectorRunner(mm.load_detector(inc_npz, "cpu"))
        ref = cpu._features(imgs[:8].cpu())[0]
        err = float((feats - ref).abs().max() / ref.abs().max())
        check(err <= 1e-4, f"evaluation: Inception features card vs CPU "
              f"{err} of the scale")
        rates = {}
        if card:
            vgg = mm.DetectorRunner(mm.load_vgg16_detector(vgg_npz, device=dev),
                                    batch, kind="vgg16")
            for tag, r in (("Inception (299 px)", runner),
                           ("VGG16 fc7 (224 px)", vgg)):
                rates[tag] = len(imgs) / cuda_ms(
                    lambda r=r: r._features(imgs), 3) * 1e3
            del vgg
        print(f"[evaluation] FID of the reals against themselves {same:.3g} "
              f"(held: |FID| <= 1e-3; {time.perf_counter() - t0:.1f} s with "
              f"the rest of this line) | Inception features of 8 composites "
              f"card vs CPU: {err:.3g} of their scale (held: 1e-4) | "
              "detector images/s at batch "
              f"{len(imgs)} (CUDA events): "
              + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()),
              flush=True)
        del runner, cpu, imgs
        _free(dev)

        # (iii) the training run with the in-training metrics
        train_root = os.path.join(tmp, "train_root")
        write_dataset_root(train_root, 6 if small else N_PERSONS, 500)
        taken, evals = [], []
        originals = (tloop.ParallelLoader, tloop.TrainingEvaluator.__call__)

        class Recording(originals[0]):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                get = self._get
                self._get = lambda i: taken.append(i) or get(i)

        def timed_eval(self, state):
            _sync(dev)
            t0 = time.perf_counter()
            out = originals[1](self, state)
            _sync(dev)
            evals.append(time.perf_counter() - t0)
            return out

        gens = []
        generate = tloop.TrainingEvaluator._generate

        def counted_generate(self, *args):
            gens.append(1)
            return generate(self, *args)

        tloop.ParallelLoader = Recording
        tloop.TrainingEvaluator.__call__ = timed_eval
        tloop.TrainingEvaluator._generate = counted_generate
        calls.clear()
        bench_train.reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            with _detector_calls(k1, shapes, calls):
                run = cli_train.main([
                    "--outdir", os.path.join(tmp, "runs"), "--cfg",
                    "smoke" if small else "fashion", "--batch",
                    "2" if small else str(TRAIN_BATCH), "--tick",
                    str(EVAL_STEPS), "--snap", "100", "--workers", "4",
                    "--data", train_root, "--max-steps", str(EVAL_STEPS),
                    "--metrics", "fid,kid,fid_tryon", "--metric-items",
                    str(items), "--metric-ticks", "1", "--inception",
                    inc_npz, "--device", dev])
            _sync(dev)
        finally:
            tloop.ParallelLoader = originals[0]
            tloop.TrainingEvaluator.__call__ = originals[1]
            tloop.TrainingEvaluator._generate = generate
        seconds = time.perf_counter() - t0
        counts = _launches(k1)
        launched += counts[0] + counts[1]
        with open(os.path.join(run, "stats.jsonl")) as f:
            (row,) = [json.loads(line) for line in f]
        got = {k: row.get(k) for k in ("fid_holdout", "kid_holdout",
                                       "fid_tryon")}
        check(all(v is not None and np.isfinite(v) for v in got.values()),
              f"evaluation: training run's stats row {row}")
        check(taken and min(taken) >= items,
              f"evaluation: the sampler took held-out items "
              f"{sorted(set(taken))[:8]}")
        first, rest = STEP_LAUNCHES["default", "r1"], STEP_LAUNCHES[
            "default", "regular"]
        ev = G_FWD_K1 * len(gens) + INCEPTION_K1 * calls["inception"]
        want = tuple(a + b + c + d for a, b, c, d in zip(
            first, rest, (G_FWD_K1, 0, 0, 0, G_FWD_K1), (ev, 0, 0, 0, ev)))
        check(not card or counts == want,
              f"evaluation: training run launches {counts} != {want}")
        print(f"[evaluation] cli.train --metrics fid,kid,fid_tryon "
              f"--metric-items {items} --metric-ticks 1, {EVAL_STEPS} steps "
              f"in {seconds:.1f} s: {json.dumps(got)} | one evaluation "
              f"{evals[0]:.2f} s ({len(gens)} G-EMA batches, "
              f"{calls['inception']} Inception batches) | sampled items "
              f"{sorted(set(taken))} (held out: 0..{items - 1}) | launches "
              f"K1 fwd/dX, K2, K3, K1 fp32 {counts} = R1 step {first} + "
              f"{rest} + the snapshot's draw + the evaluation's {ev}",
              flush=True)
        rows = _k1_rows(k1, shapes, dev, "detector", phase="evaluation")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[evaluation] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launched, rows


GRID_K = 3             # phase 16's cross-pair grid: 3 x 3 try-ons
PACKED_PERSONS = 8     # persons of the root dataset_tool packs
LEGACY_TOL = 1e-5      # card vs CPU, of the output's (gradient's) scale


def _card_vs_cpu(make, inputs, dev, tag, per_crop=False, **kw):
    """A module built on the CPU and its copy on `dev`, forward and
    backward (a seeded cotangent on the first output) on the same inputs:
    outputs, input and parameter gradients within LEGACY_TOL of their
    scale. With `per_crop`, the first input's gradient is held crop by
    crop and one crop may differ (a leaky-ReLU input within rounding of 0
    takes the other slope on one side). Returns (the largest error, the
    crops whose gradient took the other slope)."""
    import copy

    cpu = make()
    card = copy.deepcopy(cpu).to(dev)
    worst = 0.0
    sides = []
    for mod, where in ((cpu, "cpu"), (card, dev)):
        xs = [x.detach().to(where).requires_grad_(x.is_floating_point())
              for x in inputs]
        out = mod(*xs, **kw)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if o is not None]
        cot = torch.randn(outs[0].shape, generator=torch.Generator()
                          .manual_seed(16)).to(where)
        (outs[0] * cot).sum().backward()
        sides.append(([o.detach().cpu() for o in outs],
                      [x.grad.cpu() for x in xs if x.grad is not None],
                      [p.grad.cpu() for p in mod.parameters()
                       if p.grad is not None]))
    (o_c, xg_c, pg_c), (o_d, xg_d, pg_d) = sides
    flipped = 0
    for kind, a, b in (("output", o_d, o_c), ("input grad", xg_d, xg_c),
                       ("param grad", pg_d, pg_c)):
        check(len(a) == len(b) and len(a) > 0,
              f"legacy {tag}: {kind}s {len(a)} / {len(b)}")
        # a gradient's scale is that of the whole gradient: a bias ahead
        # of a batch norm has a gradient of rounding noise around 0
        scale = max(max(float(y.abs().max()) for y in b), 1e-30)
        for i, (x, y) in enumerate(zip(a, b)):
            if kind == "output":
                scale = max(float(y.abs().max()), 1e-30)
            err = (x - y).abs()
            if per_crop and kind == "input grad" and i == 0:
                crop = err.reshape(err.shape[0] * err.shape[1], -1)
                flipped = int((crop.amax(1) > LEGACY_TOL * scale).sum())
                check(flipped <= 1, f"legacy {tag}: {flipped} crops' "
                      "gradients beyond the bound")
                continue
            if kind == "param grad" and flipped:
                continue    # the flipped crop moves every weight's gradient
            e = float(err.max()) / scale
            worst = max(worst, e)
            check(e <= LEGACY_TOL, f"legacy {tag}: {kind} {i} card vs CPU "
                  f"{e:.3g} of its scale > {LEGACY_TOL}")
    return worst, flipped


def phase_surface(k1, shift, dev="cuda", small=False):
    """The training run's surface and the legacy layers. (a)
    cli.dataset_tool packs a synthetic root into a zip; cli.train --data
    <zip> runs 2 steps at 512 px with --tryon-grid 3 --trace DIR: the
    grid's size and seconds, the trace parsed, K1's kernels named in it,
    exact launches. (b) the patch D and a few legacy layers, forward and
    backward, card against CPU at a narrow size. `small` shrinks the
    training config (a CPU rehearsal). Returns the launches (K1 fwd, K1
    dX, K2, K3) of the phase."""
    from pasta_tpu_torch.cli import bench_train
    from pasta_tpu_torch.cli import dataset_tool
    from pasta_tpu_torch.cli import train as cli_train
    from pasta_tpu_torch.data.synthetic import write_dataset_root
    from pasta_tpu_torch.models import PatchCoOccurrenceDiscriminator
    from pasta_tpu_torch.nn import legacy as nl
    from pasta_tpu_torch.train import loop as tloop

    card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    launched = collections.Counter()

    # (a) dataset_tool -> cli.train --tryon-grid --trace
    tmp = tempfile.mkdtemp(prefix="pasta_smoke_grid_")
    try:
        src = os.path.join(tmp, "src")
        names = write_dataset_root(src, PACKED_PERSONS, 1600)
        packed = os.path.join(tmp, "packed.zip")
        t0 = time.perf_counter()
        dataset_tool.main(["--source", src, "--dest", packed])
        t_pack = time.perf_counter() - t0
        import zipfile
        with zipfile.ZipFile(packed) as zf:
            members = zf.namelist()
        check(sum(m.startswith("image/") for m in members) == len(names)
              and "dataset.json" in members,
              f"dataset_tool packed {len(members)} members")
        grid_s = []
        grid = tloop.save_cross_pair_grid

        def timed_grid(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            path = grid(*args, **kw)
            _sync(dev)
            grid_s.append(time.perf_counter() - t0)
            return path

        trace = os.path.join(tmp, "trace")
        tloop.save_cross_pair_grid = timed_grid
        bench_train.reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            run = cli_train.main([
                "--outdir", os.path.join(tmp, "runs"), "--cfg",
                "smoke" if small else "fashion", "--batch",
                "2" if small else str(TRAIN_BATCH), "--tick", "1", "--snap",
                "100", "--workers", "4", "--data", packed, "--loader-impl",
                "host" if small else "device",  # device: 512 px only
                "--max-steps", "2", "--tryon-grid", str(GRID_K),
                "--trace", trace, "--device", dev])
            _sync(dev)
        finally:
            tloop.save_cross_pair_grid = grid
        seconds = time.perf_counter() - t0
        counts = _launches(k1)
        launched.update(dict(zip("fdab", counts[:4])))
        with open(os.path.join(run, "stats.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        check([r["step"] for r in rows] == [1, 2],
              f"surface: traced run's stats rows {rows}")
        res = 64 if small else 512
        import PIL.Image
        img = PIL.Image.open(os.path.join(run, "tryon_grid000002.png"))
        side = (GRID_K + 1) * res + 4
        check(img.size == (side, side) and len(grid_s) == 1,
              f"surface: grid {img.size}, {len(grid_s)} grids")
        trace_file = os.path.join(trace, "trace.json")
        mb = os.path.getsize(trace_file) / 2 ** 20
        t0 = time.perf_counter()
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
        t_parse = time.perf_counter() - t0
        k1_events = [e for e in events if e.get("cat") == "kernel"
                     and "conv3x3" in e.get("name", "")]
        check(not card or k1_events,
              "surface: no K1 kernel (conv3x3) in the Chrome trace")
        first, rest = STEP_LAUNCHES["default", "r1"], STEP_LAUNCHES[
            "default", "regular"]
        draws = (2 * G_FWD_K1, 0, 0, 0, 2 * G_FWD_K1)  # snapshot + grid
        want = tuple(a + b + c for a, b, c in zip(first, rest, draws))
        check(small or not card or counts == want,
              f"surface: traced run launches {counts} != {want}")
        print(f"[surface] dataset_tool packed {len(names)} persons "
              f"({len(members)} members) in {t_pack:.2f} s | cli.train "
              f"--data packed.zip --max-steps 2 "
              f"--tryon-grid {GRID_K} --trace: {seconds:.1f} s, grid "
              f"{img.size[0]} x {img.size[1]} in {grid_s[0]:.2f} s, trace "
              f"{mb:.1f} MB ({len(events)} events, {len(k1_events)} K1 "
              f"kernels, parsed in {t_parse:.1f} s) | launches K1 fwd/dX, "
              f"K2, K3, K1 fp32 {counts} = R1 step {first} + {rest} + the "
              f"snapshot's and the grid's G forwards", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(dev)

    # (b) the patch D and legacy layers, card vs CPU
    gen = torch.Generator().manual_seed(17)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    bench_train.reset_kernel_counts()
    errs = {}
    errs["patch D"], flipped = _card_vs_cpu(
        lambda: PatchCoOccurrenceDiscriminator(
            crop_size=32, num_crops=4, channel_max=64, seed=0),
        [rand(2, 4, 32, 32, 3), rand(2, 2, 32, 32, 3)], dev, "patch D",
        per_crop=True)
    counts = _launches(k1)
    check(not card or counts[:2] == (8, 8),
          f"surface: patch D K1 fwd / dX {counts[:2]} != (8, 8)")
    launched.update(dict(zip("fdab", counts[:4])))
    mask = (rand(2, 16, 16, 1) > 0).float()
    errs["PartialResBlock"], _ = _card_vs_cpu(
        lambda: nl.PartialResBlock(8, 16, down=2), [rand(2, 16, 16, 8), mask],
        dev, "PartialResBlock")
    errs["SelfAttention"], _ = _card_vs_cpu(
        lambda: nl.SelfAttention(16), [rand(2, 8, 8, 16)], dev,
        "SelfAttention")
    errs["SpadeModulatedConv2d"], _ = _card_vs_cpu(
        lambda: nl.SpadeModulatedConv2d(8, 12),
        [rand(2, 8, 8, 8), rand(2, 8, 8, 8)], dev, "SpadeModulatedConv2d")
    errs["MaskPredictingToRGB"], _ = _card_vs_cpu(
        lambda: nl.MaskPredictingToRGB(8, 3, 16, is_last=True,
                                       deep_heads=True),
        [rand(2, 8, 8, 8), rand(2, 16)], dev, "MaskPredictingToRGB")
    errs["ResBlockDecoder"], _ = _card_vs_cpu(
        lambda: nl.ResBlockDecoder(16, 8), [rand(2, 8, 8, 16)], dev,
        "ResBlockDecoder", train=True)
    print("[surface] card vs CPU, forward and backward (largest error "
          f"of its scale, bound {LEGACY_TOL}; the patch D's K1 fwd / dX "
          f"{counts[:2]}, {flipped} crop's gradient flipped): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    print(f"[surface] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return tuple(launched[k] for k in "fdab")


MESH_STREAM = 64       # pairs of phase 17's run_stream through a mesh
MESH_TIMED = 10        # (e)'s timed run_batch batches, after a warm-up
# The JAX package's budget for its own split (tests/test_serving.py,
# test_pipeline_mesh_matches_single): mean |diff| over the range, and the
# share of values off by more than 1% of the range
SPLIT_BUDGET = (1e-4, 1e-3)


def _split_gap(got, ref):
    """(mean |got - ref| over ref's range, share of values off by more than
    1% of it, max |got - ref|, bit-equal)."""
    got, ref = got.float(), ref.float()
    span = float(ref.max() - ref.min())
    diff = (got - ref).abs()
    return (float(diff.mean()) / span,
            float((diff > 0.01 * span).float().mean()), float(diff.max()),
            bool(torch.equal(got, ref)))


def _hold_split(what, got, ref, bf16, alone=None):
    """Hold `got`, a batch split into shards, against `ref`, the batch run
    whole. fp32: the JAX package's split budget. bf16 (top 3): the shards'
    batch size moves cuBLAS's rounding of the encoders' and the mapping's
    fp32 matmuls by ~1e-7, which the bf16 layers amplify to about the gap
    between bf16 and fp32 (the same gap shows without a split, at batch 4
    against 8), so under "const" `got` is held bit-equal to `alone` (each
    shard's rows run alone without a mesh, concatenated), and otherwise to
    BF16_GAP. Returns the gap to `ref` (_split_gap)."""
    gap = _split_gap(got, ref)
    if not bf16:
        check(gap[0] < SPLIT_BUDGET[0] and gap[1] < SPLIT_BUDGET[1],
              f"{what}: the split against the whole batch {gap}")
    elif alone is not None:
        check(torch.equal(got, alone), f"{what}: the split differs from its "
              f"shards run alone: {_split_gap(got, alone)}")
    else:
        frac, mean = _budget(got, ref)
        check(frac <= BF16_GAP[0] and mean <= BF16_GAP[1],
              f"{what}: bf16 split against the whole batch {frac}, {mean} "
              f"beyond {BF16_GAP}")
    return gap


def _alone(pipe, items, shards):
    """`pipe`, a pipeline without a mesh ("const"), on each shard's rows,
    concatenated."""
    b = len(items) // shards
    return torch.cat([pipe.run_batch(items[k * b:(k + 1) * b])
                      for k in range(shards)])


# K1's serving shapes at batch 8 (H, C_in, C_out of the VALID conv)
K1_SERVING = ((514, 128, 64), (514, 64, 64), (514, 64, 128), (258, 128, 128))


def _k1_rows_invariant(k1, dev, dtype, batch):
    """K1 at half the batch gives rows 0.. of the whole batch's result bit
    for bit, at each serving shape (its per-item arithmetic does not
    depend on N). Counts are restored: these launches are a comparison."""
    counts = (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_fp32)
    g = torch.Generator(device=dev).manual_seed(5)
    for hw, ci, co in K1_SERVING:
        x = torch.randn(batch, hw, hw, ci, device=dev, generator=g).to(dtype)
        w = (torch.randn(3, 3, ci, co, device=dev, generator=g)
             / (9 * ci) ** 0.5).to(dtype)
        half = k1.conv3x3_valid(x[:batch // 2].contiguous(), w)
        check(torch.equal(k1.conv3x3_valid(x, w)[:batch // 2], half),
              f"mesh: K1 {dtype} [{hw},{ci}]->{co} at N = {batch // 2} "
              f"differs from rows of N = {batch}")
    k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_fp32 = counts


def _first_parting(pipe, items, shown=3):
    """The first modules of the generator (in the order they finish) whose
    output on the first half of `items` differs from the same rows of
    their output on all of them: [(name, max |diff|)]. The assembled
    inputs must agree bit for bit."""
    from pasta_tpu_torch.serving import assemble_inputs_device, ingest_device

    half = len(items) // 2
    with torch.inference_mode():
        inputs = [assemble_inputs_device(ingest_device(pipe._upload(its)),
                                         pipe.mode, tiled=True)
                  for its in (items, items[:half])]
        for k in inputs[0]:
            check(torch.equal(inputs[0][k][:half], inputs[1][k]),
                  f"mesh: assembled input {k} depends on the batch size")
        # the half batch first, its outputs kept; the whole batch's are
        # compared as they come and dropped
        kept, parted = {}, []

        def hook(name):
            def record(m, a, out):
                out = out[0] if isinstance(out, (tuple, list)) else out
                if not isinstance(out, torch.Tensor):
                    return
                if out.shape[0] == half and name not in kept:
                    kept[name] = out
                elif out.shape[0] == len(items) and name in kept:
                    ref = kept.pop(name)
                    if not torch.equal(out[:half], ref):
                        parted.append((name or "<generator>", float(
                            (out[:half].float() - ref.float()).abs().max())))
            return record

        hooks = [m.register_forward_hook(hook(name))
                 for name, m in pipe.model.named_modules()]
        try:
            for inp in inputs[::-1]:
                pipe.model(noise_mode="const", **inp)
        finally:
            for h in hooks:
                h.remove()
    return parted[:shown]


def _noisy(model, strength=0.05):
    """`model` with every noise strength set to `strength` (drawn as 0, so
    that the noise modes would agree)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(strength)
    return model


def _idle_by_card(prof):
    """{card: idle share} of a trace's kernels over the trace's device span
    (first kernel on any card to the last on any)."""
    from pasta_tpu_torch.cli.profile_serving import busy_us

    by = collections.defaultdict(list)
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.time_range.elapsed_us() > 0):
            by[e.device_index].append((e.time_range.start, e.time_range.end))
    check(by, "mesh: the trace holds no device time")
    t0 = min(s for iv in by.values() for s, _ in iv)
    t1 = max(e for iv in by.values() for _, e in iv)
    return {d: 1 - busy_us(iv) / (t1 - t0) for d, iv in sorted(by.items())}


def _sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _rates(pipe, items, batches):
    """(run_batch img/s over `batches` batches after a warm-up, host
    clock, one sync at the end; mean host ms to queue one batch)."""
    pipe.run_batch(items)
    _sync_cards()
    queued = []
    t0 = time.perf_counter()
    for _ in range(batches):
        t = time.perf_counter()
        pipe.run_batch(items)
        queued.append(time.perf_counter() - t)
    _sync_cards()
    return len(items) * batches / (time.perf_counter() - t0), \
        1e3 * float(np.mean(queued))


def _k1_every_card(k1, cards, dtype):
    """K1 launched on each card in turn from this process, at the serving
    shape [8,258,258,128]->128, against its plain version (fp32: 1e-5 of
    the output scale, bf16: 2^-7); the largest error of each. Counts are
    restored: these launches are a comparison."""
    counts = (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_fp32)
    errs = []
    for dev in cards:
        g = torch.Generator(device=dev).manual_seed(dev.index)
        x = torch.randn(BATCH, 258, 258, 128, device=dev,
                        generator=g).to(dtype)
        w = (torch.randn(3, 3, 128, 128, device=dev, generator=g)
             / 34.0).to(dtype)
        got = k1.conv3x3_valid(x, w).float()
        ref = k1.conv3x3_valid_plain(x.float(), w.float())
        scale = ref.abs().max().item()
        errs.append((got - ref).abs().max().item() / scale)
        check(errs[-1] <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5),
              f"mesh (e): K1 {dtype} on {dev} against plain {errs[-1]}")
    k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_fp32 = counts
    return errs


def _mesh_cards(k1, model, items, root, pairs, tag):
    """(e): the batch split over min(4, cards) cards from one process.
    Returns K1's launches."""
    from pasta_tpu_torch.cli import bench
    from pasta_tpu_torch.serving import TryonPipeline

    n = min(4, torch.cuda.device_count())
    cards = [torch.device("cuda", i) for i in range(n)]
    k1_errs = _k1_every_card(
        k1, cards, torch.bfloat16 if "bf16" in tag else torch.float32)
    k1.conv3x3_valid.launches = k1.conv3x3_valid.launches_fp32 = 0
    t0 = time.perf_counter()
    single = TryonPipeline(model, mode="upper")
    bf16 = "bf16" in tag
    ones = [single]
    with TryonPipeline(model, mode="upper", mesh=cards) as mesh:
        gaps = {}
        for noise_mode in ("const", "random"):
            one = TryonPipeline(model, mode="upper", noise_mode=noise_mode,
                                seed=1)
            ones.append(one)
            with TryonPipeline(model, mode="upper", noise_mode=noise_mode,
                               seed=1, mesh=cards) as split:
                got = split.run_batch(items)
            check(got.device == cards[0], f"mesh (e): output on {got.device}")
            alone = None
            if bf16 and noise_mode == "const":
                ones.append(TryonPipeline(model, mode="upper"))
                alone = _alone(ones[-1], items, n)
            gaps[noise_mode] = _hold_split(
                f"mesh (e) {tag} {noise_mode}, {n} cards", got,
                one.run_batch(items), bf16, alone)
        rates = {"mesh": _rates(mesh, items, MESH_TIMED),
                 "one card, batch 8": _rates(single, items[:BATCH],
                                             MESH_TIMED),
                 f"one card, batch {len(items)}": _rates(single, items,
                                                         MESH_TIMED)}
        streams = {"mesh": bench.stream_throughput(mesh, root, pairs,
                                                   len(items)),
                   "one card, batch 8": bench.stream_throughput(
                       single, root, pairs, BATCH)}
        mesh.run_batch(items)
        _sync_cards()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            mesh.run_batch(items)
            _sync_cards()
        idle = _idle_by_card(prof)
    launches = k1.conv3x3_valid.launches
    fp32 = k1.conv3x3_valid.launches_fp32
    # stream_throughput: a warm-up batch, then the pairs in whole batches;
    # the pipelines without a mesh launch K1 from the host only in the
    # batches that replay no CUDA graph (a replay's kernels are the
    # graph's, phases 4, 14 and 15 count those in a trace)
    mesh_batches = 1 + -(-bench.STREAM_PAIRS // len(items))
    want = (K1_PER_BATCH * n * (2 + (1 + MESH_TIMED) + mesh_batches + 2)
            + K1_PER_BATCH * sum(p.graph_counts["capture"]
                                 + p.graph_counts["eager"] for p in ones))
    check(launches == want and fp32 == (launches if "fp32" in tag else 0),
          f"mesh (e) {tag}: K1 launches {launches} ({fp32} fp32) != {want}")
    check(len(idle) == n, f"mesh (e) {tag}: kernels on cards {list(idle)}")
    for noise_mode, (mean, frac, mx, same) in gaps.items():
        print(f"[mesh] (e) {tag}, {n} cards vs one at batch {len(items)}, "
              f"{noise_mode}: mean {mean:.3g} of the range, {frac:.3g} off "
              f"by 1%, max {mx:.3g}, bit-equal {same}"
              + (" (held: bit-equal to its shards run alone)"
                 if bf16 and noise_mode == "const" else ""), flush=True)
    print(f"[mesh] (e) {tag}: run_batch img/s (host ms to queue a batch) "
          + ", ".join(f"{k} {r:.2f} ({q:.1f} ms)" for k, (r, q) in
                      rates.items())
          + f" | run_stream {bench.STREAM_PAIRS} pairs img/s "
          + ", ".join(f"{k} {r:.2f}" for k, r in streams.items())
          + " | idle share of a profiled mesh batch by card "
          + ", ".join(f"cuda:{d} {v:.3f}" for d, v in idle.items())
          + f" | K1 launches {launches} | K1 on each card against plain, "
          "of the scale: " + ", ".join(f"{e:.3g}" for e in k1_errs)
          + f" | {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_mesh(k1, dev="cuda", small=False):
    """TryonPipeline(mesh=...): a batch split over devices, at full width
    in fp32 (cli.test's default) and with bf16 in the top 3 resolutions.
    (a) a mesh of one card, its model copied there from the host, against
    the pipeline without a mesh on the same batch, under "const" and
    "random" noise (noise strengths 0.05): bit-equal; (b) two shards on
    one card against the pipeline without a mesh at batch 8: the JAX
    package's split budget, the max diff and bit-equality printed; (c)
    run_stream through the two shards over 64 pairs, bit-equal to the
    mesh's run_batch batch by batch; (d) K1's launches exact, 26 a shard;
    (e) with two cards or more, a mesh of min(4, cards) cards against one
    card, with img/s, the host's ms to queue a batch and each card's idle
    share. `small` takes the narrow G at batch 2 and 4 pairs (a CPU
    rehearsal). Returns K1's launches of the phase."""
    from pasta_tpu_torch.data.synthetic import write_tryon_root
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    d0 = torch.device("cuda", 0) if card else torch.device("cpu")
    batch = 2 if small else BATCH
    narrow = dict(channel_base=2048, channel_max=128) if small else {}
    n_stream = 2 * batch if small else MESH_STREAM
    launched = 0
    tmp = tempfile.mkdtemp(prefix="pasta_smoke_mesh_")
    try:
        root = os.path.join(tmp, "root")
        pairs = write_tryon_root(root, N_INFER)
        stream_pairs = [pairs[i % len(pairs)] for i in range(n_stream)]
        items = stream_items = None
        for bf16_res in (0, 3):
            tag = "bf16 top 3" if bf16_res else "fp32"
            t0 = time.perf_counter()
            host_model = _noisy(Generator(seed=0, num_bf16_res=bf16_res,
                                          **narrow).eval())
            model = copy.deepcopy(host_model).to(d0)
            if items is None:
                prep = TryonPipeline(model, mode="upper")
                items = _items(prep, range(batch), 3.0)
                stream_items = [prep.prepare_pair(root, p)
                                for p in stream_pairs]
                check(all(bool(it["tiles_fit"]) for it in items),
                      "mesh: the batch does not fit its paste tiles")
            dtype = torch.bfloat16 if bf16_res else torch.float32
            if card:
                _k1_rows_invariant(k1, d0, dtype, batch)
            parted = _first_parting(TryonPipeline(model, mode="upper"), items)
            k1.conv3x3_valid.launches = k1.conv3x3_valid.launches_fp32 = 0
            refs, gaps, alone_eager = {}, {}, 0
            for noise_mode in ("const", "random"):
                kw = dict(mode="upper", noise_mode=noise_mode, seed=1)
                refs[noise_mode] = TryonPipeline(model, **kw).run_batch(items)
                # (a) the model copied from the host to the mesh's one card
                with TryonPipeline(host_model, mesh=[d0], **kw) as one:
                    got = one.run_batch(items)
                check(torch.equal(got, refs[noise_mode]),
                      f"mesh (a) {tag} {noise_mode}: a mesh of one device "
                      f"differs from the pipeline without a mesh: "
                      f"{_split_gap(got, refs[noise_mode])}")
                # (b) two shards on one card
                with TryonPipeline(model, mesh=[d0, d0], **kw) as two:
                    got = two.run_batch(items)
                alone = None
                if bf16_res and noise_mode == "const":
                    solo = TryonPipeline(model, mode="upper")
                    alone = _alone(solo, items, 2)
                    alone_eager = (solo.graph_counts["capture"]
                                   + solo.graph_counts["eager"])
                    gaps[f"without a mesh, batch {batch // 2} twice"] = (
                        _split_gap(alone, refs[noise_mode]))
                gaps[noise_mode] = _hold_split(
                    f"mesh (b) {tag} {noise_mode}", got, refs[noise_mode],
                    bool(bf16_res), alone)
            check(not torch.equal(refs["const"], refs["random"]),
                  f"mesh {tag}: random noise changed nothing")
            # (c) run_stream through the two shards
            with TryonPipeline(model, mode="upper", mesh=[d0, d0]) as two:
                streamed = list(two.run_stream(root, stream_pairs, batch))
                check([c for c, _ in streamed]
                      == [stream_pairs[i:i + batch]
                          for i in range(0, n_stream, batch)],
                      f"mesh (c) {tag}: run_stream's chunks out of order")
                for i, (_, out) in enumerate(streamed):
                    ref = two.run_batch(
                        stream_items[i * batch:(i + 1) * batch])
                    check(np.array_equal(out, ref.float().cpu().numpy()),
                          f"mesh (c) {tag}: run_stream batch {i} differs "
                          "from the mesh's run_batch")
            _sync(dev)
            # (d) 26 a shard: (a) 2 x (1 + 1), (b) 2 x 2, (c) 2 x 2 a
            # batch; bf16: the two shards alone, of which K1's counters
            # see those that replayed no CUDA graph
            n_batches = n_stream // batch
            want = K1_PER_BATCH * (4 + 4 + alone_eager + 4 * n_batches)
            launches = k1.conv3x3_valid.launches
            fp32 = k1.conv3x3_valid.launches_fp32
            check(not card or (launches == want and fp32 == (
                0 if bf16_res else launches)),
                  f"mesh (d) {tag}: K1 launches {launches} ({fp32} fp32) "
                  f"!= {want}")
            launched += launches
            held = ("bit-equal to its shards alone under const, "
                    f"BF16_GAP {BF16_GAP} under random" if bf16_res else
                    f"budget {SPLIT_BUDGET[0]:g}, {SPLIT_BUDGET[1]:g}")
            for what, (mean, frac, mx, same) in gaps.items():
                print(f"[mesh] (b) {tag}, [cuda:0, cuda:0] vs no mesh at "
                      f"batch {batch}, {what}: mean {mean:.3g} of the "
                      f"range, {frac:.3g} off by 1%, max {mx:.3g}, "
                      f"bit-equal {same} (held: {held})", flush=True)
            print(f"[mesh] {tag}: K1 at N = {batch // 2} bit-equal to rows "
                  f"of N = {batch} at {len(K1_SERVING) if card else 0} "
                  f"serving shapes, and the assembled inputs; the first "
                  f"modules whose outputs part: "
                  + (", ".join(f"{n} (max {d:.3g})" for n, d in parted)
                     or "none"), flush=True)
            print(f"[mesh] {tag}: (a) [cuda:0] from the host's model "
                  f"bit-equal, const and random | (c) run_stream {n_stream} "
                  f"pairs through [cuda:0, cuda:0] bit-equal to run_batch, "
                  f"{n_batches} batches | (d) K1 launches {launches} "
                  f"({fp32} fp32) = {K1_PER_BATCH} x {want // K1_PER_BATCH}"
                  f" shards | {time.perf_counter() - t0:.1f} s", flush=True)
            # (e) the cards of the machine
            cards = torch.cuda.device_count() if card else 0
            if cards >= 2:
                wide = _items(TryonPipeline(model, mode="upper"),
                              range(BATCH * min(4, cards)), 3.0)
                launched += _mesh_cards(k1, model, wide, root, pairs, tag)
            elif card:
                print(f"[mesh] (e) {tag} needs 2 CUDA devices or more, "
                      f"{cards} here: python3 chip_smoke.py --only mesh on "
                      "a machine with several runs it", flush=True)
            del host_model, model
            _free(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["mesh", "spade"],
                        help="build the kernels and run these phases alone "
                        "(mesh: phase 17, its part (e) on every card "
                        "there is, up to four; spade: phases 3c, 4 and 7, "
                        "the SPADE pair's)")
    args = parser.parse_args(argv)
    smi = phase_device()
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    from pasta_tpu_torch.ops import affine_warp as shift
    from pasta_tpu_torch.ops import conv3x3 as k1

    # the module (the package's attribute of that name is the function)
    fir = importlib.import_module("pasta_tpu_torch.ops.upfirdn2d")
    sn = importlib.import_module("pasta_tpu_torch.ops.spade_norm")
    phase_build(k1, shift, fir, sn)
    if args.only == "mesh":
        print(json.dumps({"phase": "mesh",
                          "launches_mesh": phase_mesh(k1)}))
        print(smi)
        return
    if args.only == "spade":
        spade_rows, spade_eager, spade_traced = phase_kernel_spade(sn, BATCH)
        phase_main(fir, sn, BATCH, N_TIMED)
        spade_train = phase_train(k1, fir, sn)[4]
        print(json.dumps({"phase": "spade", "launches_serving": spade_eager,
                          "traced_serving": spade_traced,
                          "launches_train_step": spade_train[0],
                          "ms": sum(r["ms"] for r in spade_rows),
                          "bound_ms": sum(r["bound_ms"] for r in spade_rows),
                          "plain_ms": sum(r["plain_ms"]
                                          for r in spade_rows)}))
        print(smi)
        return
    rows = phase_kernel(k1, BATCH)
    fir_rows, fir_serving = phase_kernel_fir(fir, BATCH)
    spade_rows, spade_eager, spade_traced = phase_kernel_spade(sn, BATCH)
    launches, fir_main, spade_main = phase_main(fir, sn, BATCH, N_TIMED)
    phase_check()
    train_rows = phase_kernel_train(k1, shift)
    counts, n_fp32, step_s, fir_train, spade_train = phase_train(k1, fir,
                                                                 sn)
    phase_train_check(shift)
    run_counts, opt_run = phase_train_run(k1, step_s)
    opt_counts, opt_shapes = phase_train_options(k1, shift)
    opt_errs = phase_options_kernels(k1, shift, opt_shapes)
    phase_options_check()
    dist_counts, _ = phase_dist()
    infer_counts, infer_rows = phase_inference(k1, shift)
    eval_launches, eval_rows = phase_evaluation(k1, shift)
    surface_counts = phase_surface(k1, shift)
    mesh_launches = phase_mesh(k1)
    k1_rows = rows + train_rows["K1"] + infer_rows + eval_rows

    def total(rs, key):
        return sum(r[key] for r in rs)

    def entry(name, source, replaces, launched, rs, err, **extra):
        """Sums over the shapes timed against plain above; `bound_by` is the
        side (operations or bytes) that makes up more of the summed bound;
        `err` the largest error at the options steps' shapes."""
        by = collections.Counter()
        for r in rs:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in rs]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launched,
                    max_abs_err=max([r["err"] for r in rs] + [err]),
                    ms=total(rs, "ms"), plain_ms=total(rs, "plain_ms"),
                    bound_ms=total(rs, "bound_ms"),
                    bound_by=by.most_common(1)[0][0],
                    library_ms=None if None in lib else sum(lib), **extra)

    fp32 = [r for r in k1_rows if r["dtype"] == torch.float32]
    bf16 = [r for r in k1_rows if r["dtype"] == torch.bfloat16]
    k1_total = counts[0] + counts[1]
    # launches: each main path driven with the counts at 0 just before it
    # and read just after (serving, the bare training steps, the training
    # run through the command line and its run with the options, the
    # options' steps, the data-parallel steps summed over their ranks, the
    # inference runs through cli.test, the evaluation's serving run,
    # metrics and training run with the metrics, the traced training run
    # with its grid and the patch D, the mesh's batches over every card),
    # summed
    print(json.dumps({"kernels": [
        entry("conv3x3_valid", "pasta_tpu_torch/csrc/conv3x3.cu",
              "pasta_tpu/ops/pallas_conv.py:139",
              launches + k1_total + sum(run_counts[:2]) + sum(opt_run[:2])
              + sum(opt_counts[:2]) + sum(dist_counts[:2]) + infer_counts[0]
              + eval_launches + sum(surface_counts[:2]) + mesh_launches,
              k1_rows, opt_errs["K1"], launches_serving=launches,
              launches_train=counts[0],
              launches_dx=counts[1], launches_train_run=run_counts[0],
              launches_train_run_dx=run_counts[1],
              launches_train_fp32=n_fp32,
              launches_train_bf16=k1_total - n_fp32,
              launches_options=opt_counts[0],
              launches_options_dx=opt_counts[1],
              launches_options_fp32=opt_counts[4],
              launches_options_run=opt_run[0],
              launches_dist=dist_counts[0], launches_dist_dx=dist_counts[1],
              launches_options_run_dx=opt_run[1],
              launches_inference=infer_counts[0],
              launches_inference_fp32=infer_counts[1],
              ms_inference=total(infer_rows, "ms"),
              launches_evaluation=eval_launches,
              launches_surface=surface_counts[0],
              launches_surface_dx=surface_counts[1],
              launches_mesh=mesh_launches,
              ms_evaluation=total(eval_rows, "ms"),
              ms_fp32=total(fp32, "ms"), ms_bf16=total(bf16, "ms"),
              bound_ms_fp32=total(fp32, "bound_ms"),
              bound_ms_bf16=total(bf16, "bound_ms"),
              library_ms_fp32=total(fp32, "library_ms"),
              library_ms_bf16=total(bf16, "library_ms")),
        entry("shift_fwd", "pasta_tpu_torch/csrc/shift.cu",
              "pasta_tpu/ops/affine_warp.py:142",
              counts[2] + run_counts[2] + opt_run[2] + opt_counts[2]
              + dist_counts[2] + surface_counts[2],
              train_rows["K2"], opt_errs["K2"], launches_train=counts[2],
              launches_train_run=run_counts[2], launches_options=opt_counts[2],
              launches_options_run=opt_run[2],
              launches_dist=dist_counts[2],
              launches_surface=surface_counts[2]),
        entry("shift_bwd", "pasta_tpu_torch/csrc/shift.cu",
              "pasta_tpu/ops/affine_warp.py:181",
              counts[3] + run_counts[3] + opt_run[3] + opt_counts[3]
              + dist_counts[3] + surface_counts[3],
              train_rows["K3"], opt_errs["K3"], launches_train=counts[3],
              launches_train_run=run_counts[3], launches_options=opt_counts[3],
              launches_options_run=opt_run[3],
              launches_dist=dist_counts[3],
              launches_surface=surface_counts[3]),
        # launches: the serving batches' eager runs (phase 4), the
        # training steps' forward and gradient launches (phase 7: a
        # warm-up and N_TRAIN_TIMED regular steps, one R1 step)
        entry("upfirdn2d", "pasta_tpu_torch/csrc/upfirdn2d.cu",
              "none (pasta_tpu/ops/upfirdn2d.py: lax.conv_general_dilated)",
              fir_main[0] + (1 + N_TRAIN_TIMED) * sum(fir_train[0])
              + sum(fir_train[1]), fir_rows, 0.0,
              launches_serving=fir_main[0], traced_serving=fir_main[1],
              launches_train_step=fir_train[0][0],
              launches_train_step_dx=fir_train[0][1],
              launches_r1_step=fir_train[1][0],
              launches_r1_step_dx=fir_train[1][1], launches_plain=0,
              ms_serving_batch=total(fir_serving, "ms"),
              bound_ms_serving_batch=total(fir_serving, "bound_ms"),
              plain_ms_serving_batch=total(fir_serving, "plain_ms"),
              library_ms_serving_batch=total(fir_serving, "library_ms")),
        # launches: phase 3c's fp32 serving batch run eagerly, phase 4's
        # (bf16 blocks: none, its calls plain), the training steps' (phase
        # 7); the rows: phase 3c's calls of one batch, forward then
        # backward
        entry("spade_norm_act", "pasta_tpu_torch/csrc/spade_norm.cu",
              "none (pasta_tpu/nn/synthesis.py: XLA fuses the chain)",
              spade_eager + spade_main[0]
              + (1 + N_TRAIN_TIMED) * sum(spade_train[0])
              + sum(spade_train[1]), spade_rows, 0.0,
              launches_serving=spade_eager, traced_serving=spade_traced,
              launches_serving_bf16=spade_main[0],
              launches_train_step=spade_train[0][0],
              launches_train_step_bwd=spade_train[0][1],
              launches_r1_step=spade_train[1][0],
              launches_r1_step_bwd=spade_train[1][1],
              launches_plain=spade_main[2],
              ms_serving_batch=total(spade_rows[:len(spade_rows) // 2],
                                     "ms"),
              bound_ms_serving_batch=total(
                  spade_rows[:len(spade_rows) // 2], "bound_ms"),
              plain_ms_serving_batch=total(
                  spade_rows[:len(spade_rows) // 2], "plain_ms")),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
