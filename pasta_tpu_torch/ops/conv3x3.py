"""K1: hand-written Hopper kernel for the VALID 3x3 convolution, NHWC.

Replaces the Pallas kernel `pasta_tpu/ops/pallas_conv.py::conv3x3_valid`,
both branches: the C_in=64 lane-packed `_kernel_packed` and the C_in=128
`_kernel_direct`. The source is `csrc/conv3x3.cu` (CUDA C++ for sm_90a),
built with nvcc at first use into `pasta_tpu_torch/_build/<digest>/` and
bound through ctypes.

Contract (the Pallas kernel's): x [N, H+2, W', C_in] already carries its
1-px halo; w is HWIO [3, 3, C_in, C_out]; the result is [N, H, out_w, C_out]
in x's dtype with fp32 accumulation; out_w defaults to W' - 2. Scope:
stride 1, groups 1, C_in in {64, 128}, C_out <= 128, bf16 or fp32.

What bounds it on an H100: at [8,514,514,128] x [3,3,128,64] the conv is
~309 GFLOP over ~0.81 GB of input and output, ~380 FLOP/B, just above the
bf16 ridge of ~295 FLOP/B (989 TFLOP/s over 3.35 TB/s), so compute bound;
64 -> 64 is ~285 FLOP/B, at the ridge. The design therefore keeps device
traffic at its floor -- each block stages the 4-row input slab of two
output rows in shared memory once and reuses it for all 9 taps, so an
input pixel is read ~2 times, mostly from L2 -- and puts the arithmetic on
the tensor cores (mma.sync bf16 with fp32 accumulators, ldmatrix on
conflict-free padded rows), with the next tap's weights copied (cp.async)
while the current tap computes. wgmma, TMA and warp specialisation are
later work; see csrc/conv3x3.cu for the tiling.

fp32 (the generator and VGG19 in training) takes its own kernel, in full
fp32 products on the CUDA cores: one-pass TF32 would keep about three
digits, too few for R1's gradients. There the conv is compute bound by
~10x (154.6 GFLOP over 0.8 GB at [4,514,514,128]x[3,3,128,64]: 2.31 ms at
the 67 TFLOP/s fp32 peak), so the design counts FFMAs per load: an 8x8
accumulator tile a thread, operands read from shared memory as 16-byte
vectors free of bank conflicts, the 4 + 2 input values of a run of
positions reused by the three taps of a row from registers (19 FFMAs per
shared-memory load), C_in staged 8 channels at a time through a cp.async
ring and transposed on the way in, two blocks an SM. The image is tiled
as one flat run of positions, so the input gradient's 514-wide rows waste
0.4% of the work instead of a fifth tile of 128 pixels.

`conv3x3_valid` is one torch.autograd.Function on every device: its
forward launches K1 on a CUDA tensor and computes `conv3x3_valid_plain` on
a CPU tensor (it never falls back); its input gradient is again a VALID
3x3 conv -- dY padded by 2, the weights rotated 180 degrees with C_in and
C_out swapped -- computed by the same Function, so it runs K1 and is
itself differentiable (R1's double backward goes through it). dW is a
plain differentiable expression (`torch.nn.grad.conv2d_weight`), as the
JAX package leaves the weight gradient to XLA. A dX whose channels fall
outside K1's scope (C_out not in {64, 128}) is the plain conv, chosen from
the shape. `conv3x3_valid.launches` counts forward launches,
`.launches_bwd` the launches made for input gradients, `.launches_fp32`
those of either kind that took the fp32 kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _bind(lib):
    fn = lib.pasta_conv3x3_valid
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.pasta_conv3x3_f32_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int


def build():
    """Compile csrc/conv3x3.cu (once per source digest) and load it.

    Returns (ctypes library, seconds spent compiling, compiler output with
    ptxas's register and spill counts); the seconds are 0 and the output
    empty when a library built from the same source is already there.
    """
    return load_library("conv3x3.cu", _bind)


def in_scope(c_in, c_out):
    """Channel scope of K1 (the Pallas kernel's own asserted scope)."""
    return c_in in (64, 128) and c_out <= 128


def conv3x3_valid_plain(x, w, out_w=None):
    """Plain PyTorch version of K1: F.conv2d with no padding, same NHWC
    contract. Used for CPU tensors and as the kernel's reference."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    xs = x[:, :, :out_w + 2, :].permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x, w, out_w):
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_valid: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3x3_valid: dtype {x.dtype} not bf16/fp32")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(
            f"conv3x3_valid: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if not in_scope(x.shape[3], w.shape[3]):
        raise ValueError(
            f"conv3x3_valid: channels {x.shape[3]}->{w.shape[3]} outside "
            "C_in in {64,128}, C_out <= 128")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_valid: x must be contiguous NHWC, "
                         "16-byte aligned")
    if x.shape[1] < 3 or not 1 <= out_w <= x.shape[2] - 2:
        raise ValueError(
            f"conv3x3_valid: out_w {out_w} for input {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError("conv3x3_valid: x and w on different devices")


def _kernel(x, w, out_w):
    """One launch of K1 into a fresh tensor (no autograd history)."""
    _check(x, w, out_w)
    lib, _, _ = build()
    n, hp, wp, ci = x.shape
    co = w.shape[3]
    wk = w.contiguous()
    if wk.data_ptr() % 16:
        raise ValueError("conv3x3_valid: w must be 16-byte aligned")
    out = torch.empty((n, hp - 2, out_w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_conv3x3_valid(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            n, hp, wp, ci, co, out_w, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_valid: kernel launch failed, "
                           f"CUDA error {err}")
    return out


def _plain_route(x):
    """CPU tensors take the plain version; every other device the kernel."""
    return x.device.type == "cpu"


def _launch(x, w, out_w, bwd):
    if _plain_route(x):
        return conv3x3_valid_plain(x, w, out_w)
    out = _kernel(x, w, out_w)
    if x.dtype == torch.float32:
        conv3x3_valid.launches_fp32 += 1
    if bwd:
        conv3x3_valid.launches_bwd += 1
    else:
        conv3x3_valid.launches += 1
    return out


def _input_grad(dy, w, wp):
    """dX of the VALID conv: a VALID 3x3 conv of dY padded by 2 with the
    weights rotated 180 degrees and C_in/C_out swapped, cropped at
    out_w + 2 columns and zero-padded back to the input width `wp`."""
    out_w = dy.shape[2]
    dyp = F.pad(dy, (0, 0, 2, 2, 2, 2))
    wr = w.flip(0, 1).transpose(2, 3)
    if in_scope(wr.shape[2], wr.shape[3]):
        dx = _Conv3x3.apply(dyp, wr.contiguous(), out_w + 2, True)
    else:          # C_out outside {64, 128}: K1 cannot take the dX shape
        dx = conv3x3_valid_plain(dyp, wr)
    return F.pad(dx, (0, 0, 0, wp - out_w - 2)) if wp > out_w + 2 else dx


def _weight_grad(x, dy, w_shape):
    """dW (HWIO) as a differentiable plain expression (cuDNN's weight
    gradient on CUDA); only the columns up to out_w + 2 contribute."""
    xs = x[:, :, :dy.shape[2] + 2].permute(0, 3, 1, 2)
    kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv2d_weight(xs, (co, ci, kh, kw),
                                     dy.permute(0, 3, 1, 2))
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """K1 (or its plain version on CPU tensors) with its gradients; `bwd`
    marks the launches made for an input gradient."""

    @staticmethod
    def forward(ctx, x, w, out_w, bwd):
        ctx.save_for_backward(x, w)
        return _launch(x, w, out_w, bwd)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(dy, w, x.shape[2])
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, dy, w.shape)
        return dx, dw, None, None


def conv3x3_valid(x, w, out_w=None):
    """VALID 3x3 conv: [N, H+2, W', C_in] x [3, 3, C_in, C_out] (HWIO)
    -> [N, H, out_w, C_out], differentiable. K1 on CUDA tensors, the plain
    version on CPU tensors."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    return _Conv3x3.apply(x, w.to(x.dtype), out_w, False)


conv3x3_valid.launches = 0
conv3x3_valid.launches_bwd = 0
conv3x3_valid.launches_fp32 = 0
