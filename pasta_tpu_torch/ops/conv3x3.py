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

The bf16 kernel also takes `pad` = 2: x [N, H, W, C_in] is read as if a
2-px border of zeros surrounded it and the result is [N, H+2, out_w,
C_out] for any out_w. That is the input gradient of the pad-0 conv taken
on dY as it lies.

What bounds bf16 on an H100: at [8,514,514,128] x [3,3,128,64] the conv is
~309 GFLOP over ~0.81 GB of input and output, ~380 FLOP/B, just above the
bf16 ridge of ~295 FLOP/B (989 TFLOP/s over 3.35 TB/s), so compute bound;
64 -> 64 is ~285 FLOP/B, at the ridge. The design therefore keeps device
traffic at its floor and the tensor cores fed: the products run on wgmma
(m64nNk16, both operands read from shared memory by descriptor, fp32
accumulators in registers); the input arrives by TMA, one row of 66
pixels a box with the 128-byte swizzle, whose zero fill outside the tensor
serves the ragged edges and the implicit halo; persistent blocks walk
down strips 64 pixels wide with a ring of input rows in shared memory, a
producer warp loading ahead of two consumer warpgroups that take
alternate output rows; the weights ([9, C_out, C_in], K-major, one small
copy a launch) stay in shared memory for the life of a block (128 -> 128
as two blocks of 64 channels each). See csrc/conv3x3.cu for the tiling.

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
a CPU tensor (it never falls back); its input gradient is again a 3x3
conv -- of dY with a halo of 2, the weights rotated 180 degrees with C_in
and C_out swapped -- computed by the same Function, so it runs K1 and is
itself differentiable (R1's double backward goes through it). In bf16 the
halo is implicit (`pad` = 2: one launch on dY, no copy); in fp32 dY is
padded with F.pad first. dW is a
plain differentiable expression (`torch.nn.grad.conv2d_weight`), as the
JAX package leaves the weight gradient to XLA. A dX whose channels fall
outside K1's scope (C_out not in {64, 128}) is the plain conv, chosen from
the shape. `conv3x3_valid.launches` counts forward launches,
`.launches_bwd` the launches made for input gradients, `.launches_fp32`
those of either kind that took the fp32 kernel; each over every card and
host thread of the process. They count the launches this module makes:
a launch captured into a CUDA graph runs nothing and is not counted, nor
are the kernels a graph's replay runs (a trace of the card sees those).
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_count_lock = threading.Lock()


def _bind(lib):
    fn = lib.pasta_conv3x3_valid
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.pasta_conv3x3_f32_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int
    tiles = lib.pasta_conv3x3_bf16_tiles
    tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    tiles.restype = ctypes.c_int


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


def _window(x, out_w, pad):
    """x as the `pad`-ed conv reads it: `pad` zeros above, below and to the
    left, columns cut or zero-filled on the right to out_w + 2 in all."""
    need = out_w + 2 - pad
    xs = x[:, :, :need] if need < x.shape[2] else x
    right = need - xs.shape[2]
    return F.pad(xs, (0, 0, pad, right, pad, pad)) if pad or right else xs


def conv3x3_valid_plain(x, w, out_w=None, pad=0):
    """Plain PyTorch version of K1: F.conv2d with no padding, same NHWC
    contract; with `pad`, of x surrounded by zeros (`pad` of them above,
    below and to the left, as many as out_w asks for to the right). Used
    for CPU tensors and as the kernel's reference."""
    out_w = x.shape[2] + 2 * pad - 2 if out_w is None else out_w
    xs = _window(x, out_w, pad).permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x, w, out_w, pad):
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
    # contiguous NHWC with C_in in {64, 128} also gives the bf16 kernel's
    # tensor map what it needs: strides that are multiples of 16 bytes
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_valid: x must be contiguous NHWC, "
                         "16-byte aligned")
    if x.dtype == torch.bfloat16:
        # the halo comes from the tensor map's bounds: any out_w
        ok = pad in (0, 2) and x.shape[1] + 2 * pad >= 3 and out_w >= 1
    else:
        ok = pad == 0 and x.shape[1] >= 3 and 1 <= out_w <= x.shape[2] - 2
    if not ok or min(x.shape) < 1 or max(x.shape) >= 2 ** 31:
        raise ValueError(f"conv3x3_valid: out_w {out_w}, pad {pad} for "
                         f"{x.dtype} input {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError("conv3x3_valid: x and w on different devices")


def _kernel_weights(w, dtype):
    """The weights as the kernel of `dtype` reads them: fp32 HWIO as it is;
    bf16 K-major [9, 64 or 128, C_in] with zero rows past C_out."""
    if dtype != torch.bfloat16:
        return w.contiguous()
    _, _, ci, co = w.shape
    wk = w.reshape(9, ci, co).transpose(1, 2)
    rows = 64 if co <= 64 else 128
    if co == rows:
        return wk.contiguous()
    out = w.new_zeros((9, rows, ci))
    out[:, :co] = wk
    return out


def _kernel(x, w, out_w, pad=0):
    """One launch of K1 into a fresh tensor (no autograd history)."""
    _check(x, w, out_w, pad)
    lib, _, _ = build()
    n, hin, win, ci = x.shape
    co = w.shape[3]
    wk = _kernel_weights(w, x.dtype)
    if wk.data_ptr() % 16:
        raise ValueError("conv3x3_valid: w must be 16-byte aligned")
    out = torch.empty((n, hin + 2 * pad - 2, out_w, co), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_conv3x3_valid(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            n, hin, win, ci, co, out_w, pad, stream)
    if err != 0:
        raise RuntimeError(
            "conv3x3_valid: "
            + (f"tensor map encoding failed, CUresult {err - 20000}"
               if err >= 20000 else f"kernel launch failed, CUDA error {err}"))
    return out


def _plain_route(x):
    """CPU tensors take the plain version; every other device the kernel."""
    return x.device.type == "cpu"


def _launch(x, w, out_w, bwd, pad):
    if _plain_route(x):
        return conv3x3_valid_plain(x, w, out_w, pad)
    out = _kernel(x, w, out_w, pad)
    if x.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return out
    with _count_lock:       # a mesh queues its cards from several threads
        if x.dtype == torch.float32:
            conv3x3_valid.launches_fp32 += 1
        if bwd:
            conv3x3_valid.launches_bwd += 1
        else:
            conv3x3_valid.launches += 1
    return out


def _implicit_halo(t):
    """Whether K1's kernel for t's dtype takes a halo from the tensor's
    bounds (bf16: TMA's zero fill) or needs it copied in (fp32)."""
    return t.dtype == torch.bfloat16


def _input_grad(dy, w, wp, pad=0):
    """dX [.., wp, C_in] of the conv with `pad`: the conv of dY with pad
    2 - `pad` and the weights rotated 180 degrees, C_in/C_out swapped."""
    wr = w.flip(0, 1).transpose(2, 3)
    kernel_takes = in_scope(wr.shape[2], wr.shape[3])
    if _implicit_halo(dy):
        # The bf16 kernel takes its halo from the bounds of dY: one launch
        # on dY as it lies, zero columns past the last one dY reaches
        # included.
        # (wr stays a view: its K-major form for the kernel is w.flip as it
        # lies in memory, so no second copy of the weights is made)
        if kernel_takes:
            # (autograd may hand over a strided dY, an expanded one after a
            # sum: only that is copied)
            return _Conv3x3.apply(dy.contiguous(), wr, wp, True, 2 - pad)
        return conv3x3_valid_plain(dy, wr, wp, 2 - pad)
    # Here the routes part: the fp32 kernel tiles the image as one flat run
    # of positions and cannot take a halo from the tensor's bounds, so dY is
    # copied into a padded tensor, and the columns that no dY reaches are
    # padded on afterwards.
    p = 2 - pad
    dyp = F.pad(dy, (0, 0, p, p, p, p)) if p else dy
    width = min(wp, dyp.shape[2] - 2)
    if width < 1:                       # no column of dX is reached by dY
        return dy.new_zeros((dy.shape[0], dyp.shape[1] - 2, wp, w.shape[2]))
    if kernel_takes:
        dx = _Conv3x3.apply(dyp, wr.contiguous(), width, True, 0)
    else:          # C_out outside {64, 128}: K1 cannot take the dX shape
        dx = conv3x3_valid_plain(dyp, wr, width)
    return F.pad(dx, (0, 0, 0, wp - width)) if wp > width else dx


def _weight_grad(x, dy, w_shape, pad=0):
    """dW (HWIO) as a differentiable plain expression (cuDNN's weight
    gradient on CUDA); only the columns up to out_w + 2 contribute. Where
    the halo is the same on all sides the call pads implicitly, else x is
    copied into its window."""
    if pad and dy.shape[2] == x.shape[2] + 2 * pad - 2:
        xs, padding = x, pad
    else:
        xs, padding = _window(x, dy.shape[2], pad), 0
    kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv2d_weight(xs.permute(0, 3, 1, 2), (co, ci, kh, kw),
                                     dy.permute(0, 3, 1, 2), padding=padding)
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """K1 (or its plain version on CPU tensors) with its gradients; `bwd`
    marks the launches made for an input gradient. The conv with pad 0 has
    an input gradient with pad 2 and the reverse, so the Function is closed
    under differentiation."""

    @staticmethod
    def forward(ctx, x, w, out_w, bwd, pad):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        return _launch(x, w, out_w, bwd, pad)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(dy, w, x.shape[2], ctx.pad)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, dy, w.shape, ctx.pad)
        return dx, dw, None, None, None


def conv3x3_valid(x, w, out_w=None):
    """VALID 3x3 conv: [N, H+2, W', C_in] x [3, 3, C_in, C_out] (HWIO)
    -> [N, H, out_w, C_out], differentiable. K1 on CUDA tensors, the plain
    version on CPU tensors."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    return _Conv3x3.apply(x, w.to(x.dtype), out_w, False, 0)


conv3x3_valid.launches = 0
conv3x3_valid.launches_bwd = 0
conv3x3_valid.launches_fp32 = 0
