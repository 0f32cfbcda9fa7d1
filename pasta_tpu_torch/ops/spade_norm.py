"""SPADE's instance normalisation and the pre-activation of the conv that
takes its result, NHWC.

For x [N, H, W, C] and gb [N, H, W, 2C] (gamma = the first C channels,
beta = the last C), `spade_norm_act` computes

    clamp(relu(instance_norm(x) * (1 + gamma) + beta) * gain, -clamp, clamp)

which is what `nn/synthesis.py::SpadeNormBlock` hands the next
`SpadeConv2dLayer` once that layer's pre-activation (relu, x gain, clamp)
has run: the moments per (n, c) over H, W, biased variance, eps 1e-5,
fp32.

On a CUDA fp32 tensor whose C / 4 is a power of two up to 256 (64 and 128
in the generator) the call launches the hand-written kernels of
`csrc/spade_norm.cu` (CUDA C++ for sm_90a, built with nvcc at first use,
bound with ctypes): a moments pass (two launches: the blocks' partials,
then their merge in a fixed order) and one apply pass that reads gamma and
beta through gb's strides, with no copy of gb. The moments can be taken
once for two calls on the same x (`spade_norm_stats`), as `SpadeResBlock`
does for its skip and first conv. The kernels replace no TPU kernel; see
the source for their bound and design. Every other call computes
`spade_norm_act_plain`, today's chain op for op: CPU tensors (so the CPU
parity tests against the JAX package stay bit for bit), bf16 (whose
rounding points, bf16 after the normalisation, need a design of their
own), and other shapes.

The kernel route is one torch.autograd.Function whose backward is a kernel
too (three launches: the two per-(n, c) sums of instance-norm backward as
partials, their merge, then dx and dgb in one pass); it recomputes the
relu and clamp masks from x, the moments and gb, and keeps no y. The
backward is once differentiable: no path of the port differentiates the
SPADE blocks twice (Gpl's style branch and the Ds' R1 never reach them).

Counters, over every card and host thread of the process:
`spade_norm_act.launches` the kernels launched for forwards (the moments'
two and each apply's one), `.launches_bwd` those of backwards (three
each), `.launches_plain` the calls that took the plain route outside the
kernels' scope (a CPU tensor in scope takes it uncounted). Like K1's they
count what ran: a launch captured into a CUDA graph is not counted, nor is
a replay.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library
from .bias_act import bias_act

EPS = 1e-5
_REDUCE_BLOCKS = 528         # the moments' blocks over a batch: 4 an SM
_count_lock = threading.Lock()


def instance_norm_2d(x, eps=EPS):
    """Per-sample, per-channel normalization over H, W of an NHWC tensor
    (biased variance, moments in fp32 or x's wider type, output in the
    input dtype)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def spade_norm(x, gb):
    """SPADE's normalisation alone, as plain ops: instance_norm(x)
    * (1 + gamma) + beta, gamma and beta the halves of gb's channels."""
    gamma, beta = gb.chunk(2, dim=-1)
    return instance_norm_2d(x) * (1 + gamma) + beta


def spade_norm_act_plain(x, gb, gain, clamp):
    """The plain chain (arguments as `spade_norm_act`'s), differentiable by
    autograd: the kernels' reference and the route of every call outside
    their scope."""
    return bias_act(spade_norm(x, gb), act="relu", gain=gain, clamp=clamp)


def _bind(lib):
    i, p, f, s = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, \
        ctypes.c_longlong
    lib.pasta_spade_norm_stats.argtypes = [p] * 5 + [i] * 5 + [f, p]
    lib.pasta_spade_norm_apply.argtypes = ([p, p] + [s] * 4 + [p] * 3
                                           + [i] * 4 + [f, f, p])
    lib.pasta_spade_norm_backward.argtypes = ([p] + [s] * 4 + [p, p]
                                              + [s] * 4 + [p] * 8
                                              + [i] * 5 + [f, f, p])
    for fn in (lib.pasta_spade_norm_stats, lib.pasta_spade_norm_apply,
               lib.pasta_spade_norm_backward):
        fn.restype = ctypes.c_int


def build():
    """Compile csrc/spade_norm.cu (once per source digest) and load it;
    returns (ctypes library, seconds spent compiling, compiler output)."""
    return load_library("spade_norm.cu", _bind)


def x_in_scope(x):
    """Whether the kernels take an x: fp32 NHWC with C / 4 a power of two
    up to 256, and a grid the card can launch. A test of shapes alone."""
    if x.dtype != torch.float32 or x.ndim != 4 or x.numel() == 0:
        return False
    n, h, w, c = x.shape
    v = c // 4
    return (c % 4 == 0 and v <= 256 and v & (v - 1) == 0 and n <= 65535
            and h <= 65535 and h * w < 2 ** 24)


def in_scope(x, gb):
    """Whether the kernels take the call: x in scope, gb of x's dtype and
    device and of shape [N, H, W, 2C]."""
    return (x_in_scope(x) and gb.dtype == x.dtype and gb.device == x.device
            and tuple(gb.shape) == (*x.shape[:3], 2 * x.shape[3]))


def _plain_route(x):
    """CPU tensors take the plain version; every other device the kernel."""
    return x.device.type == "cpu"


def _capturing(x):
    return x.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _count(x, name, k):
    """Add k to a counter, unless the launches are being captured."""
    if _capturing(x):
        return
    with _count_lock:       # a mesh queues its cards from several threads
        setattr(spade_norm_act, name, getattr(spade_norm_act, name) + k)


def _vectors(t):
    """Whether the kernels can read t's channels in place as 16-byte
    vectors: C stride 1, aligned. A stride of a dimension of size 1 is
    never read."""
    used = [s for s, d in zip(t.stride()[:3], t.shape[:3]) if d > 1]
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in used))


def _readable(t):
    """gb as the kernels read it in place: channel vectors (`_vectors`) or
    runs along W (W stride 1, staged); else a contiguous copy."""
    if _vectors(t) or t.stride(2) == 1 or t.shape[2] == 1:
        return t
    return t.contiguous()


def _rows(n, h):
    """Rows of one image a reduction block takes: about `_REDUCE_BLOCKS`
    blocks over the batch. The partition depends on the shape alone."""
    per_image = max(1, -(-_REDUCE_BLOCKS // n))
    return -(-h // min(h, per_image))


def _check(err, what):
    if err == -1:
        raise ValueError(f"spade_norm: {what} outside the kernels' scope")
    if err != 0:
        raise RuntimeError(f"spade_norm: {what} launch failed, CUDA error "
                           f"{err}")


def _stats(x):
    """mean, rstd [N, C] fp32 of a contiguous CUDA x: two launches."""
    lib, _, _ = build()
    n, h, w, c = x.shape
    rows = _rows(n, h)
    blocks = -(-h // rows)
    part = torch.empty((2, n, blocks, c), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_spade_norm_stats(
            x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), n, h, w, c, rows, EPS,
            stream)
    _check(err, "moments")
    return out[0], out[1]


def _apply(x, gb, mean, rstd, gain, clamp):
    """y, contiguous: one launch; gb readable as it lies (`_readable`)."""
    lib, _, _ = build()
    n, h, w, c = x.shape
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_spade_norm_apply(
            x.data_ptr(), gb.data_ptr(), *gb.stride(), mean.data_ptr(),
            rstd.data_ptr(), y.data_ptr(), n, h, w, c, gain, clamp, stream)
    _check(err, "apply")
    return y


def _backward(dy, x, gb, mean, rstd, gain, clamp):
    """dx and dgb, contiguous: three launches; dy read as channel vectors
    (`_vectors`), gb readable."""
    lib, _, _ = build()
    n, h, w, c = x.shape
    rows = _rows(n, h)
    blocks = -(-h // rows)
    part = torch.empty((2, n, blocks, c), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dgb = torch.empty((n, h, w, 2 * c), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_spade_norm_backward(
            dy.data_ptr(), *dy.stride(), x.data_ptr(), gb.data_ptr(),
            *gb.stride(), mean.data_ptr(), rstd.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), dx.data_ptr(), dgb.data_ptr(), n, h, w, c,
            rows, gain, clamp, stream)
    _check(err, "backward")
    return dx, dgb


class _SpadeNormAct(torch.autograd.Function):
    """The kernels' forward (moments given) and backward: dx through the
    moments too, so the moments enter as constants."""

    @staticmethod
    def forward(ctx, x, gb, mean, rstd, gain, clamp):
        ctx.save_for_backward(x, gb, mean, rstd)
        ctx.act = (gain, clamp)
        y = _apply(x, gb, mean, rstd, gain, clamp)
        _count(x, "launches", 1)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gb, mean, rstd = ctx.saved_tensors
        # G's backward hands dy NHWC (a pad's gradient slices it); any
        # other layout is copied
        dy = dy if _vectors(dy) else dy.contiguous()
        dx, dgb = _backward(dy, x, gb, mean, rstd, *ctx.act)
        _count(x, "launches_bwd", 3)
        return (dx if ctx.needs_input_grad[0] else None,
                dgb if ctx.needs_input_grad[1] else None,
                None, None, None, None)


def spade_norm_stats(x):
    """The moments (mean, rstd) that kernel-route `spade_norm_act` calls on
    this same x can share, computed once; None where x takes the plain
    route (each such call then normalises x itself, as the chain does)."""
    if not x_in_scope(x) or _plain_route(x):
        return None
    stats = _stats(x.contiguous())
    _count(x, "launches", 2)
    return stats


def spade_norm_act(x, gb, gain, clamp, stats=None):
    """clamp(relu(instance_norm(x) * (1 + gamma) + beta) * gain, +-clamp).

    Args:
        x:     [N, H, W, C].
        gb:    [N, H, W, 2C]: gamma, then beta, along the channels; any
               strides.
        gain:  the scale after the relu (rounded to x's dtype, as
               `bias_act` rounds it).
        clamp: the clamp after the scale, or None.
        stats: `spade_norm_stats(x)`, to share the moments between calls
               on the same x; taken here where None.

    Returns:
        [N, H, W, C] in x's dtype; contiguous NHWC where the kernels
        computed it.
    """
    assert x.ndim == 4 and gb.ndim == 4
    if not in_scope(x, gb):
        _count(x, "launches_plain", 1)
        return spade_norm_act_plain(x, gb, gain, clamp)
    if _plain_route(x):
        return spade_norm_act_plain(x, gb, gain, clamp)
    x = x.contiguous()
    mean, rstd = stats if stats is not None else spade_norm_stats(x)
    cl = float("inf") if clamp is None else float(clamp)
    return _SpadeNormAct.apply(x, _readable(gb), mean, rstd, float(gain), cl)


spade_norm_act.launches = 0
spade_norm_act.launches_bwd = 0
spade_norm_act.launches_plain = 0
