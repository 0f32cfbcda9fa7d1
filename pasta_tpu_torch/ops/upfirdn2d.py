"""Pad -> zero-upsample -> FIR filter -> downsample, NHWC.

Port of pasta_tpu/ops/upfirdn2d.py. The JAX version is one
`lax.conv_general_dilated` per (separable) pass with lhs_dilation for the
zero-upsampling and negative conv padding for crops. `upfirdn2d_plain`
spells the same function the way the reference's `_upfirdn2d_ref` does:
zero-insertion by reshape + pad, an explicit pad/crop, then a depthwise
`F.conv2d` whose stride does the downsampling. Both insert `up - 1` zeros
after every input sample, so the padding/crop semantics (`_parse_padding`)
are identical.

On a CUDA tensor a call in the kernel's scope -- a 2-D filter of at most
4 x 4 taps (or none), up and down 1 or 2 on each axis, fp32 or bf16 --
launches the hand-written kernel of `csrc/upfirdn2d.cu` (CUDA C++ for
sm_90a, built with nvcc at first use, bound with ctypes): one pass,
polyphase, in NHWC, the inserted zeros never stored, the result contiguous
NHWC. It replaces no TPU kernel; see the source for its bound and design.
On a CPU tensor the same call computes `upfirdn2d_plain`. A call outside
the scope computes `upfirdn2d_plain` on every device, chosen from the
shapes.

Every call, on every route, is one `_Upfirdn2d`: a torch.autograd.Function
whose input gradient is the same op with up and down swapped, the filter
flipped and the padding transposed (StyleGAN2-ADA's CUDA upfirdn2d does the
same), computed by the same Function. So a double backward (R1 through the
discriminator's resampling) launches the kernel again, or takes the plain
route again outside the scope, and never differentiates a grouped conv.
The filter is a constant and gets no gradient.

Counters, over every card and host thread of the process:
`upfirdn2d.launches` the kernel's launches for a forward call,
`.launches_bwd` those made for an input gradient, `.launches_plain` the
calls outside the kernel's scope, forward or gradient. Like K1's, they
count what ran: a launch captured into a CUDA graph is not counted, nor is
a replay.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_TAPS = 4
_count_lock = threading.Lock()


def _parse_scaling(scaling):
    if isinstance(scaling, (int, np.integer)):
        scaling = [int(scaling), int(scaling)]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, (int, np.integer)):
        padding = [int(padding), int(padding)]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _get_filter_size(f):
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])


def upfirdn2d_plain(x, f, up=1, down=1, padding=0, flip_filter=False,
                    gain=1):
    """Plain PyTorch upfirdn2d (arguments as `upfirdn2d`'s), differentiable
    by autograd: the kernel's reference, the CPU tensors' forward and the
    route of calls outside the kernel's scope."""
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    f = torch.as_tensor(f, dtype=torch.float32)
    assert f.ndim in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)

    n, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2)                       # NCHW view
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]

    # Correlation after an optional flip (reference: flip unless
    # flip_filter), gain**(ndim/2) per pass, taps cast to x's dtype.
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = (f * (float(gain) ** (f.ndim / 2))).to(device=x.device, dtype=x.dtype)
    if f.ndim == 2:
        x = F.conv2d(x, f[None, None].repeat(c, 1, 1, 1),
                     stride=(downy, downx), groups=c)
    else:
        x = F.conv2d(x, f[None, None, None].repeat(c, 1, 1, 1),
                     stride=(1, downx), groups=c)
        x = F.conv2d(x, f[None, None, :, None].repeat(c, 1, 1, 1),
                     stride=(downy, 1), groups=c)
    return x.permute(0, 2, 3, 1)


def _bind(lib):
    fn = lib.pasta_upfirdn2d
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def build():
    """Compile csrc/upfirdn2d.cu (once per source digest) and load it;
    returns (ctypes library, seconds spent compiling, compiler output)."""
    return load_library("upfirdn2d.cu", _bind)


def _out_hw(h, w, f, p):
    upx, upy, downx, downy, px0, px1, py0, py1 = p[:8]
    fw, fh = _get_filter_size(f)
    return ((h * upy + py0 + py1 - fh) // downy + 1,
            (w * upx + px0 + px1 - fw) // downx + 1)


def in_scope(x, f, p):
    """Whether the kernel takes the call: `p` = (upx, upy, downx, downy,
    px0, px1, py0, py1, flip, gain); a 2-D filter of at most 4 x 4 taps or
    none, up and down 1 or 2 on each axis, fp32 or bf16, a non-empty
    result. A test of shapes alone."""
    if x.dtype not in _DTYPE_CODE or x.numel() == 0 or x.shape[0] > 65535:
        return False
    if f is not None and not (f.ndim == 2 and f.shape[0] <= _MAX_TAPS
                              and f.shape[1] <= _MAX_TAPS):
        return False
    if any(s not in (1, 2) for s in p[:4]):
        return False
    return min(_out_hw(x.shape[1], x.shape[2], f, p)) >= 1


def _plain(x, f, p):
    upx, upy, downx, downy, px0, px1, py0, py1, flip, gain = p
    return upfirdn2d_plain(x, f, up=(upx, upy), down=(downx, downy),
                           padding=(px0, px1, py0, py1), flip_filter=flip,
                           gain=gain)


def _kernel(x, f, p):
    """One launch into a fresh contiguous NHWC tensor (no autograd
    history). x is contiguous NHWC on a CUDA device."""
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"upfirdn2d: x {x.dtype} {tuple(x.shape)} is not "
                         "contiguous NHWC fp32 / bf16")
    lib, _, _ = build()
    upx, upy, downx, downy, px0, _, py0, _, flip, gain = p
    n, h, w, c = x.shape
    oh, ow = _out_hw(h, w, f, p)
    fw, fh = _get_filter_size(f)
    if f is not None:
        f = f.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_upfirdn2d(
            x.data_ptr(), None if f is None else f.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], n, h, w, c, oh, ow, upx,
            upy, downx, downy, px0, py0, fh, fw, int(flip), gain, stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d: kernel launch failed, CUDA error "
                           f"{err}")
    return out


def _plain_route(x):
    """CPU tensors take the plain version; every other device the kernel."""
    return x.device.type == "cpu"


def _capturing(x):
    return x.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _count(name):
    with _count_lock:       # a mesh queues its cards from several threads
        setattr(upfirdn2d, name, getattr(upfirdn2d, name) + 1)


def _launch(x, f, p, bwd):
    if not in_scope(x, f, p):
        if not _capturing(x):
            _count("launches_plain")
        return _plain(x, f, p)
    if _plain_route(x):
        return _plain(x, f, p)
    out = _kernel(x.contiguous(), f, p)
    if not _capturing(x):
        _count("launches_bwd" if bwd else "launches")
    return out


def _transposed(p, f, in_hw, out_hw):
    """The parameters whose upfirdn2d of dY is the input gradient of the
    call with `p` from `in_hw` to `out_hw`: up and down swapped, the flip
    toggled, the gain kept, the padding transposed."""
    upx, upy, downx, downy, px0, _, py0, _, flip, gain = p
    fw, fh = _get_filter_size(f)
    (ih, iw), (oh, ow) = in_hw, out_hw
    return (downx, downy, upx, upy,
            fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
            fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1,
            not flip, gain)


class _Upfirdn2d(torch.autograd.Function):
    """The kernel (or its plain version on CPU tensors and outside the
    kernel's scope) with its input gradient; `bwd` marks the launches made
    for a gradient. The gradient is the same Function with transposed
    parameters, so the Function is closed under differentiation."""

    @staticmethod
    def forward(ctx, x, f, p, bwd):
        ctx.save_for_backward(f)
        ctx.p, ctx.in_hw = p, tuple(x.shape[1:3])
        return _launch(x, f, p, bwd)

    @staticmethod
    def backward(ctx, dy):
        (f,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            p = _transposed(ctx.p, f, ctx.in_hw, tuple(dy.shape[1:3]))
            dx = _Upfirdn2d.apply(dy, f, p, True)
        return dx, None, None, None


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR-filter, and downsample a batch of NHWC images.

    Args:
        x:           [N, H, W, C] input.
        f:           float32 FIR filter -- [fh, fw] (non-separable), [taps]
                     (separable), or None (identity). Use `setup_filter`.
        up:          int or (upx, upy) upsampling factor.
        down:        int or (downx, downy) downsampling factor.
        padding:     int, (x, y), or (x0, x1, y0, y1), relative to the
                     upsampled image; negative = crop.
        flip_filter: False = convolution, True = correlation.
        gain:        overall magnitude scale.

    Returns:
        [N, out_h, out_w, C], out_h = (H*upy + py0 + py1 - fh) // downy + 1.
        Contiguous NHWC where the kernel computed it.
    """
    assert x.ndim == 4
    if f is not None:
        f = torch.as_tensor(f, dtype=torch.float32)
        assert f.ndim in (1, 2)
    p = (*_parse_scaling(up), *_parse_scaling(down), *_parse_padding(padding),
         bool(flip_filter), float(gain))
    return _Upfirdn2d.apply(x, f, p, False)


upfirdn2d.launches = 0
upfirdn2d.launches_bwd = 0
upfirdn2d.launches_plain = 0


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """FIR-filter NHWC images, output padded to match input shape."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2,
         py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample NHWC images with the given FIR filter."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample NHWC images with the given FIR filter."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
