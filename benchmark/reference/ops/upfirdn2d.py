"""Pad -> zero-upsample -> FIR filter -> downsample, NHWC.

Port of pasta_tpu/ops/upfirdn2d.py. The JAX version is one
`lax.conv_general_dilated` per (separable) pass with lhs_dilation for the
zero-upsampling and negative conv padding for crops; here the same
function is spelled the way the reference's `_upfirdn2d_ref` spells it:
zero-insertion by reshape + pad, an explicit pad/crop, then a depthwise
`F.conv2d` whose stride does the downsampling. Both insert `up - 1` zeros
after every input sample, so the padding/crop semantics (`_parse_padding`)
are identical.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


class _FirConv(torch.autograd.Function):
    """Depthwise FIR correlation (NCHW, groups = channels, stride) whose
    gradient is the transposed correlation, and whose transposed twin's
    gradient is it again: a pair like the shift kernels', so a double
    backward (R1 through the discriminator's resampling) never
    differentiates a grouped conv, which PyTorch does with one conv per
    group. The filter is a constant."""

    @staticmethod
    def forward(ctx, x, f, stride):
        ctx.save_for_backward(f)
        ctx.stride, ctx.in_hw = stride, tuple(x.shape[2:])
        return F.conv2d(x, f, stride=stride, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (f,) = ctx.saved_tensors
        return _FirConvT.apply(g, f, ctx.stride, ctx.in_hw), None, None


class _FirConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, f, stride, in_hw):
        ctx.save_for_backward(f)
        ctx.stride = stride
        kh, kw = f.shape[2:]
        pad = (in_hw[0] - ((g.shape[2] - 1) * stride[0] + kh),
               in_hw[1] - ((g.shape[3] - 1) * stride[1] + kw))
        return F.conv_transpose2d(g, f, stride=stride, groups=g.shape[1],
                                  output_padding=pad)

    @staticmethod
    def backward(ctx, gg):
        (f,) = ctx.saved_tensors
        return _FirConv.apply(gg, f, ctx.stride), None, None, None


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
    """
    assert x.ndim == 4
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
        x = _FirConv.apply(x, f[None, None].repeat(c, 1, 1, 1),
                           (downy, downx))
    else:
        x = _FirConv.apply(x, f[None, None, None].repeat(c, 1, 1, 1),
                           (1, downx))
        x = _FirConv.apply(x, f[None, None, :, None].repeat(c, 1, 1, 1),
                           (downy, 1))
    return x.permute(0, 2, 3, 1)


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
