"""2-D convolution with optional FIR up/downsampling, NHWC / HWIO.

Port of pasta_tpu/ops/conv2d_resample.py: the padding algebra and every
branch are the JAX package's. `_conv2d` sends the 3x3 stride-1 convs in
K1's scope (C_in in {64, 128}, C_out <= 128, groups 1) to
`ops/conv3x3.conv3x3_valid`, zero-padding first for a padded conv as the
Pallas `conv3x3_same` does: the hand-written kernel on CUDA tensors, its
plain version on CPU tensors. Every other conv is `F.conv2d`, as the JAX
package leaves them to XLA.

The JAX package's lane-pad lever is a TPU layout workaround and is not
ported.
"""

from __future__ import annotations

import torch.nn.functional as F

from .conv3x3 import conv3x3_valid, in_scope
from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d


def _conv2d(x, w, stride=1, padding=0, groups=1, flip_weight=True):
    """Plain NHWC conv. `w` is [kh, kw, in_per_group, out] (HWIO).

    flip_weight=True performs correlation (torch F.conv2d semantics);
    False flips the kernel spatially first (true convolution). `padding`
    is an int or [py, px]."""
    if not flip_weight:
        w = w.flip([0, 1])
    py, px = (padding, padding) if isinstance(padding, int) else padding
    w = w.to(x.dtype)
    if (w.shape[0] == 3 and w.shape[1] == 3 and stride == 1 and groups == 1
            and in_scope(w.shape[2], w.shape[3])):
        if px or py:
            x = F.pad(x, (0, 0, px, px, py, py))
        return conv3x3_valid(x.contiguous(), w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=(py, px), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """Conv with optional up/downsampling; padding applied once, up-front.

    Args:
        x:           [N, H, W, C] input.
        w:           [kh, kw, in_channels // groups, out_channels] weights.
        f:           FIR filter from `setup_filter`, or None.
        up:          integer upsampling factor.
        down:        integer downsampling factor.
        padding:     int, (x, y), or (x0, x1, y0, y1) w.r.t. the upsampled image.
        groups:      feature group count.
        flip_weight: True = correlation (torch conv2d), False = convolution.
        flip_filter: same for the FIR filter.

    Returns:
        [N, out_h, out_w, out_channels].
    """
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    kh, kw = int(w.shape[0]), int(w.shape[1])
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: downsample first, then cheap conv.
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: conv first, then upsample.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                         gain=up ** 2, flip_filter=flip_filter)

    # Downsampling only: FIR pass, then strided conv.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups,
                       flip_weight=flip_weight)

    # Upsampling (with optional downsampling): zero-upsample + FIR pass,
    # then conv.
    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                      gain=up ** 2, flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain conv with symmetric non-negative padding.
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return _conv2d(x, w, padding=[py0, px0], groups=groups,
                       flip_weight=flip_weight)

    # Asymmetric / negative padding: explicit pad/crop pass then conv (the
    # FIR filter is not applied here, as in the reference fallback).
    x = upfirdn2d(x, None, padding=[px0, px1, py0, py1])
    return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
