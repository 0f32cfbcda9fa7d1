"""K1's plain version alone: the VALID 3x3 convolution as `F.conv2d`, NHWC
in and out, HWIO weights; the channel rule that says which convolutions
the port sends to K1 (the benchmark's roofline reads it)."""

from __future__ import annotations

import torch.nn.functional as F


def in_scope(c_in, c_out):
    """Channel scope of K1."""
    return c_in in (64, 128) and c_out <= 128


def conv3x3_valid(x, w, out_w=None):
    """[N, H+2, W', C_in] x [3, 3, C_in, C_out] -> [N, H, out_w, C_out]."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    xs = x[:, :, :out_w + 2].permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


conv3x3_valid_plain = conv3x3_valid
