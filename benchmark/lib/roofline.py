"""Peaks of one NVIDIA H100 SXM (data sheet, dense) and the least time a
3x3 convolution can take on it.

`conv_bound` is chip_smoke.py's arithmetic: 2 * N * H * W * 9 * C_in *
C_out operations at the dtype's peak, against the input, the weights and
the output each moved once at the memory rate.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # off the tensor cores
              torch.bfloat16: 989e12, torch.float16: 989e12}


def conv_bound(n, h, w_out, ci, co, dtype, in_elems, out_elems):
    """(bound seconds, "operations" or "bytes", FLOP) of a 3x3 conv."""
    flop = 2 * n * h * w_out * 9 * ci * co
    size = torch.finfo(dtype).bits // 8
    t_ops = flop / PEAK_FLOPS[dtype]
    t_bytes = (in_elems + 9 * ci * co + out_elems) * size / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flop)


def k1_in_scope(c_in, c_out):
    """The port's rule for which 3x3 convolutions K1 takes (a copy of
    `ops/conv3x3.py::in_scope`)."""
    return c_in in (64, 128) and c_out <= 128


def is_k1_conv(rec):
    """Whether a recorded convolution is one the port sends to K1: 3x3,
    stride 1, no padding (the port pads first), groups 1, in scope."""
    co, ci, kh, kw = rec["weight"]
    return (kh == 3 and kw == 3 and rec["stride"] == [1, 1]
            and rec["padding"] == [0, 0] and rec["groups"] == 1
            and not rec["transposed"] and k1_in_scope(ci, co))


def k1_bound(rec):
    """conv_bound of a recorded K1 convolution (NCHW shapes)."""
    n, ci, hin, win = rec["input"]
    co, _, _, _ = rec["weight"]
    _, _, h, w_out = rec["output"]
    return conv_bound(n, h, w_out, ci, co, rec["dtype"],
                      n * ci * hin * win, n * co * h * w_out)
