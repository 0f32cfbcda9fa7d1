"""The convolutions the port hands K1 in a training step, made on the
reference for counting (`mfu.train`, `k1_roofline.train`): a model of the
port's `ops/conv3x3.py` Function with `F.conv2d` in every place the port
launches K1. Only the counting pass runs it; the check differentiates the
reference's plain `F.conv2d` by autograd.

As in the port, `conv3x3_valid` is one torch.autograd.Function: its input
gradient is again a 3x3 conv -- of dY with a halo of 2, the weights
rotated 180 degrees with C_in and C_out swapped -- made by the same
Function, so R1's double backward differentiates it again; dW is
`torch.nn.grad.conv2d_weight`. Every convolution the port runs on K1,
forward or input gradient, is so one forward `F.conv2d` here, of the
shape K1 is given, which `lib/flops.py::OpCounter` records.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
import torch.nn.functional as F

from ..reference.ops.conv3x3 import in_scope


def _window(x, out_w, pad):
    """x as the `pad`-ed conv reads it: `pad` zeros above, below and to the
    left, columns cut or zero-filled on the right to out_w + 2 in all."""
    need = out_w + 2 - pad
    xs = x[:, :, :need] if need < x.shape[2] else x
    right = need - xs.shape[2]
    return F.pad(xs, (0, 0, pad, right, pad, pad)) if pad or right else xs


def _plain(x, w, out_w, pad=0):
    """One K1 launch: the VALID conv of x with `pad` zeros around it (as
    many as out_w asks for to the right), NHWC, HWIO weights."""
    xs = _window(x, out_w, pad).permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def _input_grad(dy, w, wp, pad=0):
    """dX [.., wp, C_in] of the conv with `pad`: the conv of dY with pad
    2 - `pad` and the weights rotated 180 degrees, C_in/C_out swapped."""
    wr = w.flip(0, 1).transpose(2, 3)
    kernel_takes = in_scope(wr.shape[2], wr.shape[3])
    if dy.dtype == torch.bfloat16:
        # the port's bf16 kernel takes its halo from the bounds of dY
        if kernel_takes:
            return _Conv3x3.apply(dy.contiguous(), wr, wp, 2 - pad)
        return _plain(dy, wr, wp, 2 - pad)
    # the port's fp32 kernel takes dY copied into a padded tensor, and the
    # columns that no dY reaches are padded on afterwards
    p = 2 - pad
    dyp = F.pad(dy, (0, 0, p, p, p, p)) if p else dy
    width = min(wp, dyp.shape[2] - 2)
    if width < 1:                       # no column of dX is reached by dY
        return dy.new_zeros((dy.shape[0], dyp.shape[1] - 2, wp, w.shape[2]))
    if kernel_takes:
        dx = _Conv3x3.apply(dyp, wr.contiguous(), width, 0)
    else:          # C_out outside {64, 128}: K1 cannot take the dX shape
        dx = _plain(dyp, wr, width)
    return F.pad(dx, (0, 0, 0, wp - width)) if wp > width else dx


def _weight_grad(x, dy, w_shape, pad=0):
    """dW (HWIO); only the columns up to out_w + 2 contribute."""
    if pad and dy.shape[2] == x.shape[2] + 2 * pad - 2:
        xs, padding = x, pad
    else:
        xs, padding = _window(x, dy.shape[2], pad), 0
    kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv2d_weight(xs.permute(0, 3, 1, 2), (co, ci, kh, kw),
                                     dy.permute(0, 3, 1, 2), padding=padding)
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """The conv with the port's gradients. The conv with pad 0 has an
    input gradient with pad 2 and the reverse, so the Function is closed
    under differentiation."""

    @staticmethod
    def forward(ctx, x, w, out_w, pad):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        return _plain(x, w, out_w, pad)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(dy, w, x.shape[2], ctx.pad)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, dy, w.shape, ctx.pad)
        return dx, dw, None, None


def conv3x3_valid(x, w, out_w=None):
    """The reference's `conv3x3_valid`, made as the port launches K1."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    return _Conv3x3.apply(x, w.to(x.dtype), out_w, 0)


@contextlib.contextmanager
def routed():
    """Inside, the reference's convolutions in K1's scope (those
    `ops/conv2d_resample._conv2d` sends to `conv3x3_valid`) run as the
    port launches K1."""
    conv2d_resample = importlib.import_module(
        "..reference.ops.conv2d_resample", __package__)
    plain = conv2d_resample.conv3x3_valid
    conv2d_resample.conv3x3_valid = conv3x3_valid
    try:
        yield
    finally:
        conv2d_resample.conv3x3_valid = plain
