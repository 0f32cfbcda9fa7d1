"""Operations of a forward (or a step), counted from shapes as the
reference runs it, by dtype, with every convolution's shapes recorded.

A TorchDispatchMode sees each aten call: convolutions (forward and
backward) and matrix products are counted as torch.utils.flop_counter
counts them (2 operations a multiply-add), so the count does not depend on
which kernel computes them; tests hold the total equal to FlopCounterMode's,
but for a grouped convolution's weight gradient, which FlopCounterMode
counts over all input channels and this counter over each group's.
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _conv_flops(x_shape, w_shape, out_shape, transposed):
    """2 * (output positions) * C_out * C_in/groups * kernel area."""
    batch_out = out_shape[0] * _prod(out_shape[2:])
    c_out, c_in_g = w_shape[0], w_shape[1]
    if transposed:
        # weight [C_in, C_out/groups, k...]: every input position feeds
        return 2 * x_shape[0] * _prod(x_shape[2:]) * _prod(w_shape)
    return 2 * batch_out * c_out * c_in_g * _prod(w_shape[2:])


class OpCounter(TorchDispatchMode):
    """flops[dtype] of convolutions and matrix products, and `convs`: one
    record a forward convolution (input, weight, output shapes, stride,
    padding, groups, dtype)."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.convs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in (aten.convolution, aten._convolution):
            x, w = args[0], args[1]
            stride, padding, dilation, transposed = args[3:7]
            groups = args[8]
            self.flops[x.dtype] += _conv_flops(x.shape, w.shape, out.shape,
                                               transposed)
            self.convs.append(dict(
                input=list(x.shape), weight=list(w.shape),
                output=list(out.shape), stride=list(stride),
                padding=list(padding), dilation=list(dilation),
                transposed=bool(transposed), groups=int(groups),
                dtype=x.dtype))
        elif packet == aten.convolution_backward:
            dy, x, w = args[0], args[1], args[2]
            transposed, mask = args[7], args[10]
            fwd = _conv_flops(x.shape, w.shape, dy.shape, transposed)
            self.flops[x.dtype] += fwd * (int(mask[0]) + int(mask[1]))
        elif packet == aten.mm:
            a, b = args[0], args[1]
            self.flops[a.dtype] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif packet == aten.addmm:
            a, b = args[1], args[2]
            self.flops[a.dtype] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif packet in (aten.bmm, aten.baddbmm):
            a, b = (args[0], args[1]) if packet == aten.bmm else args[1:3]
            self.flops[a.dtype] += (2 * a.shape[0] * a.shape[1] * a.shape[2]
                                    * b.shape[2])
        return out

    def peak_seconds(self, peaks):
        """Seconds the counted operations take at each dtype's peak."""
        return sum(n / peaks[dt] for dt, n in self.flops.items())
