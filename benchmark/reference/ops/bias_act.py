"""Bias + activation + gain + clamp (elementwise), port of
pasta_tpu/ops/bias_act.py. `dim` defaults to -1 (channels-last).

The activation's slope and the gain are rounded to x's dtype before they
multiply it, as JAX rounds a Python scalar to a bf16 array's dtype:
PyTorch would multiply a bf16 tensor by the unrounded constant and round
once, so sqrt(2) (1.41421 -> 1.41406 in bf16) and 0.2 moved about 4% of a
bf16 layer's values by one step from the JAX package's. In fp32 both
round the constant alike.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


class _ActSpec(NamedTuple):
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2.0)),
    "lrelu": _ActSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2,
                      math.sqrt(2.0)),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0,
                      math.sqrt(2.0)),
}


@functools.lru_cache(maxsize=64)
def _rounded(value, dtype):
    """`value` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def bias_act(x, b=None, dim=-1, act="linear", alpha=None, gain=None,
             clamp=None):
    """Add bias along `dim`, apply activation, scale by gain, clamp.

    Args:
        x:     input of any shape.
        b:     1-D bias of length x.shape[dim], or None.
        dim:   dimension of x that b indexes.
        act:   one of `activation_funcs` keys.
        alpha: activation shape parameter (None = per-act default).
        gain:  output scale (None = per-act default, e.g. sqrt(2) for lrelu).
        clamp: clamp output to +-clamp (None = no clamping).

    Returns:
        Tensor shaped like x, same dtype.
    """
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        assert b.ndim == 1
        axis = dim % x.ndim
        assert b.shape[0] == x.shape[axis], (b.shape, x.shape)
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = spec.func(x, _rounded(alpha, x.dtype))
    if gain != 1:
        x = x * _rounded(gain, x.dtype)
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
