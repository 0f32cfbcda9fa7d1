"""Equalized-learning-rate layers (NHWC), port of pasta_tpu/nn/layers.py.

Parameters carry the reference torch state-dict names and layouts: conv
weights OIHW, FullyConnectedLayer weights [out, in], Dense's torch
`linear`. Every parameter records its initializer (the JAX package's
distributions); `init_weights(module, generator)` draws them all from one
explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import bias_act, conv2d_resample, setup_filter
from ..ops.bias_act import activation_funcs
from ..ops.spade_norm import instance_norm_2d
from ..train.dist import all_gather_batch, rank


def _normal(std):
    return lambda t, g: t.normal_(0.0, std, generator=g)


def _const(value):
    return lambda t, g: t.fill_(value)


def _uniform(lim):
    return lambda t, g: t.uniform_(-lim, lim, generator=g)


def add_param(module, name, shape, init):
    """Register parameter `name` on `module` with its initializer."""
    module.register_parameter(name, nn.Parameter(torch.empty(shape)))
    module.__dict__.setdefault("_inits", {})[name] = init


def add_buffer(module, name, shape, init):
    """Register a persistent buffer (state-dict entry) with its init."""
    module.register_buffer(name, torch.empty(shape))
    module.__dict__.setdefault("_inits", {})[name] = init


@torch.no_grad()
def init_weights(root, generator):
    """Draw every registered parameter/buffer of `root` from `generator`
    (a CPU torch.Generator), in module order."""
    for m in root.modules():
        for name, init in m.__dict__.get("_inits", {}).items():
            init(getattr(m, name), generator)


def register_filter(module, taps):
    """FIR filter as a non-persistent buffer (recomputed, never loaded)."""
    module.register_buffer("resample_filter", setup_filter(taps),
                           persistent=False)


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    """Pixel-norm over `dim`."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnectedLayer(nn.Module):
    """Equalized-lr linear with fused bias + activation."""

    def __init__(self, in_features, out_features, use_bias=True,
                 activation="linear", lr_multiplier=1.0, bias_init=0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        add_param(self, "weight", (out_features, in_features),
                  _normal(1.0 / lr_multiplier))
        if use_bias:
            add_param(self, "bias", (out_features,), _const(bias_init))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        w = self.weight.to(x.dtype) * self.weight_gain
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x @ w.T, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-lr conv with optional FIR up/downsampling and fused act."""

    def __init__(self, in_channels, out_channels, kernel_size, use_bias=True,
                 activation="linear", up=1, down=1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.padding = kernel_size // 2
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0))
        if use_bias:
            add_param(self, "bias", (out_channels,), _const(0.0))
        else:
            self.register_parameter("bias", None)
        register_filter(self, resample_filter)

    def forward(self, x, gain=1.0):
        w = (self.weight * self.weight_gain).to(x.dtype).permute(2, 3, 1, 0)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = (self.conv_clamp * gain if self.conv_clamp is not None
                     else None)
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class Dense(nn.Module):
    """Linear over channels + InstanceNorm + LeakyReLU(0.01).

    The linear runs in the promoted dtype of input and fp32 weights (fp32
    for a bf16 input), as flax's nn.Dense does in the JAX package."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        lim = 1.0 / math.sqrt(in_channels)
        self.linear.__dict__["_inits"] = {"weight": _uniform(lim),
                                          "bias": _uniform(lim)}

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.linear.weight.dtype)
        x = F.linear(x.to(dt), self.linear.weight.to(dt),
                     self.linear.bias.to(dt))
        return F.leaky_relu(instance_norm_2d(x), 0.01)


class ResBlock(nn.Module):
    """conv-conv + 1x1 skip, each path scaled by sqrt(1/2). The two convs
    are 3x3 whatever `kernel_size` says, as in the JAX package."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 activation="linear", up=1, down=1,
                 resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        del kernel_size
        common = dict(resample_filter=resample_filter, conv_clamp=conv_clamp)
        self.skip = Conv2dLayer(in_channels, out_channels, 1, use_bias=False,
                                up=up, down=down, **common)
        self.conv0 = Conv2dLayer(in_channels, out_channels, 3,
                                 activation=activation, up=up, down=down,
                                 **common)
        self.conv1 = Conv2dLayer(out_channels, out_channels, 3,
                                 activation=activation, **common)

    def forward(self, x):
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


class MinibatchStdLayer(nn.Module):
    """Append cross-minibatch stddev features (reference networks.py:
    527-549). Groups are batch-strided over the GLOBAL batch: sample j of
    N is in group j % (N/G). Under data parallelism the layer gathers every
    rank's rows (rank r's at [r * n, (r + 1) * n), `train/dist.py`), groups
    them as the JAX step groups its global batch under `jit` -- a group
    spans ranks -- and keeps this rank's rows; the gather is
    differentiable, R1's double backward included."""

    def __init__(self, group_size=4, num_channels=1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x):
        xs = all_gather_batch(x)
        n, h, w, c = xs.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        f = self.num_channels
        y = xs.reshape(g, n // g, h, w, f, c // f)
        y = y - y.mean(dim=0, keepdim=True)
        y = y.square().mean(dim=0)
        y = torch.sqrt(y + 1e-8)
        y = y.mean(dim=(1, 2, 4))                     # [n//g, F]
        y = y[:, None, None, :].repeat(g, h, w, 1)    # [N, H, W, F]
        if n != x.shape[0]:                           # this rank's rows
            r = rank()
            y = y[r * x.shape[0]:(r + 1) * x.shape[0]]
        return torch.cat([x, y.to(x.dtype)], dim=-1)
