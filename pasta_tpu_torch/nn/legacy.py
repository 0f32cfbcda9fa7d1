"""Capability-parity layers outside the live fullbody path, port of
pasta_tpu/nn/legacy.py (NHWC).

The reference ships a layer zoo that the shipped pipeline never calls
(SURVEY.md §2.2) but that is part of its capability surface: PASTA-GAN-v1
leftovers, partial convolutions (whose `Conv2dLayer_partialconv`
dependency is undefined in the reference -- reconstructed working, as in
the JAX package), self-attention, coord convs, the mask-predicting ToRGB
variants and the util_classes.py zoo. References: the reference's
training/networks.py and util_classes.py, as cited per class.

Weights carry the JAX package's names. Every conv weight is OIHW (the
JAX package's kernels are HWIO; flax's `nn.Conv` / `nn.ConvTranspose`
kernels and `nn.BatchNorm` scale / statistics cross by
`io/from_jax.py::legacy_jax_to_state_dict`). Modules that flax sizes from
their input take `in_channels` here. The public modules draw their
parameters at construction from a CPU torch.Generator seeded with `seed`
(the JAX package's initializers, flax's lecun-normal kernels as a normal
of the same scale); `seed=None` leaves the drawing to a parent. The random
helpers (`random_affine_matrix`, `apply_random_crop`) take an explicit
torch.Generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import bias_act, conv2d_resample, modulated_conv2d
from ..ops.bias_act import activation_funcs
from .layers import (Conv2dLayer, FullyConnectedLayer, _const, _normal,
                     add_buffer, add_param, init_weights, register_filter)


def _drawn(module, seed):
    """Draw `module`'s parameters from a generator seeded with `seed`."""
    if seed is not None:
        init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _leaky(x):
    return F.leaky_relu(x, 0.01)     # flax nn.leaky_relu's slope


class FeatureEncoder(nn.Module):
    """7-stage stride-2 encoder (networks.py:265-283; v1 leftover)."""

    def __init__(self, input_nc, ngf=64, seed=0):
        super().__init__()
        mult_ins = [1, 2, 4, 4, 8, 8, 8]
        mult_outs = [2, 4, 4, 8, 8, 8, 8]
        self.model = nn.ModuleList(
            [Conv2dLayer(input_nc, ngf, kernel_size=1)]
            + [Conv2dLayer(ngf * mi, ngf * mo, kernel_size=3, down=2)
               for mi, mo in zip(mult_ins, mult_outs)])
        _drawn(self, seed)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return x


def mask_resampled_zero(coverage, eps=1e-6):
    return coverage.abs() < eps


class PartialConv2dLayer(nn.Module):
    """Mask-normalized conv: output scaled by the valid-coverage fraction
    (the working reconstruction of the reference's undefined
    `Conv2dLayer_partialconv`, networks.py:318-353, after the
    Spade_Conv2dLayer_partialconv normalization, networks.py:1692-1696):
    x_out / conv(mask), zero-coverage positions divided by 1."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 activation="linear", up=1, down=1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, seed=0):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.kernel_size = kernel_size
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0))
        add_param(self, "bias", (out_channels,), _const(0.0))
        register_filter(self, resample_filter)
        _drawn(self, seed)

    def forward(self, x, mask, gain=1.0):
        k = self.kernel_size
        w = (self.weight * self.weight_gain).to(x.dtype).permute(2, 3, 1, 0)
        flip = self.up == 1
        common = dict(f=self.resample_filter, up=self.up, down=self.down,
                      padding=k // 2, flip_weight=flip)
        x = conv2d_resample(x, w, **common)
        mask_w = torch.ones((k, k, 1, 1), dtype=x.dtype, device=x.device)
        coverage = conv2d_resample(mask, mask_w, **common)
        coverage = torch.where(mask_resampled_zero(coverage),
                               torch.ones_like(coverage), coverage)
        x = x / coverage
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = (self.conv_clamp * gain if self.conv_clamp is not None
                     else None)
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class PartialResBlock(nn.Module):
    """ResBlock over partial convs (reference ResBlock_partialconv,
    networks.py:318-353)."""

    def __init__(self, in_channels, out_channels, activation="linear",
                 down=1, seed=0):
        super().__init__()
        self.down = down
        self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1,
                                use_bias=False, down=down)
        self.conv0 = PartialConv2dLayer(in_channels, out_channels, 3,
                                        activation=activation, down=down,
                                        seed=None)
        self.conv1 = PartialConv2dLayer(out_channels, out_channels, 3,
                                        activation=activation, seed=None)
        _drawn(self, seed)

    def forward(self, x, mask):
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x, mask)
        if self.down == 2:
            mask = (mask[:, ::2, ::2, :] == 1).to(x.dtype)
        x = self.conv1(x, mask, gain=math.sqrt(0.5))
        return y + x


def space_to_depth(x, block_size):
    """networks.py:380-388 (unfold-based), as a rearrange."""
    n, h, w, c = x.shape
    bs = block_size
    x = x.reshape(n, h // bs, bs, w // bs, bs, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // bs, w // bs, bs * bs * c)


class ZooConv(nn.Module):
    """flax's nn.Conv on NHWC (the zoo's plain conv): OIHW weight, "SAME"
    padding for odd kernels unless `padding` is given, optional bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=None, use_bias=True, seed=0):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        fan_in = in_channels * kernel_size ** 2
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0 / math.sqrt(fan_in)))
        if use_bias:
            add_param(self, "bias", (out_channels,), _const(0.0))
        else:
            self.register_parameter("bias", None)
        _drawn(self, seed)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     None if self.bias is None else self.bias.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def _conv_transpose_padding(k, s):
    """lax.conv_transpose's (before, after) padding of "SAME"."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class ZooConvTranspose(nn.Module):
    """flax's nn.ConvTranspose (padding "SAME", kernel not transposed) on
    NHWC: the input dilated by the stride, padded as lax.conv_transpose
    pads it, and cross-correlated with the OIHW weight; out = in * stride.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=2,
                 seed=0):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        fan_in = in_channels * kernel_size ** 2
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0 / math.sqrt(fan_in)))
        add_param(self, "bias", (out_channels,), _const(0.0))
        _drawn(self, seed)

    def forward(self, x):
        n, h, w, c = x.shape
        s = self.stride
        xc = x.permute(0, 3, 1, 2)
        dil = xc.new_zeros((n, c, (h - 1) * s + 1, (w - 1) * s + 1))
        dil[:, :, ::s, ::s] = xc
        a, b = _conv_transpose_padding(self.kernel_size, s)
        dil = F.pad(dil, (a, b, a, b))
        y = F.conv2d(dil, self.weight.to(x.dtype), self.bias.to(x.dtype))
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax's nn.BatchNorm on NHWC (momentum 0.99, epsilon 1e-5): with
    `train`, the batch's mean and biased variance (E[x^2] - E[x]^2), and
    the running statistics move toward them; otherwise the running ones."""

    def __init__(self, channels, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        add_param(self, "weight", (channels,), _const(1.0))
        add_param(self, "bias", (channels,), _const(0.0))
        add_buffer(self, "running_mean", (channels,), _const(0.0))
        add_buffer(self, "running_var", (channels,), _const(1.0))

    def forward(self, x, train=False):
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = (x.square().mean(dim=(0, 1, 2))
                   - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class SelfAttention(nn.Module):
    """SAGAN-style self-attention (reference Attention, networks.py:
    410-440), as batched matrix products."""

    def __init__(self, channels, seed=0):
        super().__init__()
        ch8, ch2 = max(channels // 8, 1), max(channels // 2, 1)
        self.theta = ZooConv(channels, ch8, 1, use_bias=False, seed=None)
        self.phi = ZooConv(channels, ch8, 1, use_bias=False, seed=None)
        self.g = ZooConv(channels, ch2, 1, use_bias=False, seed=None)
        self.o = ZooConv(ch2, channels, 1, use_bias=False, seed=None)
        add_param(self, "gamma", (), _const(0.0))
        _drawn(self, seed)

    @staticmethod
    def _pool(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

    def forward(self, x):
        n, h, w, _ = x.shape
        theta = self.theta(x).reshape(n, h * w, -1)
        phi = self._pool(self.phi(x)).reshape(n, -1, theta.shape[-1])
        g = self._pool(self.g(x))
        g = g.reshape(n, -1, g.shape[-1])
        beta = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
        o = (beta @ g).reshape(n, h, w, -1)
        return self.gamma * self.o(o) + x


class SpadeModulatedConv2d(nn.Module):
    """Spatially-modulated conv (reference spade_modulated_conv2d,
    networks.py:1519-1583; defined there but never called): per-pixel style
    maps modulate the input, demodulation from the mean style."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 demodulate=True, seed=0):
        super().__init__()
        self.kernel_size, self.demodulate = kernel_size, demodulate
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0))
        _drawn(self, seed)

    def forward(self, x, style_map):
        """style_map: [N, H, W, in_channels] spatial modulation."""
        w = self.weight.permute(2, 3, 1, 0)                    # HWIO
        x = x * style_map
        dcoefs = None
        if self.demodulate:
            s_mean = style_map.mean(dim=(1, 2))                  # [N, I]
            w_sq = w.square().sum(dim=(0, 1))                    # [I, O]
            dcoefs = torch.rsqrt(s_mean.square() @ w_sq + 1e-8)
        x = conv2d_resample(x, w.to(x.dtype), padding=self.kernel_size // 2)
        if dcoefs is not None:
            x = x * dcoefs[:, None, None, :].to(x.dtype)
        return x


class MaskPredictingToRGB(nn.Module):
    """v1 torgb that also emits sigmoid upper / lower masks at the last
    block (reference ToRGBLayerV18 / ToRGBLayerV18_512, networks.py:
    1777-1855); `deep_heads=True` gives the _512 two-stage mask heads."""

    def __init__(self, in_channels, out_channels, w_dim,
                 conv_clamp: Optional[float] = None, is_last=False,
                 deep_heads=False, seed=0):
        super().__init__()
        self.conv_clamp, self.is_last = conv_clamp, is_last
        self.deep_heads = deep_heads
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight_gain = 1.0 / math.sqrt(in_channels)
        if is_last:
            for name in ("m1", "m2"):
                if deep_heads:
                    add_param(self, f"{name}_w",
                              (in_channels, in_channels, 1, 1), _normal(1.0))
                    add_param(self, f"{name}_b", (in_channels,), _const(0.0))
                add_param(self, f"{name}_w1", (1, in_channels, 1, 1),
                          _normal(1.0))
                add_param(self, f"{name}_b1", (1,), _const(0.0))
        add_param(self, "weight", (out_channels, in_channels, 1, 1),
                  _normal(1.0))
        add_param(self, "bias", (out_channels,), _const(0.0))
        _drawn(self, seed)

    @staticmethod
    def _hwio(w):
        return w.permute(2, 3, 1, 0)

    def _head(self, name, x, styles):
        h = x
        if self.deep_heads:
            h = modulated_conv2d(x, self._hwio(getattr(self, f"{name}_w")),
                                 styles)
            h = bias_act(h, getattr(self, f"{name}_b"), clamp=self.conv_clamp)
        out = modulated_conv2d(h, self._hwio(getattr(self, f"{name}_w1")),
                               styles, demodulate=False)
        return bias_act(out, getattr(self, f"{name}_b1"), act="sigmoid",
                        clamp=self.conv_clamp)

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        upper_mask = lower_mask = None
        if self.is_last:
            upper_mask = self._head("m1", x, styles)
            lower_mask = self._head("m2", x, styles)
        img = modulated_conv2d(x, self._hwio(self.weight), styles,
                               demodulate=False)
        img = bias_act(img, self.bias, clamp=self.conv_clamp)
        return img, upper_mask, lower_mask


class AddCoords(nn.Module):
    """Append normalized xy (+r) channels (util_classes.py AddCoords)."""

    def __init__(self, with_r=False):
        super().__init__()
        self.with_r = with_r

    def forward(self, x):
        n, h, w, _ = x.shape
        ys = torch.linspace(-1, 1, h, device=x.device, dtype=x.dtype)
        xs = torch.linspace(-1, 1, w, device=x.device, dtype=x.dtype)
        yy = ys[None, :, None, None].expand(n, h, w, 1)
        xx = xs[None, None, :, None].expand(n, h, w, 1)
        feats = [x, xx, yy]
        if self.with_r:
            feats.append(torch.sqrt(xx ** 2 + yy ** 2))
        return torch.cat(feats, dim=-1)


class CoordConv(nn.Module):
    """Conv over coord-augmented input (util_classes.py CoordConv)."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 with_r=False, seed=0):
        super().__init__()
        self.coords = AddCoords(with_r=with_r)
        self.conv = ZooConv(in_channels + (3 if with_r else 2), out_channels,
                            kernel_size, seed=None)
        _drawn(self, seed)

    def forward(self, x):
        return self.conv(self.coords(x))


def spectral_normalize(w, u, n_iters=1, eps=1e-12):
    """One power-iteration step of spectral normalization
    (util_classes.py spectral_norm wrapper semantics).

    Returns (w / sigma, new_u). `w` is [out, in_flat]; `u` is [out]."""
    for _ in range(n_iters):
        v = w.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ w @ v
    return w / sigma, u.detach()


def _uniform(generator, shape, low=0.0, high=1.0):
    """Uniform draws in [low, high) from `generator`, on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def random_affine_matrix(generator, n, angle_range=10.0, scale_range=0.05,
                         shift_range=0.05):
    """Batched random 2D affines (util_functions.py:162-253 semantics):
    rotation (degrees), isotropic scale, translation -- as [N, 3, 3], on
    the generator's device."""
    ang = _uniform(generator, (n,), -angle_range, angle_range) * math.pi / 180
    sc = 1 + _uniform(generator, (n,), -scale_range, scale_range)
    tx = _uniform(generator, (n,), -shift_range, shift_range)
    ty = _uniform(generator, (n,), -shift_range, shift_range)
    c, s = torch.cos(ang) * sc, torch.sin(ang) * sc
    m = torch.eye(3, device=ang.device).repeat(n, 1, 1)
    m[:, 0, 0], m[:, 0, 1], m[:, 0, 2] = c, -s, tx
    m[:, 1, 0], m[:, 1, 1], m[:, 1, 2] = s, c, ty
    return m


def apply_random_crop(x, generator, target_size, scale_range=(0.25, 0.5),
                      num_crops=1):
    """Random resized crops by bilinear sampling (util_functions.py:272-317
    apply_random_crop; the port's device_warp.warp_perspective in place of
    torch's grid_sample). `generator` lies on x's device.

    Returns [N, num_crops, target, target, C]."""
    from ..data.device_warp import warp_perspective

    n, h, w, _ = x.shape
    scales = _uniform(generator, (n, num_crops), *scale_range)
    max_off = 1.0 - scales
    ox = _uniform(generator, (n, num_crops)) * max_off * w
    oy = _uniform(generator, (n, num_crops)) * max_off * h
    outs = []
    for j in range(num_crops):
        m = torch.eye(3, device=x.device).repeat(n, 1, 1)
        m[:, 0, 0] = scales[:, j] * w / target_size
        m[:, 0, 2] = ox[:, j]
        m[:, 1, 1] = scales[:, j] * h / target_size
        m[:, 1, 2] = oy[:, j]
        outs.append(warp_perspective(x, m, target_size, target_size))
    return torch.stack(outs, dim=1)


def channel_normalize(x, power=2, eps=1e-7):
    """Lp-normalize over the channel axis (util_classes.py:6-14 Normalize;
    NHWC: channels last instead of torch's dim 1)."""
    norm = (x.abs() ** power).sum(dim=-1, keepdim=True) ** (1.0 / power)
    return x / (norm + eps)


def apply_offset(offset):
    """Offset grid -> normalized sampling-location grid
    (util_classes.py:17-32). NHWC: offset [N, H, W, 2] with channels
    (dx, dy); returns [N, H, W, 2] with (x, y) in [-1, 1]."""
    n, h, w, _ = offset.shape
    gx = torch.arange(w, dtype=offset.dtype,
                      device=offset.device)[None, None, :].expand(n, h, w)
    gy = torch.arange(h, dtype=offset.dtype,
                      device=offset.device)[None, :, None].expand(n, h, w)
    x = (gx + offset[..., 0]) / ((w - 1.0) / 2.0) - 1.0
    y = (gy + offset[..., 1]) / ((h - 1.0) / 2.0) - 1.0
    return torch.stack([x, y], dim=-1)


def _zoo_conv(in_channels, out_channels, kernel_size, use_coord=False):
    """coord_conv helper (util_classes.py:96-101): plain conv or CoordConv.
    Spectral norm is a training-time reparameterization in torch; the zoo
    ships with use_spect=False everywhere, so it is not replicated here."""
    if use_coord:
        return CoordConv(in_channels, out_channels, kernel_size=kernel_size,
                         seed=None)
    return ZooConv(in_channels, out_channels, kernel_size, seed=None)


class EncoderBlock(nn.Module):
    """norm-act-conv x2 downsampling block (util_classes.py:103-126)."""

    def __init__(self, in_channels, out_channels, downsample=True,
                 use_coord=False, use_norm=True, seed=0):
        super().__init__()
        self.use_norm = use_norm
        if use_norm:
            self.norm1 = BatchNorm(in_channels)
            self.norm2 = BatchNorm(out_channels)
        if downsample:
            self.conv1 = ZooConv(in_channels, out_channels, 4, stride=2,
                                 padding=1, seed=None)
        else:
            self.conv1 = _zoo_conv(in_channels, out_channels, 3, use_coord)
        self.conv2 = _zoo_conv(out_channels, out_channels, 3, use_coord)
        _drawn(self, seed)

    def forward(self, x, train=False):
        if self.use_norm:
            x = self.norm1(x, train)
        x = self.conv1(_leaky(x))
        if self.use_norm:
            x = self.norm2(x, train)
        return self.conv2(_leaky(x))


class ResBlockDecoder(nn.Module):
    """Residual decoder block, optionally 2x-upsampling by transposed conv
    (util_classes.py:128-157). Without upsampling the shortcut is the
    input itself, so out_channels must equal in_channels."""

    def __init__(self, in_channels, out_channels, hidden_channels=None,
                 upsample=True, use_norm=True, seed=0):
        super().__init__()
        hidden = hidden_channels or in_channels
        self.use_norm, self.upsample = use_norm, upsample
        if use_norm:
            self.norm1 = BatchNorm(in_channels)
            self.norm2 = BatchNorm(hidden)
        self.conv1 = ZooConv(in_channels, hidden, 3, seed=None)
        if upsample:
            self.conv2 = ZooConvTranspose(hidden, out_channels, 3, seed=None)
            self.bypass = ZooConvTranspose(in_channels, out_channels, 3,
                                           seed=None)
        else:
            self.conv2 = ZooConv(hidden, out_channels, 3, seed=None)
        _drawn(self, seed)

    def forward(self, x, train=False):
        h = self.norm1(x, train) if self.use_norm else x
        h = self.conv1(_leaky(h))
        if self.use_norm:
            h = self.norm2(h, train)
        h = self.conv2(_leaky(h))
        return h + (self.bypass(x) if self.upsample else x)


class Jump(nn.Module):
    """Output head: norm-act-reflectpad-conv (util_classes.py:160-178)."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 use_coord=False, use_norm=True, seed=0):
        super().__init__()
        self.use_norm, self.kernel_size = use_norm, kernel_size
        if use_norm:
            self.norm = BatchNorm(in_channels)
        self.coords = AddCoords() if use_coord else None
        # VALID padding: the reflect pad supplies the borders
        self.conv = ZooConv(in_channels + (2 if use_coord else 0),
                            out_channels, kernel_size, padding=0, seed=None)
        _drawn(self, seed)

    def forward(self, x, train=False):
        if self.use_norm:
            x = self.norm(x, train)
        x = _leaky(x)
        p = self.kernel_size // 2
        x = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
        x = x.permute(0, 2, 3, 1)
        if self.coords is not None:
            x = self.coords(x)
        return self.conv(x)
