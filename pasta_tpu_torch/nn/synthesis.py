"""StyleGAN2 synthesis layers and PASTA-GAN++ SPADE blocks (NHWC), port of
pasta_tpu/nn/synthesis.py. The JAX package's lane-pad branches are TPU
layout workarounds and are not ported; the merge conv takes the concat
form."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import bias_act, conv2d_resample, modulated_conv2d, upsample2d
from ..ops.bias_act import activation_funcs
from ..ops.spade_norm import spade_norm, spade_norm_act, spade_norm_stats
from .layers import (Conv2dLayer, FullyConnectedLayer, ResBlock, _const,
                     _normal, add_buffer, add_param, register_filter)


def _hwio(w):
    return w.permute(2, 3, 1, 0)


class NoiseRows:
    """The noise of rows [start, start + n) of a batch of `batch` rows, for
    a forward that runs those rows alone: each draw is made at the whole
    batch's size from `generator` and cut to the rows, so that the shards
    of a batch split over devices (serving's mesh) get the rows of the
    noise that one forward of the whole batch draws from a generator in the
    same state. A forward's `generator` is a torch.Generator, None or
    one of these."""

    def __init__(self, generator, start, batch):
        self.generator, self.start, self.batch = generator, start, batch

    def randn(self, shape, device):
        full = torch.randn((self.batch,) + tuple(shape[1:]),
                           generator=self.generator, device=device)
        return full[self.start:self.start + shape[0]]


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + fused lrelu; optional 2x upsample."""

    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 kernel_size=3, up=1, use_noise=True, activation="lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.resolution, self.up = resolution, up
        self.padding = kernel_size // 2
        self.use_noise, self.activation = use_noise, activation
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        add_param(self, "weight",
                  (out_channels, in_channels, kernel_size, kernel_size),
                  _normal(1.0))
        add_param(self, "bias", (out_channels,), _const(0.0))
        if use_noise:
            add_param(self, "noise_strength", (), _const(0.0))
            add_buffer(self, "noise_const", (resolution, resolution),
                       _normal(1.0))
        register_filter(self, resample_filter)

    def forward(self, x, w, noise_mode="random", gain=1.0, generator=None):
        assert noise_mode in ("random", "const", "none")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            shape = (x.shape[0], self.resolution, self.resolution, 1)
            if isinstance(generator, NoiseRows):
                noise = generator.randn(shape, x.device)
            else:
                noise = torch.randn(shape, generator=generator,
                                    device=x.device)
            noise = noise * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, :, :, None]
        x = modulated_conv2d(x, _hwio(self.weight), styles, noise=noise,
                             up=self.up, padding=self.padding,
                             resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = (self.conv_clamp * gain if self.conv_clamp is not None
                     else None)
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv to image channels, optional 7-class parsing head
    (fused with the image head into one conv on the same styles)."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1,
                 conv_clamp=None, parsing_channels=None):
        super().__init__()
        self.out_channels = out_channels
        self.conv_clamp = conv_clamp
        self.parsing_channels = parsing_channels
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        k = kernel_size
        add_param(self, "weight", (out_channels, in_channels, k, k),
                  _normal(1.0))
        add_param(self, "bias", (out_channels,), _const(0.0))
        if parsing_channels is not None:
            add_param(self, "m_weight1", (parsing_channels, in_channels, k, k),
                      _normal(1.0))
            add_param(self, "m_bias1", (parsing_channels,), _const(0.0))

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        if self.parsing_channels is None:
            x = modulated_conv2d(x, _hwio(self.weight), styles,
                                 demodulate=False)
            return bias_act(x, self.bias, clamp=self.conv_clamp), None
        w_cat = torch.cat([self.weight, self.m_weight1], dim=0)
        b_cat = torch.cat([self.bias, self.m_bias1], dim=0)
        y = modulated_conv2d(x, _hwio(w_cat), styles, demodulate=False)
        y = bias_act(y, b_cat, clamp=self.conv_clamp)
        return y[..., :self.out_channels], y[..., self.out_channels:]


class SpadeConv2dLayer(nn.Module):
    """Conv2dLayer variant with pre-activation (act before conv), optional."""

    def __init__(self, in_channels, out_channels, kernel_size, use_bias=True,
                 activation="relu", up=1, down=1,
                 resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        self.activation, self.up, self.down = activation, up, down
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

    def act_args(self, gain=1.0):
        """(gain, clamp) of this layer's pre-activation at `gain`, for a
        caller that applies it fused, as `spade_norm_act` does, and then
        calls forward with no_act. The fused pre-activation is a relu with
        no bias: a layer with another activation or a bias is refused."""
        if self.activation != "relu" or self.bias is not None:
            raise ValueError(
                f"spade_norm_act fuses a relu pre-activation with no bias, "
                f"not {self.activation} with bias {self.bias is not None}")
        act_clamp = (self.conv_clamp * gain
                     if self.conv_clamp is not None else None)
        return activation_funcs["relu"].def_gain * gain, act_clamp

    def forward(self, x, gain=1.0, no_act=False):
        if not no_act:
            act_gain = activation_funcs[self.activation].def_gain * gain
            act_clamp = (self.conv_clamp * gain
                         if self.conv_clamp is not None else None)
            x = bias_act(x, self.bias, act=self.activation, gain=act_gain,
                         clamp=act_clamp)
        w = _hwio((self.weight * self.weight_gain).to(x.dtype))
        return conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                               down=self.down, padding=self.padding,
                               flip_weight=(self.up == 1))


class _ConvWeight(nn.Module):
    """Weight-only holder (`<name>.weight`), so a parent can fuse several
    same-input convs into one."""

    def __init__(self, shape):
        super().__init__()
        add_param(self, "weight", tuple(shape), _normal(1.0))


class SpadeNormBlock(nn.Module):
    """SPADE: InstanceNorm(x) * (1 + gamma(feat)) + beta(feat); gamma and
    beta run as one C -> 2C conv. With `act` = (gain, clamp), the relu
    pre-activation of the conv that takes the result is applied too, fused
    with the normalisation (`ops/spade_norm.py`); `stats` are moments of x
    shared with another block's call on the same x."""

    def __init__(self, in_channels, norm_channels):
        super().__init__()
        c = norm_channels
        self.conv_mlp = SpadeConv2dLayer(in_channels, c, kernel_size=3,
                                         use_bias=False)
        self.conv_gamma = _ConvWeight((c, c, 3, 3))
        self.conv_beta = _ConvWeight((c, c, 3, 3))
        self.gain = 1.0 / math.sqrt(c * 3 * 3)

    def forward(self, x, denorm_feats, act=None, stats=None):
        actv = F.relu(self.conv_mlp(denorm_feats, no_act=True))
        w_gb = torch.cat([self.conv_gamma.weight, self.conv_beta.weight],
                         dim=0) * self.gain
        gb = conv2d_resample(actv, _hwio(w_gb.to(actv.dtype)), f=None,
                             padding=1, flip_weight=True)
        if act is not None:
            return spade_norm_act(x, gb, *act, stats=stats)
        return spade_norm(x, gb)


class SpadeResBlock(nn.Module):
    """Residual block with SPADE conditioning before each conv."""

    def __init__(self, in_channels, out_channels, spade_channels,
                 conv_clamp=None, resample_filter=(1, 3, 3, 1)):
        super().__init__()
        common = dict(resample_filter=resample_filter, conv_clamp=conv_clamp,
                      use_bias=False)
        self.conv = SpadeConv2dLayer(in_channels, in_channels, 3, **common)
        self.conv0 = SpadeConv2dLayer(in_channels, out_channels, 3, **common)
        self.conv1 = SpadeConv2dLayer(out_channels, out_channels, 3, **common)
        self.skip = SpadeConv2dLayer(in_channels, out_channels, 1, **common)
        self.spade_skip = SpadeNormBlock(spade_channels, in_channels)
        self.spade0 = SpadeNormBlock(spade_channels, in_channels)
        self.spade1 = SpadeNormBlock(spade_channels, out_channels)

    def forward(self, x, denorm_feat):
        # each conv's relu pre-activation runs fused into the SPADE norm
        # before it (the convs have no bias); spade_skip and spade0 share
        # the moments of x
        x = self.conv(x, no_act=True)
        stats = spade_norm_stats(x)
        y = self.skip(self.spade_skip(x, denorm_feat,
                                      self.skip.act_args(math.sqrt(0.5)),
                                      stats), no_act=True)
        x = self.conv0(self.spade0(x, denorm_feat, self.conv0.act_args(),
                                   stats), no_act=True)
        x = self.conv1(self.spade1(x, denorm_feat,
                                   self.conv1.act_args(math.sqrt(0.5))),
                       no_act=True)
        return y + x


class _SynthesisBlockBase(nn.Module):
    """Shared structure of the style (v6) and texture (v4) blocks.

    use_bf16 runs the block's convs in bfloat16 with fp32 params; torgb
    outputs are accumulated in fp32."""

    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 img_channels, is_last, is_style=False,
                 resample_filter=(1, 3, 3, 1), conv_clamp=None,
                 use_noise=True, use_bf16=False):
        super().__init__()
        self.in_channels, self.resolution = in_channels, resolution
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        common = dict(w_dim=w_dim, resolution=resolution,
                      resample_filter=resample_filter, conv_clamp=conv_clamp,
                      use_noise=use_noise)
        if in_channels != 0:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2,
                                        **common)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        if in_channels != 0 and resolution > 32:
            self.merge_conv = Conv2dLayer(out_channels + 64, out_channels,
                                          kernel_size=1,
                                          resample_filter=resample_filter)
        self.torgb = ToRGBLayer(
            out_channels, img_channels, w_dim=w_dim, conv_clamp=conv_clamp,
            parsing_channels=(7 if (is_last and is_style) else None))
        register_filter(self, resample_filter)

    def _main(self, x, ws, pose_feature, cat_feat, noise_mode, generator):
        w_idx = 0
        if self.in_channels == 0:
            x = pose_feature.to(self.dtype)
        else:
            x = self.conv0(x, ws[:, w_idx], noise_mode=noise_mode,
                           generator=generator)
            w_idx += 1
        x = self.conv1(x, ws[:, w_idx], noise_mode=noise_mode,
                       generator=generator)
        w_idx += 1
        if self.in_channels != 0 and self.resolution > 32:
            x = self.merge_conv(torch.cat([x, cat_feat.to(x.dtype)], dim=-1))
        return x, w_idx

    def _torgb(self, x, img, ws, w_idx):
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y, pred_parsing = self.torgb(x, ws[:, w_idx])
        y = y.float()
        if pred_parsing is not None:
            pred_parsing = pred_parsing.float()
        return (img + y if img is not None else y), pred_parsing


class SynthesisBlockStyle(_SynthesisBlockBase):
    """Style-branch block: no SPADE; the last block's torgb also emits the
    7-class parsing prediction."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, is_style=True, **kwargs)

    def forward(self, x, img, ws, pose_feature, cat_feat,
                noise_mode="random", generator=None):
        x = x.to(self.dtype) if x is not None else x
        x, w_idx = self._main(x, ws, pose_feature, cat_feat, noise_mode,
                              generator)
        img, pred_parsing = self._torgb(x, img, ws, w_idx)
        return x, img, pred_parsing


class SynthesisBlockTexture(_SynthesisBlockBase):
    """Texture-branch block: SPADE resblock conditioned on the
    parsing-index map after the merge."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, is_style=False, **kwargs)
        out_channels = self.conv1.weight.shape[0]
        self.spade_b512 = SpadeResBlock(
            out_channels, out_channels, spade_channels=1,
            conv_clamp=self.conv1.conv_clamp)

    def forward(self, x, img, ws, pose_feature, cat_feat, parsing,
                noise_mode="random", generator=None):
        x = x.to(self.dtype)
        x, w_idx = self._main(x, ws, pose_feature, cat_feat, noise_mode,
                              generator)
        x = self.spade_b512(x, parsing.to(x.dtype))
        img, pred_parsing = self._torgb(x, img, ws, w_idx)
        return x, img, pred_parsing
