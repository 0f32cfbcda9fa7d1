"""StyleGAN2 discriminator (resnet architecture), NHWC: a frozen copy of
the port's `models/discriminator.py`.

The trainer builds two (train/state.py): the image D with img_channels
3 + 3 (image and pose rgb) and the parsing D with 7 + 3. `num_bf16_res`
runs the top resolutions in bf16 with fp32 parameters (the reference's
fp16 blocks), `conv_clamp` clamps their conv outputs. Parameters carry the
reference torch state-dict names and layouts; the epilogue's `fc` weight is
in the reference's NCHW flatten order, so the epilogue flattens [C, 4, 4].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..nn.layers import (Conv2dLayer, FullyConnectedLayer, MinibatchStdLayer,
                         init_weights)
from ..nn.mapping import MappingNetwork
from ..shapes import assert_shape


class DiscriminatorBlock(nn.Module):
    """fromrgb (first block only), conv0, conv1 (down 2) and a 1x1 skip
    (down 2), each path scaled by sqrt(1/2)."""

    def __init__(self, in_channels, tmp_channels, out_channels, resolution,
                 img_channels, activation="lrelu",
                 resample_filter=(1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_bf16=False):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        common = dict(conv_clamp=conv_clamp)
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1,
                                       activation=activation, **common)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3,
                                 activation=activation, **common)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3,
                                 activation=activation, down=2,
                                 resample_filter=resample_filter, **common)
        self.skip = Conv2dLayer(tmp_channels, out_channels, 1, use_bias=False,
                                down=2, resample_filter=resample_filter)

    def forward(self, x, img):
        if x is not None:
            x = x.to(self.dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(self.dtype))
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, in_channels, cmap_dim, resolution, mbstd_group_size=4,
                 mbstd_num_channels=1, activation="lrelu",
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels,
                                3, activation=activation,
                                conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2,
                                      in_channels, activation=activation)
        self.out = FullyConnectedLayer(in_channels,
                                       1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, cmap):
        x = x.float()
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.fc(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) * (
                1.0 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """Parameters are drawn at construction from a CPU torch.Generator
    seeded with `seed`; with `seed` None the caller loads every leaf."""

    def __init__(self, c_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, num_bf16_res=0,
                 conv_clamp: Optional[float] = None,
                 cmap_dim: Optional[int] = None, mbstd_group_size=4, seed=0):
        super().__init__()
        self.img_resolution, self.img_channels = img_resolution, img_channels
        res_log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.block_resolutions + [4]}
        bf16_resolution = max(2 ** (res_log2 + 1 - num_bf16_res), 8)
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res],
                channels[res // 2], resolution=res,
                img_channels=img_channels, conv_clamp=conv_clamp,
                use_bf16=(num_bf16_res > 0 and res >= bf16_resolution)))
        self.mapping = (MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim,
                                       num_ws=None, w_avg_beta=None)
                        if c_dim > 0 else None)
        self.b4 = DiscriminatorEpilogue(
            channels[4], cmap_dim=cmap_dim, resolution=4,
            conv_clamp=conv_clamp, mbstd_group_size=mbstd_group_size)
        if seed is not None:
            init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, img, c):
        assert_shape(img, (None, self.img_resolution, self.img_resolution,
                           self.img_channels), name="img")
        x = None
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x, img)
        cmap = self.mapping(None, c) if self.mapping is not None else None
        return self.b4(x, cmap)
