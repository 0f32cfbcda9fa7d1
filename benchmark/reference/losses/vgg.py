"""VGG19 perceptual feature loss: a frozen copy of the port's
`losses/vgg.py` (reference loss_fullbody.py:336-477).

Feature slices at torchvision `features` indices [0:2, 2:7, 7:12, 12:21,
21:30] (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1), L1 distance with
weights [1/32, 1/16, 1/8, 1/4, 1]; the target branch carries no gradient.
Parameters use torchvision's `features.N.weight` / `.bias` keys (OIHW), so
a torchvision vgg19 state dict loads as it is; the repository holds none,
so the weights are seeded random unless one is loaded.

The 3x3 convs go through `ops/conv2d_resample._conv2d` (F.conv2d here;
in the port conv1_2, conv2_1 and conv2_2 take K1). A bf16 input (`dtype`)
makes only the first conv bf16: its fp32 bias promotes the sum to fp32,
and every later conv runs in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import _const, _normal, add_param, init_weights
from ..ops.conv2d_resample import _conv2d

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
SLICE_BOUNDS = [2, 7, 12, 21, 30]
FEATURE_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def _torchvision_layers():
    """[(kind, tv_index, out_channels)] for the first 30 feature modules."""
    layers = []
    idx = 0
    for v in VGG19_CFG:
        if v == "M":
            layers.append(("pool", idx, None))
            idx += 1
        else:
            layers.append(("conv", idx, v))
            layers.append(("relu", idx + 1, None))
            idx += 2
    return [l for l in layers if l[1] < 30]


class _VGGConv(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        add_param(self, "weight", (out_ch, in_ch, 3, 3),
                  _normal(math.sqrt(2.0 / (9 * in_ch))))
        add_param(self, "bias", (out_ch,), _const(0.0))


class VGG19Features(nn.Module):
    """NHWC VGG19 feature pyramid (5 slices); weights from `seed`."""

    def __init__(self, seed=None):
        super().__init__()
        self.features = nn.ModuleDict()
        in_ch = 3
        for kind, idx, out_ch in _torchvision_layers():
            if kind == "conv":
                self.features[str(idx)] = _VGGConv(in_ch, out_ch)
                in_ch = out_ch
        if seed is not None:        # None: the caller loads every leaf
            init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        feats = []
        bounds = list(SLICE_BOUNDS)
        for kind, idx, _ in _torchvision_layers():
            if kind == "conv":
                conv = self.features[str(idx)]
                w = conv.weight.permute(2, 3, 1, 0).to(x.dtype)
                x = _conv2d(x, w, padding=1) + conv.bias
            elif kind == "relu":
                x = F.relu(x)
            else:          # maxpool 2x2 stride 2
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
            if bounds and idx + 1 == bounds[0]:
                feats.append(x)
                bounds.pop(0)
        return feats


def vgg_features(vgg, x, dtype=None):
    """Feature pyramid of one image batch (5 slices)."""
    if dtype is not None:
        x = x.to(dtype)
    return vgg(x)


def vgg_feature_loss(vgg, x, target_feats, weights=FEATURE_WEIGHTS,
                     dtype=None):
    """Weighted multi-slice L1 distance of x's features to a precomputed
    target pyramid (detached here), accumulated in fp32."""
    loss = 0.0
    for w, a, b in zip(weights, vgg_features(vgg, x, dtype=dtype),
                       target_feats):
        loss = loss + w * (a - b.detach()).abs().float().mean()
    return loss


def vgg_loss(vgg, x, y, weights=FEATURE_WEIGHTS, dtype=None):
    """Weighted multi-slice L1 feature distance; y is the target."""
    with torch.no_grad():
        fy = vgg_features(vgg, y, dtype=dtype)
    return vgg_feature_loss(vgg, x, fy, weights=weights, dtype=dtype)
