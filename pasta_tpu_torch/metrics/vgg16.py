"""VGG16 feature detector + LPIPS embedding, NHWC, port of
pasta_tpu/metrics/vgg16.py.

The reference's PPL and PR load NVIDIA's TorchScript VGG16 detector
(metrics/metric_utils.py:21-51):
  * PR takes its 4096-d fc7 (relu) features (`fc_features`);
  * PPL takes its LPIPS embedding, unit-normalized, lin-weighted conv
    features laid out so that the squared L2 distance of two embeddings IS
    their LPIPS distance (`lpips_features`, `lpips_distance`).

One torchvision-layout VGG16 backbone (config D: 13 convs + 3 fc) serves
both heads. Parameters carry torchvision's keys (`features.N.weight` OIHW,
`classifier.{0,3,6}.weight`) plus the LPIPS `lins.{k}` channel weights
(`import_state` takes a torchvision state dict and the official LPIPS
`lin{k}.model.1.weight`). No weights can be fetched, so the tests and the
smoke use seeded random ones (`random_vgg16_state`, the JAX package's
`random_vgg16_params` drawn alike).

The convs go through `ops/conv2d_resample._conv2d`, like every conv of the
port: features.2 (64 -> 64), .5 (64 -> 128) and .7 (128 -> 128) take K1 on
CUDA tensors, in fp32.

Input conventions, as in the JAX package: `fc_features` takes uint8 RGB
[N, H, W, 3] and resizes it to 224 bilinearly with jax.image.resize's
default, which antialiases a downscale (torch's antialias=True; no effect
on an upscale), then the ImageNet mean / std; `lpips_features` takes float
images in [-1, 1] at any resolution and applies the LPIPS shift / scale.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv2d_resample import _conv2d
from .inception import _holder

# torchvision vgg16 'features' config D; 'M' = 2x2 maxpool.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (torchvision
# feature indices of the relu producing each slice).
LPIPS_TAPS = (3, 8, 15, 22, 29)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# LPIPS ScalingLayer constants (applied to [-1, 1] input).
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def _layers():
    """[(kind, tv_index, out_channels)] over the whole 'features' stack."""
    layers = []
    idx = 0
    for v in VGG16_CFG:
        if v == "M":
            layers.append(("pool", idx, None))
            idx += 1
        else:
            layers.append(("conv", idx, v))
            layers.append(("relu", idx + 1, None))
            idx += 2
    return layers


def _const(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


class VGG16(nn.Module):
    """VGG16 backbone + classifier + LPIPS lin weights, NHWC."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        in_ch = 3
        for kind, idx, out_ch in _layers():
            if kind == "conv":
                self.features[str(idx)] = _holder(
                    weight=(out_ch, in_ch, 3, 3), bias=(out_ch,))
                in_ch = out_ch
        self.classifier = nn.ModuleDict({
            "0": _holder(weight=(4096, 512 * 49), bias=(4096,)),
            "3": _holder(weight=(4096, 4096), bias=(4096,)),
            "6": _holder(weight=(1000, 4096), bias=(1000,))})
        self.lins = nn.ParameterDict({
            str(k): nn.Parameter(torch.full((c,), 1.0 / c))
            for k, c in enumerate(LPIPS_CHANNELS)})

    def backbone(self, x, taps=()):
        """The conv stack; (final 7x7x512 maps, {tap index: activation})."""
        slices = {}
        for kind, idx, _ in _layers():
            if kind == "conv":
                p = self.features[str(idx)]
                x = _conv2d(x, p.weight.permute(2, 3, 1, 0), padding=1) \
                    + p.bias
            elif kind == "relu":
                x = F.relu(x)
                if idx in taps:
                    slices[idx] = x
            else:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
        return x, slices

    def _linear(self, x, idx):
        c = self.classifier[idx]
        return x @ c.weight.T + c.bias

    def fc_features(self, images_uint8):
        """uint8 RGB [N, H, W, 3] -> 4096-d fc7 (relu) features."""
        x = images_uint8.float() / 255.0
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(224, 224),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        x = (x - _const(IMAGENET_MEAN, x)) / _const(IMAGENET_STD, x)
        x, _ = self.backbone(x)
        # torchvision flattens NCHW (C-major), as the classifier expects
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], 512 * 49)
        x = F.relu(self._linear(x, "0"))
        return F.relu(self._linear(x, "3"))

    def logits(self, images_uint8):
        """1000-way classifier logits (fc8)."""
        return self._linear(self.fc_features(images_uint8), "6")

    def lpips_features(self, images_pm1):
        """[-1, 1] float RGB [N, H, W, 3] -> LPIPS embedding [N, D]: each
        tap's unit-normalized activations scaled by sqrt(lin_w / (H*W))
        and flattened (NHWC order), so that sum((f(a) - f(b))**2, -1) ==
        LPIPS(a, b)."""
        x = images_pm1.float()
        x = (x - _const(LPIPS_SHIFT, x)) / _const(LPIPS_SCALE, x)
        _, slices = self.backbone(x, taps=LPIPS_TAPS)
        feats = []
        for i, tap in enumerate(LPIPS_TAPS):
            act = slices[tap]
            act = act * torch.rsqrt(
                act.square().sum(dim=-1, keepdim=True) + 1e-10)
            hw = act.shape[1] * act.shape[2]
            act = act * torch.sqrt(self.lins[str(i)].clamp(min=0.0) / hw)
            feats.append(act.reshape(act.shape[0], -1))
        return torch.cat(feats, dim=-1)

    def lpips_distance(self, a_pm1, b_pm1):
        """LPIPS(a, b) per pair: squared L2 of the LPIPS embeddings."""
        fa = self.lpips_features(a_pm1)
        fb = self.lpips_features(b_pm1)
        return (fa - fb).square().sum(dim=-1)


def import_state(state: Dict[str, Any],
                 lpips_state: Optional[Dict[str, Any]] = None):
    """A torchvision vgg16 state dict (+ the official LPIPS lin weights,
    `lin{k}.model.1.weight` [1, C, 1, 1]) -> this module's state dict;
    without LPIPS weights each tap's lin is 1 / C, as in the JAX package."""
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] in ("features", "classifier") and \
                parts[-1] in ("weight", "bias"):
            out[key] = torch.as_tensor(np.asarray(value, np.float32))
    for k, c in enumerate(LPIPS_CHANNELS):
        lin = (np.asarray(lpips_state[f"lin{k}.model.1.weight"], np.float32)
               .reshape(-1) if lpips_state is not None
               else np.ones((c,), np.float32) / c)
        out[f"lins.{k}"] = torch.from_numpy(lin)
    return out


def random_vgg16_state(seed=0):
    """Seeded random weights, drawn as the JAX package's
    `random_vgg16_params(seed)` draws them, as this module's state dict."""
    from ..io.from_jax import vgg16_jax_to_state_dict

    rng = np.random.RandomState(seed)
    tree: Dict[str, Any] = {"features": {}, "classifier": {}, "lins": {}}
    in_ch = 3
    for kind, tv_idx, out_ch in _layers():
        if kind != "conv":
            continue
        fan_in = 9 * in_ch
        tree["features"][str(tv_idx)] = dict(
            weight=(rng.randn(3, 3, in_ch, out_ch)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32),
            bias=np.zeros((out_ch,), np.float32))
        in_ch = out_ch
    for idx, (din, dout) in ((0, (512 * 49, 4096)), (3, (4096, 4096)),
                             (6, (4096, 1000))):
        tree["classifier"][str(idx)] = dict(
            weight=(rng.randn(dout, din)
                    * np.sqrt(2.0 / din)).astype(np.float32),
            bias=np.zeros((dout,), np.float32))
    tree["lins"] = {str(k): rng.rand(c).astype(np.float32) / c
                    for k, c in enumerate(LPIPS_CHANNELS)}
    return vgg16_jax_to_state_dict(tree)
