"""InceptionV3 feature extractor (FID variant), NHWC, port of
pasta_tpu/metrics/inception.py.

The torchvision `inception_v3` topology with the pytorch-fid modifications
(the avg-pools exclude padding; the last InceptionE max-pools in its pool
branch): the standard FID feature network. Parameters carry torchvision's
state-dict keys (`Conv2d_1a_3x3.conv.weight`, `.bn.running_var`, ...,
`fc.weight`), so a torchvision or pytorch-fid state dict loads once its
`AuxLogits.*` and `num_batches_tracked` entries are dropped
(`torchvision_state`); the repository holds no weights, so the tests and
the smoke use seeded random ones (`random_inception_state`, the JAX
package's `random_inception_params` drawn alike).

Every conv goes through `ops/conv2d_resample._conv2d`, the port's one conv
entry: the four `branch3x3dbl_2` convs of Mixed_5b/5c/5d/6a (64 -> 96, 3x3,
pad 1) lie in K1's scope and take it on CUDA tensors, in fp32.

Feature layout: 2048-d pool3 features (+ 1000/1008-way logits for IS).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv2d_resample import _conv2d

BN_EPS = 1e-3


def _holder(**params):
    """A module that only holds the named parameters (zeros)."""
    m = nn.Module()
    for name, shape in params.items():
        setattr(m, name, nn.Parameter(torch.zeros(shape)))
    return m


class BasicConv2d(nn.Module):
    """conv (no bias) -> batchnorm (eps 1e-3, running stats) -> relu."""

    def __init__(self, cin, cout, kh, kw, stride=1, padding=0):
        super().__init__()
        self.stride = stride
        # (py, px), each applied on both sides
        self.padding = ((padding, padding) if isinstance(padding, int)
                        else padding)
        self.conv = _holder(weight=(cout, cin, kh, kw))
        self.bn = _holder(weight=(cout,), bias=(cout,))
        self.bn.register_buffer("running_mean", torch.zeros(cout))
        self.bn.register_buffer("running_var", torch.ones(cout))

    def forward(self, x):
        x = _conv2d(x, self.conv.weight.permute(2, 3, 1, 0), self.stride,
                    list(self.padding))
        bn = self.bn
        inv = torch.rsqrt(bn.running_var + BN_EPS)
        return F.relu((x - bn.running_mean) * inv * bn.weight + bn.bias)


def _nchw(fn, x, *args, **kw):
    """An NCHW pooling op on an NHWC tensor (a view either way)."""
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def _avg_pool3(x, fid_variant=True):
    """3x3 stride-1 avg pool, pad 1; the FID variant excludes the padding
    from the divisor (count_include_pad=False)."""
    return _nchw(F.avg_pool2d, x, 3, 1, 1,
                 count_include_pad=not fid_variant)


def _max_pool(x, window=3, stride=2, padding=0):
    return _nchw(F.max_pool2d, x, window, stride, padding)


def _cat(*xs):
    return torch.cat(xs, dim=-1)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, 1)

    def forward(self, x, fid_variant):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x, fid_variant))
        return _cat(b1, b5, b3, bp)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(b3, bd, _max_pool(x))


class InceptionC(nn.Module):
    def __init__(self, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, 1, 7, padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, 7, 1, padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, 7, 1, padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, 1, 7, padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, 7, 1, padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, 1, 7, padding=(0, 3))
        self.branch_pool = BasicConv2d(768, 192, 1, 1)

    def forward(self, x, fid_variant):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool3(x, fid_variant))
        return _cat(b1, b7, bd, bp)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, 1, 7, padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, 7, 1, padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2,
                      self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return _cat(b3, b7, _max_pool(x))


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, 1, 3, padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, 3, 1, padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, 1, 3, padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, 3, 1, padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1, 1)

    def forward(self, x, fid_variant, use_max_pool):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = _cat(self.branch3x3_2a(b3), self.branch3x3_2b(b3))
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = _cat(self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd))
        bp = (_max_pool(x, window=3, stride=1, padding=1) if use_max_pool
              else _avg_pool3(x, fid_variant))
        return _cat(b1, b3, bd, self.branch_pool(bp))


class InceptionV3(nn.Module):
    """The FID InceptionV3 over NHWC images in [-1, 1], any size >= 75 px
    (299 is the protocol's; `preprocess_images` gives it)."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(128)
        self.Mixed_6c = InceptionC(160)
        self.Mixed_6d = InceptionC(160)
        self.Mixed_6e = InceptionC(192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = _holder(weight=(num_classes, 2048), bias=(num_classes,))

    def forward(self, x, fid_variant=True, return_logits=False):
        """x: [N, H, W, 3] in [-1, 1] -> 2048-d features (and logits)."""
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = _max_pool(self.Conv2d_2b_3x3(x))
        x = self.Conv2d_3b_1x1(x)
        x = _max_pool(self.Conv2d_4a_3x3(x))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
            x = block(x, fid_variant)
        x = self.Mixed_6a(x)
        for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d,
                      self.Mixed_6e):
            x = block(x, fid_variant)
        x = self.Mixed_7a(x)
        x = self.Mixed_7b(x, fid_variant, use_max_pool=False)
        x = self.Mixed_7c(x, fid_variant, use_max_pool=fid_variant)
        feats = x.mean(dim=(1, 2))              # global avg pool -> [N, 2048]
        if not return_logits:
            return feats
        return feats, feats @ self.fc.weight.T + self.fc.bias


def preprocess_images(images_uint8):
    """[N, H, W, 3] uint8 (or 0..255 float) tensor -> bilinear 299x299
    (no antialias, as the JAX package resizes), scaled to [-1, 1]."""
    x = images_uint8.float() / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                      mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1) * 2 - 1


def torchvision_state(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 (or pytorch-fid FIDInceptionV3) state
    dict -> this module's, as the JAX package's importer reads it (the
    auxiliary head and the batch counters dropped)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in state.items()
            if not k.startswith("AuxLogits")
            and not k.endswith("num_batches_tracked")}


def _conv_bn_shapes(cin, cout, kh, kw):
    return dict(
        conv=dict(weight=(kh, kw, cin, cout)),
        bn=dict(weight=(cout,), bias=(cout,), running_mean=(cout,),
                running_var=(cout,)),
    )


def inception_param_shapes(num_classes=1000):
    """Shape tree of the FID InceptionV3 in the JAX package's layout (HWIO
    conv weights); copied from pasta_tpu/metrics/inception.py."""
    s = {}
    s["Conv2d_1a_3x3"] = _conv_bn_shapes(3, 32, 3, 3)
    s["Conv2d_2a_3x3"] = _conv_bn_shapes(32, 32, 3, 3)
    s["Conv2d_2b_3x3"] = _conv_bn_shapes(32, 64, 3, 3)
    s["Conv2d_3b_1x1"] = _conv_bn_shapes(64, 80, 1, 1)
    s["Conv2d_4a_3x3"] = _conv_bn_shapes(80, 192, 3, 3)

    def mixed_a(cin, pf):
        return dict(
            branch1x1=_conv_bn_shapes(cin, 64, 1, 1),
            branch5x5_1=_conv_bn_shapes(cin, 48, 1, 1),
            branch5x5_2=_conv_bn_shapes(48, 64, 5, 5),
            branch3x3dbl_1=_conv_bn_shapes(cin, 64, 1, 1),
            branch3x3dbl_2=_conv_bn_shapes(64, 96, 3, 3),
            branch3x3dbl_3=_conv_bn_shapes(96, 96, 3, 3),
            branch_pool=_conv_bn_shapes(cin, pf, 1, 1))

    s["Mixed_5b"] = mixed_a(192, 32)
    s["Mixed_5c"] = mixed_a(256, 64)
    s["Mixed_5d"] = mixed_a(288, 64)
    s["Mixed_6a"] = dict(
        branch3x3=_conv_bn_shapes(288, 384, 3, 3),
        branch3x3dbl_1=_conv_bn_shapes(288, 64, 1, 1),
        branch3x3dbl_2=_conv_bn_shapes(64, 96, 3, 3),
        branch3x3dbl_3=_conv_bn_shapes(96, 96, 3, 3))

    def mixed_c(c7):
        return dict(
            branch1x1=_conv_bn_shapes(768, 192, 1, 1),
            branch7x7_1=_conv_bn_shapes(768, c7, 1, 1),
            branch7x7_2=_conv_bn_shapes(c7, c7, 1, 7),
            branch7x7_3=_conv_bn_shapes(c7, 192, 7, 1),
            branch7x7dbl_1=_conv_bn_shapes(768, c7, 1, 1),
            branch7x7dbl_2=_conv_bn_shapes(c7, c7, 7, 1),
            branch7x7dbl_3=_conv_bn_shapes(c7, c7, 1, 7),
            branch7x7dbl_4=_conv_bn_shapes(c7, c7, 7, 1),
            branch7x7dbl_5=_conv_bn_shapes(c7, 192, 1, 7),
            branch_pool=_conv_bn_shapes(768, 192, 1, 1))

    s["Mixed_6b"] = mixed_c(128)
    s["Mixed_6c"] = mixed_c(160)
    s["Mixed_6d"] = mixed_c(160)
    s["Mixed_6e"] = mixed_c(192)
    s["Mixed_7a"] = dict(
        branch3x3_1=_conv_bn_shapes(768, 192, 1, 1),
        branch3x3_2=_conv_bn_shapes(192, 320, 3, 3),
        branch7x7x3_1=_conv_bn_shapes(768, 192, 1, 1),
        branch7x7x3_2=_conv_bn_shapes(192, 192, 1, 7),
        branch7x7x3_3=_conv_bn_shapes(192, 192, 7, 1),
        branch7x7x3_4=_conv_bn_shapes(192, 192, 3, 3))

    def mixed_e(cin):
        return dict(
            branch1x1=_conv_bn_shapes(cin, 320, 1, 1),
            branch3x3_1=_conv_bn_shapes(cin, 384, 1, 1),
            branch3x3_2a=_conv_bn_shapes(384, 384, 1, 3),
            branch3x3_2b=_conv_bn_shapes(384, 384, 3, 1),
            branch3x3dbl_1=_conv_bn_shapes(cin, 448, 1, 1),
            branch3x3dbl_2=_conv_bn_shapes(448, 384, 3, 3),
            branch3x3dbl_3a=_conv_bn_shapes(384, 384, 1, 3),
            branch3x3dbl_3b=_conv_bn_shapes(384, 384, 3, 1),
            branch_pool=_conv_bn_shapes(cin, 192, 1, 1))

    s["Mixed_7b"] = mixed_e(1280)
    s["Mixed_7c"] = mixed_e(2048)
    s["fc"] = dict(weight=(num_classes, 2048), bias=(num_classes,))
    return s


def random_inception_state(seed=0, num_classes=1000):
    """Seeded random weights (no real ones can be fetched), drawn as the
    JAX package's `random_inception_params(seed)` draws them, as this
    module's state dict."""
    from ..io.from_jax import inception_jax_to_state_dict

    rng = np.random.RandomState(seed)

    def fill(node, in_bn=False):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v, in_bn=(k == "bn"))
            elif k == "running_var":
                out[k] = np.ones(v, np.float32)
            elif k == "running_mean":
                out[k] = np.zeros(v, np.float32)
            elif in_bn and k == "weight":
                # near-identity BN so activations survive ~40 layers
                out[k] = (1 + 0.1 * rng.randn(*v)).astype(np.float32)
            elif k == "weight" and len(v) >= 2:
                fan_in = int(np.prod(v[:-1]))
                out[k] = (rng.randn(*v) * np.sqrt(2.0 / fan_in)).astype(
                    np.float32)
            else:
                out[k] = rng.randn(*v).astype(np.float32) * 0.1
        return out

    return inception_jax_to_state_dict(fill(inception_param_shapes(
        num_classes)))
