"""Contextual loss, port of pasta_tpu/losses/contextual.py (reference
loss_fullbody.py:483-618).

Cosine-distance softmax affinity between the VGG19 features of the
generated and the target image. The trainer adds it when contextual_weight
> 0 and VGG weights are given (default 0 in the shipped config).

At 512 px, relu3_1 (pooled to 64 x 64) and relu4_1 each give an
[N, 4096, 4096] fp32 affinity: 64 MiB a sample for each intermediate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..train.dist import all_reduce_mean


def contextual_distance(x_feat, y_feat, h=0.5, eps=1e-5):
    """CX distance between feature maps [N, H, W, C]
    (loss_fullbody.py:574-618): features centred on the target's mean over
    the global batch, L2-normalised, matched by a softmax over relative
    cosine distances."""
    n, _, _, c = x_feat.shape
    # the target's mean over the global batch (every rank holds as many
    # pixels); the target carries no gradient
    y_mu = all_reduce_mean(y_feat.mean(dim=(0, 1, 2), keepdim=True))
    x = x_feat - y_mu
    y = y_feat - y_mu
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + eps)
    x = x.reshape(n, -1, c)
    y = y.reshape(n, -1, c)
    # cosine distance -> relative distance -> softmax affinity
    d = 1.0 - torch.bmm(x, y.transpose(1, 2))
    d_min = d.amin(dim=2, keepdim=True)
    d_rel = d / (d_min + eps)
    w = torch.exp((1.0 - d_rel) / h)
    cx = w / w.sum(dim=2, keepdim=True)
    cx_max = cx.amax(dim=1)       # best match per target feature
    return (-torch.log(cx_max.mean(dim=1) + eps)).mean()


def contextual_loss(vgg, x, y, layers=(2, 3), h=0.5, max_spatial=64):
    """Contextual loss over VGG19 slices (relu3_1, relu4_1 by default) of
    `vgg` (losses/vgg.py::VGG19Features), in the inputs' dtype; the target
    carries no gradient. Maps wider than max_spatial are average-pooled
    2x2 until they fit (the affinity is quadratic in pixels)."""
    fx = vgg(x)
    with torch.no_grad():
        fy = vgg(y)
    loss = 0.0
    for i in layers:
        a, b = fx[i], fy[i]
        while a.shape[1] > max_spatial:
            a = F.avg_pool2d(a.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            b = F.avg_pool2d(b.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        loss = loss + contextual_distance(a, b, h=h)
    return loss
