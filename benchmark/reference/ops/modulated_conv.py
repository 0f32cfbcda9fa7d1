"""StyleGAN2 modulated convolution, NHWC, port of
pasta_tpu/ops/modulated_conv.py.

Activation-scaling formulation: scale inputs by styles, run ONE
shared-weight conv, scale outputs by the demodulation coefficients

    dcoef[n, o] = rsqrt( sum_{i,k,k} (w[o,i,k,k] * s[n,i])^2 + 1e-8 ),

computed as an [N,I] x [I,O] matmul over per-(i,o) squared-weight sums.
"""

from __future__ import annotations

import math

import torch

from .conv2d_resample import conv2d_resample


def modulated_conv2d(
    x,                      # [N, H, W, I] input.
    weight,                 # [kh, kw, I, O] weights (HWIO).
    styles,                 # [N, I] modulation coefficients.
    noise=None,             # optional [N, H', W', 1]-broadcastable noise.
    up=1,
    down=1,
    padding=0,
    resample_filter=None,   # FIR filter from setup_filter.
    demodulate=True,
    flip_weight=True,
    input_gain=None,        # optional extra per-input-channel gain.
):
    """Per-sample style-modulated conv with optional demodulation.

    Returns [N, out_h, out_w, O], same dtype as x.
    """
    n = x.shape[0]
    kh, kw, in_ch, out_ch = weight.shape
    assert styles.shape == (n, in_ch)

    # Pre-normalize against overflow in reduced precision (the reference
    # fp16 guard, applied for bf16 as in the JAX package).
    if x.dtype == torch.bfloat16 and demodulate:
        weight = weight * (
            1 / math.sqrt(in_ch * kh * kw)
            / weight.abs().amax(dim=(0, 1, 2), keepdim=True))
        styles = styles / styles.abs().amax(dim=1, keepdim=True)

    dcoefs = None
    if demodulate:
        w_sq = weight.float().square().sum(dim=(0, 1))          # [I, O]
        dcoefs = torch.rsqrt(styles.float().square() @ w_sq + 1e-8)

    if input_gain is not None:
        styles = styles * input_gain

    x = x * styles.to(x.dtype)[:, None, None, :]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, None, None, :]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
