"""ADA augmentation pipeline (StyleGAN2-ADA), NHWC: a frozen copy of the
port's `train/augment.py` (reference training/augment.py, AugmentPipe).

The geometric stage runs the two-pass warp of ops/affine_warp.py
(`geom_resample_twopass`, in bf16, with the plain row shift where the port
launches K2/K3); the reflection at the borders is analytic after a static
reflect margin. Every draw comes from the torch.Generator it is given, in
the port's order, so the same generator state gives the same transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import scipy.signal
import torch

from ..ops.affine_warp import geom_resample_twopass
from ..ops.filters import setup_filter

# 'sym2'/'sym6' wavelets (reference augment.py:21-38).
WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735,
             0.836516303737469, 0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702,
             -0.11799011114819057, -0.048311742585633, 0.4910559419267466,
             0.787641141030194, 0.3379294217276218, -0.07263752278646252,
             -0.021060292512300564, 0.04472490177066578,
             0.0017677118642428036, -0.007800708325034148],
}


def _make_fbank():
    """4-band filter bank from sym2 (reference augment.py:171-181)."""
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(
            fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


def _eye(n, k, dev):
    return torch.eye(k, device=dev).expand(n, k, k).clone()


def _translate2d(tx, ty):
    m = _eye(tx.shape[0], 3, tx.device)
    m[:, 0, 2] = tx
    m[:, 1, 2] = ty
    return m


def _scale2d(sx, sy):
    m = _eye(sx.shape[0], 3, sx.device)
    m[:, 0, 0] = sx
    m[:, 1, 1] = sy
    return m


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(theta.shape[0], 3, theta.device)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def _translate3d(t):
    """[N, 3] -> [N, 4, 4] homogeneous color translation."""
    m = _eye(t.shape[0], 4, t.device)
    m[:, :3, 3] = t
    return m


def _scale3d(s):
    m = _eye(s.shape[0], 4, s.device)
    m[:, 0, 0] = s
    m[:, 1, 1] = s
    m[:, 2, 2] = s
    return m


def _rotate3d_around(v, theta):
    """Rotation around the unit axis v (3 floats), batched theta [N]."""
    vx, vy, vz = (float(a) for a in v)
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    rows = [
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c],
    ]
    m = _eye(theta.shape[0], 4, theta.device)
    for i in range(3):
        for j in range(3):
            m[:, i, j] = rows[i][j]
    return m


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers + parameter ranges (reference defaults).

    `bgc()` gives the shipped fashion training config (train.py:292).
    """

    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    @staticmethod
    def bgc():
        return AugmentConfig(
            xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
            brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)


def augment_pipe(images, p, generator, cfg: AugmentConfig,
                 debug_percentile=None):
    """Apply the ADA pipeline to NHWC images with overall probability `p`.

    Args:
        images: [N, H, W, C] float, square; C in {1, 3}.
        p:      the ADA-controlled knob in [0, 1]: a float, or a 0-d tensor
            on the images' device (the train step's, read without a sync).
        generator: torch.Generator on the images' device (all draws).
        cfg:    AugmentConfig; a multiplier of 0 skips its transform.
        debug_percentile: float in [0, 1) -- deterministic parameters
            (reference parity/debug mode).

    Returns augmented images, same shape and dtype.
    """
    n, height, width, channels = images.shape
    dev = images.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    dp = debug_percentile

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def full(shape, value):
        return torch.full(shape, float(value), device=dev)

    def erfinv(v):
        return torch.erfinv(torch.tensor(v, dtype=torch.float32)).item()

    ones = full((n,), 1.0)

    # ---- pixel blitting + geometric: accumulate inverse 2D transform -----
    g_inv = _eye(n, 3, dev)
    used_geom = False

    if cfg.xflip > 0:
        i = torch.floor(uniform(n) * 2)
        i = torch.where(uniform(n) < cfg.xflip * p, i, 0.0)
        if dp is not None:
            i = full((n,), np.floor(dp * 2))
        g_inv = g_inv @ _scale2d(1 / (1 - 2 * i), ones)
        used_geom = True
    if cfg.rotate90 > 0:
        i = torch.floor(uniform(n) * 4)
        i = torch.where(uniform(n) < cfg.rotate90 * p, i, 0.0)
        if dp is not None:
            i = full((n,), np.floor(dp * 4))
        g_inv = g_inv @ _rotate2d(np.pi / 2 * i)
        used_geom = True
    if cfg.xint > 0:
        t = (uniform(n, 2) * 2 - 1) * cfg.xint_max
        t = torch.where(uniform(n, 1) < cfg.xint * p, t, 0.0)
        if dp is not None:
            t = full((n, 2), (dp * 2 - 1) * cfg.xint_max)
        g_inv = g_inv @ _translate2d(-torch.round(t[:, 0] * width),
                                     -torch.round(t[:, 1] * height))
        used_geom = True
    if cfg.scale > 0:
        s = torch.exp2(normal(n) * cfg.scale_std)
        s = torch.where(uniform(n) < cfg.scale * p, s, 1.0)
        if dp is not None:
            s = full((n,), np.exp2(erfinv(dp * 2 - 1) * cfg.scale_std))
        g_inv = g_inv @ _scale2d(1 / s, 1 / s)
        used_geom = True
    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * p, 0, 1))
    if cfg.rotate > 0:
        theta = (uniform(n) * 2 - 1) * np.pi * cfg.rotate_max
        theta = torch.where(uniform(n) < p_rot, theta, 0.0)
        if dp is not None:
            theta = full((n,), (dp * 2 - 1) * np.pi * cfg.rotate_max)
        g_inv = g_inv @ _rotate2d(theta)   # rotate2d_inv(-theta) == rotate2d
        used_geom = True
    if cfg.aniso > 0:
        s = torch.exp2(normal(n) * cfg.aniso_std)
        s = torch.where(uniform(n) < cfg.aniso * p, s, 1.0)
        if dp is not None:
            s = full((n,), np.exp2(erfinv(dp * 2 - 1) * cfg.aniso_std))
        g_inv = g_inv @ _scale2d(1 / s, s)
        used_geom = True
    if cfg.rotate > 0:
        theta = (uniform(n) * 2 - 1) * np.pi * cfg.rotate_max
        theta = torch.where(uniform(n) < p_rot, theta, 0.0)
        if dp is not None:
            theta = full((n,), 0.0)
        g_inv = g_inv @ _rotate2d(theta)
    if cfg.xfrac > 0:
        t = normal(n, 2) * cfg.xfrac_std
        t = torch.where(uniform(n, 1) < cfg.xfrac * p, t, 0.0)
        if dp is not None:
            t = full((n, 2), erfinv(dp * 2 - 1) * cfg.xfrac_std)
        g_inv = g_inv @ _translate2d(-t[:, 0] * width, -t[:, 1] * height)
        used_geom = True

    if used_geom:
        hz_geom = setup_filter(WAVELETS["sym6"]).numpy()
        # Static reflect margin (the data-independent part of the reference
        # margin); the transform's own reach is mirrored analytically.
        m = len(WAVELETS["sym6"]) // 4 * 2
        h2 = w2 = (height + 2 * m) * 2
        half, two = full((n,), 0.5), full((n,), 2.0)
        g = _scale2d(two, two) @ g_inv @ _scale2d(half, half)
        g = _translate2d(-half, -half) @ g @ _translate2d(half, half)
        g = (_scale2d(full((n,), 2.0 / w2), full((n,), 2.0 / h2)) @ g
             @ _scale2d(full((n,), w2 / 2.0), full((n,), h2 / 2.0)))
        # normalized (align_corners=False) matrix -> pixel space
        to_norm = torch.tensor([[2.0 / w2, 0, 1.0 / w2 - 1],
                                [0, 2.0 / h2, 1.0 / h2 - 1],
                                [0, 0, 1]], dtype=torch.float32, device=dev)
        to_pix = torch.tensor([[w2 / 2.0, 0, w2 / 2.0 - 0.5],
                               [0, h2 / 2.0, h2 / 2.0 - 0.5],
                               [0, 0, 1]], dtype=torch.float32, device=dev)
        mat_pix = torch.einsum("ij,njk,kl->nil", to_pix, g, to_norm)
        images = geom_resample_twopass(images.to(torch.bfloat16), mat_pix,
                                       hz_geom, m).to(images.dtype)

    # ---- color transform --------------------------------------------------
    c_mat = _eye(n, 4, dev)
    used_color = False
    v_luma = torch.tensor(np.asarray([1, 1, 1, 0]) / np.sqrt(3),
                          dtype=torch.float32, device=dev)
    eye4 = torch.eye(4, device=dev)

    if cfg.brightness > 0:
        b = normal(n) * cfg.brightness_std
        b = torch.where(uniform(n) < cfg.brightness * p, b, 0.0)
        if dp is not None:
            b = full((n,), erfinv(dp * 2 - 1) * cfg.brightness_std)
        c_mat = _translate3d(torch.stack([b, b, b], dim=1)) @ c_mat
        used_color = True
    if cfg.contrast > 0:
        c = torch.exp2(normal(n) * cfg.contrast_std)
        c = torch.where(uniform(n) < cfg.contrast * p, c, 1.0)
        if dp is not None:
            c = full((n,), np.exp2(erfinv(dp * 2 - 1) * cfg.contrast_std))
        c_mat = _scale3d(c) @ c_mat
        used_color = True
    if cfg.lumaflip > 0:
        i = torch.floor(uniform(n) * 2)
        i = torch.where(uniform(n) < cfg.lumaflip * p, i, 0.0)
        if dp is not None:
            i = full((n,), np.floor(dp * 2))
        house = eye4 - 2 * torch.outer(v_luma, v_luma) * i[:, None, None]
        c_mat = house @ c_mat
        used_color = True
    if cfg.hue > 0 and channels > 1:
        theta = (uniform(n) * 2 - 1) * np.pi * cfg.hue_max
        theta = torch.where(uniform(n) < cfg.hue * p, theta, 0.0)
        if dp is not None:
            theta = full((n,), (dp * 2 - 1) * np.pi * cfg.hue_max)
        c_mat = _rotate3d_around(np.asarray([1, 1, 1]) / np.sqrt(3),
                                 theta) @ c_mat
        used_color = True
    if cfg.saturation > 0 and channels > 1:
        s = torch.exp2(normal(n) * cfg.saturation_std)
        s = torch.where(uniform(n) < cfg.saturation * p, s, 1.0)
        if dp is not None:
            s = full((n,), np.exp2(erfinv(dp * 2 - 1) * cfg.saturation_std))
        vvt = torch.outer(v_luma, v_luma)
        c_mat = (vvt + (eye4 - vvt) * s[:, None, None]) @ c_mat
        used_color = True

    if used_color:
        if channels == 3:
            images = (torch.einsum("nij,nhwj->nhwi",
                                   c_mat[:, :3, :3].to(images.dtype), images)
                      + c_mat[:, None, None, :3, 3].to(images.dtype))
        elif channels == 1:
            cm = c_mat[:, :3, :].mean(dim=1, keepdim=True)
            images = (images * cm[:, :, :3].sum(dim=2)[:, :, None, None]
                      + cm[:, :, 3][:, :, None, None])
        else:
            raise ValueError("augment color transform needs 1 or 3 channels")

    # ---- image-space filtering -------------------------------------------
    if cfg.imgfilter > 0:
        fbank = torch.from_numpy(_make_fbank()).to(dev)
        num_bands = fbank.shape[0]
        expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13,
                                      dtype=torch.float32, device=dev)
        g_gain = torch.ones((n, num_bands), device=dev)
        for i, band_strength in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(normal(n) * cfg.imgfilter_std)
            t_i = torch.where(
                uniform(n) < cfg.imgfilter * p * band_strength, t_i, 1.0)
            if dp is not None:
                t_i = (full((n,), np.exp2(erfinv(dp * 2 - 1)
                                          * cfg.imgfilter_std))
                       if band_strength > 0 else ones)
            t = torch.ones((n, num_bands), device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t.square()).sum(
                dim=-1, keepdim=True))
            g_gain = g_gain * t
        hz_prime = g_gain @ fbank                    # [N, taps]
        taps = hz_prime.shape[1]
        pad = taps // 2
        padded = torch.nn.functional.pad(
            images.permute(0, 3, 1, 2), (pad, pad, pad, pad),
            mode="reflect").permute(0, 2, 3, 1)

        def _axis_filter(x, axis):
            out = 0.0
            length = images.shape[axis]
            for t in range(taps):
                idx = [slice(None)] * 4
                idx[axis] = slice(t, t + length)
                out = out + x[tuple(idx)] * hz_prime[:, t][:, None, None,
                                                            None]
            return out

        tmp = _axis_filter(padded, 2)           # filter W, keeps H padded
        images = _axis_filter(tmp, 1)           # filter H

    # ---- corruptions ------------------------------------------------------
    if cfg.noise > 0:
        sigma = normal(n, 1, 1, 1).abs() * cfg.noise_std
        sigma = torch.where(uniform(n, 1, 1, 1) < cfg.noise * p, sigma, 0.0)
        if dp is not None:
            sigma = full((n, 1, 1, 1), erfinv(dp) * cfg.noise_std)
        images = images + normal(*images.shape) * sigma
    if cfg.cutout > 0:
        size = full((n, 2), cfg.cutout_size)
        size = torch.where(uniform(n, 1) < cfg.cutout * p, size, 0.0)
        center = uniform(n, 2)
        if dp is not None:
            size = full((n, 2), cfg.cutout_size)
            center = full((n, 2), dp)
        cx = torch.arange(width, device=dev)[None, None, :]
        cy = torch.arange(height, device=dev)[None, :, None]
        mask_x = ((cx + 0.5) / width - center[:, 0, None, None]).abs() \
            >= size[:, 0, None, None] / 2
        mask_y = ((cy + 0.5) / height - center[:, 1, None, None]).abs() \
            >= size[:, 1, None, None] / 2
        images = images * (mask_x | mask_y)[..., None].to(images.dtype)

    return images
