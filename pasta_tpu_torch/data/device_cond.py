"""Device-side person conditioning: pose raster, palm/retain masks, skin
median (port of pasta_tpu/data/device_cond.py:153-333).

Same numerics as the JAX package: thick limb segments as point-to-segment
distance fields + joint disks drawn in order, convex-quad half-plane fills
with a separable cv2-anchored dilation, label comparisons for the retain
and garment masks, and an exact binary-search median over uint8 values.
The host-side parameter functions live in data/host.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .pose import KPT_COLORS, LIMB_SEQ

RES = 512

_LIMB_COLORS = np.asarray(KPT_COLORS, np.float32)          # [19, 3]
_JOINT_COLORS = np.asarray(KPT_COLORS[:18], np.float32)    # [18, 3]

GARMENT_SRC_LABELS = (5, 6, 7, 9, 12)  # tops/dresses/pants/skirt sources

_RESIDENT = {}


def resident(name, device, make):
    """The constant `name` on `device`: `make()` (a CPU tensor) copied up
    at the first call for that device, the same tensor at every later
    one. A copy from pageable host memory waits for the device's queue to
    drain, and a CUDA graph cannot capture one, so the device work of a
    batch uploads no constant of its own."""
    key = (name, torch.device(device))
    t = _RESIDENT.get(key)
    if t is None:
        # a normal tensor even when made under inference_mode, so that
        # autograd may save it
        with torch.inference_mode(False):
            t = _RESIDENT.setdefault(key, make().to(device))
    return t


def _grid(h, w, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def draw_pose_device(limb_pts, limb_valid, joint_pts, joint_valid,
                     pose_xlim, res=RES, thickness=5, radius=5):
    """Rasterize OpenPose stick figures. All args batched [B, ...].

    Limbs draw in LIMB_SEQ order (later limbs overwrite), joints overwrite
    limbs. A thick segment is the set of pixels within the calibrated
    distance of the segment; joint disks use the strict (< r^2) test.
    Columns outside `pose_xlim` are zeroed.

    Returns [B, res, res, 3] float32 with uint8 values.
    """
    dev = limb_pts.device
    yy, xx = _grid(res, res, dev)
    canvas = torch.zeros((limb_pts.shape[0], res, res, 3),
                         dtype=torch.float32, device=dev)
    limb_colors = resident("limb_colors", dev,
                           lambda: torch.from_numpy(_LIMB_COLORS))
    joint_colors = resident("joint_colors", dev,
                            lambda: torch.from_numpy(_JOINT_COLORS))

    r_line2 = (thickness / 5.0 * 3.45) ** 2
    for i in range(len(LIMB_SEQ)):
        a = limb_pts[:, i, 0]                      # [B, 2] (x, y)
        b = limb_pts[:, i, 1]
        ab = b - a
        den = torch.clamp((ab * ab).sum(dim=-1), min=1e-12)   # [B]
        px = xx[None] - a[:, 0, None, None]
        py = yy[None] - a[:, 1, None, None]
        t = torch.clamp(
            (px * ab[:, 0, None, None] + py * ab[:, 1, None, None])
            / den[:, None, None], 0.0, 1.0)
        dx = px - t * ab[:, 0, None, None]
        dy = py - t * ab[:, 1, None, None]
        hit = ((dx * dx + dy * dy) <= r_line2) & limb_valid[:, i, None, None]
        canvas = torch.where(hit[..., None], limb_colors[i], canvas)

    r2 = float(radius) ** 2
    for j in range(18):
        c = joint_pts[:, j]                        # [B, 2] (x, y)
        dx = xx[None] - c[:, 0, None, None]
        dy = yy[None] - c[:, 1, None, None]
        hit = ((dx * dx + dy * dy) < r2) & joint_valid[:, j, None, None]
        canvas = torch.where(hit[..., None], joint_colors[j], canvas)

    xcol = torch.arange(res, dtype=torch.int32, device=dev)
    keep = ((xcol[None] >= pose_xlim[:, 0:1])
            & (xcol[None] < pose_xlim[:, 1:2]))   # [B, res]
    return canvas * keep[:, None, :, None]


def dilate_cv(mask, k):
    """k x k ones dilation over NHWC with cv2 anchor semantics: window
    offsets [-(k//2), k-1-k//2]; borders -inf (separable max passes)."""
    pad = k // 2
    x = mask.permute(0, 3, 1, 2)
    x = F.pad(x, (pad, k - 1 - pad, 0, 0), value=-float("inf"))
    x = F.max_pool2d(x, (1, k), stride=1)
    x = F.pad(x, (0, 0, pad, k - 1 - pad), value=-float("inf"))
    x = F.max_pool2d(x, (k, 1), stride=1)
    return x.permute(0, 2, 3, 1)


def _fill_quad_device(quad, res):
    """[B, 4, 2] winding-normalized quad -> [B, res, res] bool fill."""
    yy, xx = _grid(res, res, quad.device)
    inside = torch.ones((quad.shape[0], res, res), dtype=torch.bool,
                        device=quad.device)
    for i in range(4):
        x0 = quad[:, i, 0, None, None]
        y0 = quad[:, i, 1, None, None]
        x1 = quad[:, (i + 1) % 4, 0, None, None]
        y1 = quad[:, (i + 1) % 4, 1, None, None]
        cross = (x1 - x0) * (yy[None] - y0) - (y1 - y0) * (xx[None] - x0)
        inside = inside & (cross >= 0)
    return inside


def palm_mask_device(palm_quads, palm_valid, parsing, res=RES):
    """Hand parsing minus dilated arm rectangles.

    Args:
        palm_quads: [B, 2, 2, 4, 2] from host.palm_device_params.
        palm_valid: [B, 2] bool.
        parsing:    [B, H, W, 1] integer parsing map.

    Returns [B, H, W, 1] float32 {0, 1}.
    """
    p = parsing[..., 0]
    out = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for side, label, (k_up, k_bot) in ((0, 14, (35, 28)), (1, 15, (35, 28))):
        hand = p == label
        up = _fill_quad_device(palm_quads[:, side, 0], res)
        bot = _fill_quad_device(palm_quads[:, side, 1], res)
        up = dilate_cv(up[..., None].float(), k_up)[..., 0] > 0
        bot = dilate_cv(bot[..., None].float(), k_bot)[..., 0] > 0
        out = out | (hand & ~up & ~bot & palm_valid[:, side, None, None])
    return out[..., None].float()


def retain_mask_device(parsing, palm):
    """Shoes + head labels + palm mask (labels disjoint, so the sum is the
    union and stays {0, 1})."""
    m = palm
    for lbl in (18, 19, 1, 2, 4, 13):
        m = m + (parsing == lbl).float()
    return m


def garment_lut_mask(lut, parsing, labels=GARMENT_SRC_LABELS):
    """Per-item label LUT -> mask, as comparisons over the candidate labels
    (only the garment source labels can be nonzero in the LUTs).

    lut: [B, 256], parsing [B, H, W, 1] int. Returns [B, H, W, 1] float32.
    """
    m = torch.zeros(parsing.shape, dtype=torch.float32, device=parsing.device)
    for lbl in labels:
        m = m + (lut[:, lbl].float()[:, None, None, None] * (parsing == lbl))
    return m


def skin_median_device(image, parsing):
    """Per-channel median of nonzero neck+face pixels (np.median semantics:
    mean of the two middle order statistics), [B, 3] float32. Each order
    statistic is found exactly by an 8-step binary search over uint8
    thresholds."""
    p = parsing[..., 0]
    skin = ((p == 10) | (p == 13))[..., None]          # [B, H, W, 1]
    m = skin & (image > 0)                             # [B, H, W, 3]
    n = m.sum(dim=(1, 2)).to(torch.int32)              # [B, 3]
    img = image.to(torch.int32)

    def order_stat(k):
        """Smallest v with count(masked values <= v) >= k+1, per [B, 3]."""
        lo = torch.zeros_like(n)
        hi = torch.full_like(n, 255)
        for _ in range(8):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            cnt = (m & (img <= mid[:, None, None, :])).sum(dim=(1, 2))
            take = cnt >= k + 1
            lo, hi = torch.where(take, lo, mid + 1), torch.where(take, mid, hi)
        return hi.float()

    med = (order_stat(torch.div(n - 1, 2, rounding_mode="floor"))
           + order_stat(torch.div(n, 2, rounding_mode="floor"))) / 2.0
    return torch.where(n > 0, med, torch.zeros_like(med))
