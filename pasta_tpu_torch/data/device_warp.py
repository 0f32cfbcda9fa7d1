"""On-device patch geometry: batched perspective warps, erosion, compositing
(port of pasta_tpu/data/device_warp.py).

Semantics match cv2 defaults used by the reference:
  warpPerspective -- bilinear, BORDER_CONSTANT(0), pixel centers at integer
      coordinates, dst->src mapping via the inverse matrix.
  erode (k x k ones) -- window minimum; out-of-image treated as +inf.

One warp, the pointwise bilinear gather (warp_perspective_multi), which
is what the JAX package's `warp_impl="auto"` resolves to off its TPU. The
host layout helpers live in data/host.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_cond import dilate_cv, resident
from .geometry import BODY_PARTS, LOWER_PARTS, SLEEVE_PARTS
from .host import PASTE_TILE


def _src_coords(m, out_h, out_w):
    """dst pixel grid -> source (x, y) via [..., 3, 3] dst->src homographies,
    with explicit fp32 multiply-adds. Returns (sx, sy) [..., out_h, out_w]."""
    dev = m.device
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    m = m.float()[..., None, None]
    sx_n = m[..., 0, 0, :, :] * gx + m[..., 0, 1, :, :] * gy + m[..., 0, 2, :, :]
    sy_n = m[..., 1, 0, :, :] * gx + m[..., 1, 1, :, :] * gy + m[..., 1, 2, :, :]
    denom = m[..., 2, 0, :, :] * gx + m[..., 2, 1, :, :] * gy + m[..., 2, 2, :, :]
    safe = torch.where(denom.abs() < 1e-12,
                       torch.full_like(denom, 1e-12), denom)
    return sx_n / safe, sy_n / safe


def _bilinear(sx, sy, h, w, gather):
    """cv2-style bilinear sampling; `gather(yi, xi)` reads clamped integer
    coordinates, and taps outside the source read zero."""
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(yc, xc):
        inside = ((xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1))[..., None]
        xi = torch.clamp(xc, 0, w - 1).long()
        yi = torch.clamp(yc, 0, h - 1).long()
        vals = gather(yi, xi)
        return torch.where(inside, vals, torch.zeros_like(vals))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def warp_perspective(img, m_dst_to_src, out_h, out_w):
    """Warp NHWC images by per-sample dst->src homographies [N, 3, 3].

    Returns [N, out_h, out_w, C]; zero outside the source.
    """
    n, h, w, _ = img.shape
    sx, sy = _src_coords(m_dst_to_src, out_h, out_w)
    bidx = torch.arange(n, device=img.device)[:, None, None]
    return _bilinear(sx, sy, h, w, lambda yi, xi: img[bidx, yi, xi])


def warp_perspective_multi(src_stack, src_idx, m_dst_to_src, out_h, out_w):
    """Warp P parts from a stack of source images in one gather.

    Args:
        src_stack: [B, S, H, W, C] candidate source images.
        src_idx:   [P] int -- which source each part samples.
        m_dst_to_src: [B, P, 3, 3].

    Returns [B, P, out_h, out_w, C]; zero outside the source.
    """
    b, _, h, w, _ = src_stack.shape
    sx, sy = _src_coords(m_dst_to_src, out_h, out_w)
    bidx = torch.arange(b, device=src_stack.device)[:, None, None, None]
    src_idx = np.asarray(src_idx)
    sel = resident(("src_idx",) + tuple(src_idx.tolist()), src_stack.device,
                   lambda: torch.as_tensor(src_idx))
    sel = sel[None, :, None, None]
    return _bilinear(sx, sy, h, w,
                     lambda yi, xi: src_stack[bidx, sel, yi, xi])


def _lower(x):
    """x's LOWER_PARTS rows along dim 1, through an index kept on x's
    device (indexing by the tuple would copy one up at every call)."""
    idx = resident("lower_parts", x.device,
                   lambda: torch.tensor(LOWER_PARTS))
    return x.index_select(1, idx)


def erode(mask, k):
    """k x k window minimum over NHWC; window offsets [-(k//2), k-1-k//2],
    borders treated as +inf (cv2): the dilation of the negated mask."""
    return -dilate_cv(-mask, k)


# Warped-mask interior threshold: bilinear-warped constants can be 1 ulp
# off 255, and erosion's window-min propagates it.
MASK_THRESH = 254.5


def resolve_warp_impl(impl):
    """'auto' and 'gather' -> 'gather', the port's one warp; any other name
    raises."""
    if impl not in ("auto", "gather"):
        raise ValueError(
            f"warp_impl {impl!r}: the port's one warp is the gather "
            "('auto' or 'gather'); the matmul warps stay in pasta_tpu only")
    return "gather"


def _cut_src_stack(upper_img, lower_img, upper_mask, lower_mask,
                   sleeve_mask, sleeve_valid):
    """[B, 3, H, W, 4] cut-warp sources: 0 = non-sleeve-routed upper,
    1 = sleeve-routed upper, 2 = lower; image (3ch) + {0,255} mask (1ch).

    sleeve_valid [B] (or None = all valid): False reproduces a host
    sleeve_mask=None (garment unrouted: both sources see the garment)."""
    if sleeve_valid is None:
        eff = sleeve_mask
        routed = None
    else:
        sv = sleeve_valid.float()[:, None, None, None]
        eff = sleeve_mask * sv
        routed = sv
    nonsleeve = torch.cat([upper_img * (1 - eff), upper_mask * (1 - eff)], -1)
    sleeve_src = torch.cat([upper_img * eff, upper_mask * eff], -1)
    if routed is not None:
        full = torch.cat([upper_img, upper_mask], -1)
        sleeve_src = routed * sleeve_src + (1 - routed) * full
    lower_src = torch.cat([lower_img, lower_mask], -1)
    return torch.stack([nonsleeve, sleeve_src, lower_src], dim=1)


def _cuts(upper_img, lower_img, upper_mask, lower_mask, sleeve_mask,
          upper_cut_m, lower_cut_m, part_valid, sleeve_valid, patch):
    """All 15 cut warps (10 upper parts + 5 lower) as one multi-part warp.
    Returns (cuts [B, 15, p, p, 4], cut_valid [B, 15])."""
    n_parts = len(BODY_PARTS)
    src_stack = _cut_src_stack(upper_img, lower_img, upper_mask,
                               lower_mask, sleeve_mask, sleeve_valid)
    cut_src_idx = np.array(
        [1 if i in SLEEVE_PARTS else 0 for i in range(n_parts)]
        + [2] * len(LOWER_PARTS))
    cut_m = torch.cat([upper_cut_m, _lower(lower_cut_m)], dim=1)
    cut_valid = torch.cat(
        [part_valid[:, :, 0], _lower(part_valid)[:, :, 1]], dim=1).float()
    cuts = warp_perspective_multi(src_stack, cut_src_idx, cut_m, patch, patch)
    return cuts * cut_valid[:, :, None, None, None], cut_valid


def _paste_valid(part_valid):
    return torch.cat([part_valid[:, :, 2], _lower(part_valid)[:, :, 2]],
                     dim=1).float()


def _norm_outputs(cuts, denorm_upper, denorm_lower, denorm_upper_wo_sleeve):
    n_parts = len(BODY_PARTS)
    n_all = cuts.shape[1]
    out = dict(
        norm_img=torch.cat([cuts[:, i, ..., 0:3] for i in range(n_parts)], -1),
        norm_img_lower=torch.cat(
            [cuts[:, i, ..., 0:3] for i in range(n_parts, n_all)], -1),
        norm_clothes_masks=torch.cat(
            [cuts[:, i, ..., 3:4] for i in range(n_parts)], -1),
        norm_clothes_masks_lower=torch.cat(
            [cuts[:, i, ..., 3:4] for i in range(n_parts, n_all)], -1),
        denorm_upper_img=denorm_upper,
        denorm_lower_img=denorm_lower,
    )
    if denorm_upper_wo_sleeve is not None:
        out["denorm_upper_img_wo_sleeve"] = denorm_upper_wo_sleeve
    return out


def normalize_patches_device(
    upper_img, lower_img, upper_mask, lower_mask, sleeve_mask,
    upper_cut_m, lower_cut_m, paste_m_inv, part_valid,
    patch=128, erode_k=5, track_wo_sleeve=False, sleeve_valid=None,
):
    """Batched patch normalize/denormalize chain (full-canvas paste).

    Inputs: upper/lower_img [B, H, W, 3] float; upper/lower_mask
    [B, H, W, 1] in {0, 255}; sleeve_mask [B, H, W, 1] in {0, 1};
    upper/lower_cut_m and paste_m_inv [B, 10, 3, 3]; part_valid [B, 10, 3].

    Returns dict with norm_img [B,128,128,30], norm_img_lower
    [B,128,128,15], denorm_upper_img / denorm_lower_img [B,H,W,3] and the
    patch masks.
    """
    b, h, w, _ = upper_img.shape
    n_parts = len(BODY_PARTS)
    cuts, cut_valid = _cuts(upper_img, lower_img, upper_mask, lower_mask,
                            sleeve_mask, upper_cut_m, lower_cut_m,
                            part_valid, sleeve_valid, patch)

    paste_m = torch.cat([paste_m_inv, _lower(paste_m_inv)], dim=1)
    paste_valid = _paste_valid(part_valid)
    pasted = warp_perspective_multi(
        cuts, np.arange(n_parts + len(LOWER_PARTS)), paste_m, h, w)
    d_imgs = pasted[..., 0:3]
    d_masks = pasted[..., 3:4]
    d_masks = (erode(d_masks.reshape(-1, h, w, 1), erode_k)
               .reshape(d_masks.shape) >= MASK_THRESH).float()
    d_masks = d_masks * (cut_valid * paste_valid)[:, :, None, None, None]

    # sequential composite (later parts overwrite)
    denorm_upper = torch.zeros_like(upper_img)
    denorm_upper_wo_sleeve = torch.zeros_like(upper_img)
    denorm_lower = torch.zeros_like(upper_img)
    for ii in range(n_parts):
        m = d_masks[:, ii]
        denorm_upper = d_imgs[:, ii] * m + denorm_upper * (1 - m)
        if track_wo_sleeve and ii not in SLEEVE_PARTS:
            denorm_upper_wo_sleeve = (d_imgs[:, ii] * m
                                      + denorm_upper_wo_sleeve * (1 - m))
    for jj in range(len(LOWER_PARTS)):
        m = d_masks[:, n_parts + jj]
        denorm_lower = d_imgs[:, n_parts + jj] * m + denorm_lower * (1 - m)
    return _norm_outputs(cuts, denorm_upper, denorm_lower,
                         denorm_upper_wo_sleeve if track_wo_sleeve else None)


def normalize_patches_device_tiled(
    upper_img, lower_img, upper_mask, lower_mask, sleeve_mask,
    upper_cut_m, lower_cut_m, paste_m_inv, part_valid, tile_offsets,
    patch=128, erode_k=5, track_wo_sleeve=False, tile=PASTE_TILE,
    sleeve_valid=None,
):
    """Tiled-paste variant: each part warps into a fixed tile around its
    destination quad. tile_offsets: [B, 15, 2] int (y, x) tile origins from
    host.paste_tile_layout; callers must have checked that every quad fits.
    """
    b, h, w, _ = upper_img.shape
    n_parts = len(BODY_PARTS)
    n_all = n_parts + len(LOWER_PARTS)
    dev = upper_img.device
    cuts, cut_valid = _cuts(upper_img, lower_img, upper_mask, lower_mask,
                            sleeve_mask, upper_cut_m, lower_cut_m,
                            part_valid, sleeve_valid, patch)

    # Fold the tile translation into the dst->src matrices:
    # dst = t + off  =>  m_tile = m @ T(off).
    paste_m = torch.cat([paste_m_inv, _lower(paste_m_inv)], dim=1)
    off = tile_offsets.float()
    t_off = torch.eye(3, device=dev).repeat(b, n_all, 1, 1)
    t_off[:, :, 0, 2] = off[:, :, 1]  # x
    t_off[:, :, 1, 2] = off[:, :, 0]  # y
    paste_m_tile = paste_m.float() @ t_off
    paste_valid = _paste_valid(part_valid)

    pasted = warp_perspective_multi(cuts, np.arange(n_all), paste_m_tile,
                                    tile, tile)          # [B, 15, T, T, 4]
    t_imgs = pasted[..., 0:3]
    t_masks = pasted[..., 3:4]
    t_masks = (erode(t_masks.reshape(-1, tile, tile, 1), erode_k)
               .reshape(t_masks.shape) >= MASK_THRESH).float()
    t_masks = t_masks * (cut_valid * paste_valid)[:, :, None, None, None]

    bidx = torch.arange(b, device=dev)[:, None, None]
    span = torch.arange(tile, device=dev)
    offs = tile_offsets.long()

    def composite(canvas, k):
        """Blend part k's tile into its window of `canvas`, in place (the
        canvases are this function's own)."""
        rows = (offs[:, k, 0, None] + span)[:, :, None]     # [B, T, 1]
        cols = (offs[:, k, 1, None] + span)[:, None, :]     # [B, 1, T]
        region = canvas[bidx, rows, cols]                   # [B, T, T, 3]
        m = t_masks[:, k]
        canvas[bidx, rows, cols] = t_imgs[:, k] * m + region * (1 - m)
        return canvas

    denorm_upper = torch.zeros_like(upper_img)
    denorm_upper_wo_sleeve = torch.zeros_like(upper_img)
    denorm_lower = torch.zeros_like(upper_img)
    for ii in range(n_parts):
        denorm_upper = composite(denorm_upper, ii)
        if track_wo_sleeve and ii not in SLEEVE_PARTS:
            denorm_upper_wo_sleeve = composite(denorm_upper_wo_sleeve, ii)
    for k in range(n_parts, n_all):
        denorm_lower = composite(denorm_lower, k)
    return _norm_outputs(cuts, denorm_upper, denorm_lower,
                         denorm_upper_wo_sleeve if track_wo_sleeve else None)


def mirror_sleeves_device(norm):
    """Copy a present sleeve patch (mirrored) onto a missing one."""
    imgs = norm["norm_img"]
    masks = norm["norm_clothes_masks"]
    out_imgs = [imgs[..., i * 3:(i + 1) * 3] for i in range(10)]
    out_masks = [masks[..., i:i + 1] for i in range(10)]
    for a, b in [(2, 4), (3, 5)]:
        sum_a = out_masks[a].sum(dim=(1, 2, 3), keepdim=True)
        sum_b = out_masks[b].sum(dim=(1, 2, 3), keepdim=True)
        mirror_a = (sum_a == 0) & (sum_b > 0)
        mirror_b = (sum_b == 0) & (sum_a > 0)
        new_a = torch.where(mirror_a, out_imgs[b].flip(2), out_imgs[a])
        new_b = torch.where(mirror_b, out_imgs[a].flip(2), out_imgs[b])
        ma = torch.where(mirror_a, out_masks[b].flip(2), out_masks[a])
        mb = torch.where(mirror_b, out_masks[a].flip(2), out_masks[b])
        out_imgs[a], out_imgs[b] = new_a, new_b
        out_masks[a], out_masks[b] = ma, mb
    norm["norm_img"] = torch.cat(out_imgs, -1)
    norm["norm_clothes_masks"] = torch.cat(out_masks, -1)
    return norm


def zero_conflicts_device(norm):
    """Zero kept-stream torso/hip patches under transferred-garment patches
    (upper/lower modes)."""
    masks = norm["norm_clothes_masks"]
    imgs_l = norm["norm_img_lower"]
    masks_l = norm["norm_clothes_masks_lower"]
    img_parts = [imgs_l[..., i * 3:(i + 1) * 3] for i in range(5)]
    mask_parts = [masks_l[..., i:i + 1] for i in range(5)]
    for lower_idx, upper_idx in [(0, 0), (1, 6), (3, 8)]:
        occupied = (masks[..., upper_idx:upper_idx + 1] > 0).float()
        img_parts[lower_idx] = img_parts[lower_idx] * (1 - occupied)
        mask_parts[lower_idx] = mask_parts[lower_idx] * (1 - occupied)
    norm["norm_img_lower"] = torch.cat(img_parts, -1)
    norm["norm_clothes_masks_lower"] = torch.cat(mask_parts, -1)
    return norm


def bound_from_mask_top(mask):
    """Rows at/under the mask's topmost nonzero row, {0, 255}; an all-zero
    mask gives zeros."""
    b, h, w = mask.shape[0], mask.shape[1], mask.shape[2]
    present = (mask > 0).any(dim=3).any(dim=2)                 # [B, H]
    row_idx = torch.arange(h, device=mask.device)
    top = torch.where(present, row_idx[None, :],
                      torch.full_like(row_idx, h)[None, :]).amin(dim=1)
    nonempty = present.any(dim=1)
    bound = (row_idx[None, :] >= top[:, None]) & nonempty[:, None]
    bound = bound.float()[:, :, None, None] * 255.0
    return bound.expand(b, h, w, 1)


def zero_bound_above_mask_bottom(bound, mask):
    """Zero bound rows above the mask's bottommost nonzero row; an empty
    mask leaves the bound as it is."""
    h = mask.shape[1]
    present = (mask > 0).any(dim=3).any(dim=2)
    row_idx = torch.arange(h, device=mask.device)
    bottom = torch.where(present, row_idx[None, :],
                         torch.full_like(row_idx, -1)[None, :]).amax(dim=1)
    nonempty = present.any(dim=1)
    keep = (row_idx[None, :] >= bottom[:, None]) | ~nonempty[:, None]
    return bound * keep.float()[:, :, None, None]
