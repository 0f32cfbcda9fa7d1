"""Numpy-only host stage of the serving path and of the device loader.

These functions live in JAX-package modules that import jax at module top
(`pasta_tpu/serving.py`, `pasta_tpu/data/device_warp.py`,
`pasta_tpu/data/device_cond.py`), so the port carries them here unchanged
in behaviour (tests/test_torch_host.py holds them equal to the originals):

  host_prepare                               <- serving.py
  host_matrices_for_pair, paste_tile_layout,
  part_layouts_for_pair (its paste tiles)    <- data/device_warp.py
  pose_device_params, flip_pose_params,
  _winding_normalized, palm_device_params    <- data/device_cond.py

What they use of `pasta_tpu/data/preprocess.py`, `geometry.py` and `pose.py`
is in the port's own modules of the same names beside this one.
"""

from __future__ import annotations

import numpy as np

from . import preprocess as pp
from .geometry import BODY_PARTS, LOWER_PARTS, part_quads, perspective_batch
from .pose import LIMB_SEQ, _rectangle_quad

PASTE_TILE = 256


# ---------------------------------------------------------------------------
# person-conditioning scalars (device_cond.py)

def pose_device_params(keypoints, img_h, img_w, left):
    """Limb/joint raster parameters for one person, padded-canvas coords.

    Mirrors draw_pose: limbs use pre-validation confidences; knee/ankle
    joints hugging the original (unpadded) borders are invalidated
    (confidence 0.01) before their disks draw. MUTATES `keypoints` exactly
    like the host raster so downstream get_crop sees the same validity.

    Args:
        keypoints: [18, 3] (x, y, conf) in ORIGINAL (unpadded) coords.
        img_h, img_w: original image size (canvas is img_h x img_h after
            the symmetric width pad).
        left: left pad added to x by the caller afterwards.

    Returns dict of numpy arrays (see device_cond.draw_pose_device).
    """
    limb_pts = np.zeros((len(LIMB_SEQ), 2, 2), np.float32)
    limb_valid = np.zeros(len(LIMB_SEQ), bool)
    for i, (f1, t1) in enumerate(LIMB_SEQ):
        f, t = f1 - 1, t1 - 1
        if keypoints[f][2] < 0.05 or keypoints[t][2] < 0.05:
            continue
        limb_valid[i] = True
        limb_pts[i, 0] = (int(keypoints[f][0]), int(keypoints[f][1]))
        limb_pts[i, 1] = (int(keypoints[t][0]), int(keypoints[t][1]))

    joint_pts = np.zeros((18, 2), np.float32)
    joint_valid = np.zeros(18, bool)
    for i in range(18):
        if keypoints[i][2] < 0.05:
            continue
        if i in (9, 10, 12, 13):
            if (keypoints[i][0] <= 0 or keypoints[i][1] <= 0
                    or keypoints[i][0] >= img_w - 50
                    or keypoints[i][1] >= img_h - 50):
                keypoints[i][2] = 0.01
                continue
        joint_valid[i] = True
        joint_pts[i] = (int(keypoints[i][0]), int(keypoints[i][1]))

    limb_pts[..., 0] += left
    joint_pts[..., 0] += left
    return dict(
        limb_pts=limb_pts, limb_valid=limb_valid,
        joint_pts=joint_pts, joint_valid=joint_valid,
        pose_xlim=np.asarray([left, left + img_w], np.int32),
    )


def flip_pose_params(params, res):
    """x-flip pose_device_params output on the `res`-wide padded canvas.

    Coordinates mirror; limb/joint identities swap left<->right so the
    raster colors stay side-correct (dataset --mirror xflip)."""
    from .pose import OPENPOSE_FLIP

    swap = {i + 1: OPENPOSE_FLIP[i] + 1 for i in range(18)}  # 1-based
    limb_perm = []
    index_of = {tuple(p): i for i, p in enumerate(LIMB_SEQ)}
    for f1, t1 in LIMB_SEQ:
        limb_perm.append(index_of[(swap[f1], swap[t1])])
    limb_perm = np.asarray(limb_perm)
    joint_perm = np.asarray(OPENPOSE_FLIP)

    limb_pts = np.asarray(params["limb_pts"])[limb_perm].copy()
    limb_valid = np.asarray(params["limb_valid"])[limb_perm].copy()
    limb_pts[..., 0] = np.where(
        limb_valid[:, None], res - 1 - limb_pts[..., 0], limb_pts[..., 0])
    joint_pts = np.asarray(params["joint_pts"])[joint_perm].copy()
    joint_valid = np.asarray(params["joint_valid"])[joint_perm].copy()
    joint_pts[..., 0] = np.where(
        joint_valid, res - 1 - joint_pts[..., 0], joint_pts[..., 0])
    lo, hi = (int(v) for v in np.asarray(params["pose_xlim"]))
    return dict(
        limb_pts=limb_pts, limb_valid=limb_valid,
        joint_pts=joint_pts, joint_valid=joint_valid,
        pose_xlim=np.asarray([res - hi, res - lo], np.int32),
    )


def _winding_normalized(quad):
    """Return the quad with positive shoelace orientation (so the device
    fill can test cross >= 0 on every edge).

    A zero-length limb segment degenerates the rectangle to a point;
    substitute the equivalent axis-aligned bbox quad (pixel centers in
    [floor(min), ceil(max)]), which fills exactly the host's pixel set."""
    x, y = quad[:, 0], quad[:, 1]
    area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    if abs(area2) < 1e-9:
        # +-0.25 keeps the box non-degenerate at integer coords without
        # adding pixel centers (centers are integers)
        x0, x1 = np.floor(x.min()) - 0.25, np.ceil(x.max()) + 0.25
        y0, y1 = np.floor(y.min()) - 0.25, np.ceil(y.max()) + 0.25
        return np.array(
            [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)
    return quad if area2 >= 0 else quad[::-1]


def palm_device_params(keypoints):
    """Palm rectangle corners for both sides, padded coords.

    Returns dict(palm_quads [2, 2, 4, 2] f32, palm_valid [2] bool) with
    side 0 = left (labels 14, keypoints 5/6/7), side 1 = right (15, 2/3/4).
    """
    quads = np.zeros((2, 2, 4, 2), np.float32)
    valid = np.zeros(2, bool)
    for side, idx in enumerate(([5, 6, 7], [2, 3, 4])):
        (s_x, s_y, s_c), (e_x, e_y, e_c), (w_x, w_y, w_c) = keypoints[idx]
        if not (s_c > 0.1 and e_c > 0.1) or not (e_c > 0.1 and w_c > 0.1):
            continue
        valid[side] = True
        quads[side, 0] = _winding_normalized(
            _rectangle_quad(s_x, s_y, e_x, e_y))
        quads[side, 1] = _winding_normalized(
            _rectangle_quad(e_x, e_y, w_x, w_y))
    return dict(palm_quads=quads, palm_valid=valid)


# ---------------------------------------------------------------------------
# homographies and warp layouts (device_warp.py)

def host_matrices_for_pair(upper_cut_kps, lower_cut_kps, paste_kps,
                           patch=128, res=512, return_paste_fwd=False):
    """Solve the per-part homographies on host -> arrays for the device path.

    Returns (upper_cut_m, lower_cut_m, paste_m_inv, part_valid), shapes
    [10,3,3]x3 and [10,3]; with return_paste_fwd also the patch->image
    paste transforms. All ~30 per-pair 8x8 systems go through ONE batched
    solve; cut transforms are solved in the device's dst->src direction.
    """
    n_parts = len(BODY_PARTS)
    qu, vu = part_quads(upper_cut_kps, res, res)
    ql, vl = part_quads(lower_cut_kps, res, res)
    qp, vp = part_quads(paste_kps, res, res)
    dst = np.float32([[0, 0], [0, patch], [patch, patch], [patch, 0]])
    dst_all = np.broadcast_to(dst, (n_parts, 4, 2))

    # Guard degenerate zero quads (invalid parts) from the batched solve:
    # substitute the identity square so the system stays nonsingular.
    ident = np.float32([[0, 0], [0, 1], [1, 1], [1, 0]])
    qu_s = np.where(vu[:, None, None], qu, ident)
    ql_s = np.where(vl[:, None, None], ql, ident)
    qp_s = np.where(vp[:, None, None], qp, ident)

    src = np.concatenate([dst_all, dst_all, qp_s, dst_all], axis=0)
    tgt = np.concatenate([qu_s, ql_s, dst_all, qp_s], axis=0)
    m = perspective_batch(src, tgt).astype(np.float32)
    upper_m = np.where(vu[:, None, None], m[:n_parts], 0.0)
    lower_m = np.where(vl[:, None, None], m[n_parts:2 * n_parts], 0.0)
    paste_inv = np.where(vp[:, None, None], m[2 * n_parts:3 * n_parts], 0.0)
    paste_fwd = np.where(vp[:, None, None], m[3 * n_parts:], 0.0)
    valid = np.stack([vu, vl, vp], axis=1)
    if return_paste_fwd:
        return upper_m, lower_m, paste_inv, valid, paste_fwd
    return upper_m, lower_m, paste_inv, valid


def paste_tile_layout(paste_m_inv_parts, part_valid_paste, res=512,
                      tile=PASTE_TILE, margin=8, patch=128,
                      paste_fwd_parts=None):
    """Host: per-part tile offsets + fit check.

    Returns (offsets [10, 2] int32 (y, x), fits: bool).
    """
    corners = np.array(
        [[0, 0, 1], [0, patch, 1], [patch, patch, 1], [patch, 0, 1]],
        np.float64)
    offsets = np.zeros((len(paste_m_inv_parts), 2), np.int32)
    fits = True
    for i, m in enumerate(paste_m_inv_parts):
        if not part_valid_paste[i]:
            continue
        # The device matrices map image(dst) -> patch(src); the destination
        # quad needs the forward patch -> image direction.
        m_fwd = (np.asarray(paste_fwd_parts[i], np.float64)
                 if paste_fwd_parts is not None
                 else np.linalg.inv(np.asarray(m, np.float64)))
        proj = corners @ m_fwd.T
        xy = proj[:, :2] / np.maximum(np.abs(proj[:, 2:3]), 1e-9) * np.sign(
            proj[:, 2:3])
        x0 = np.clip(np.floor(xy[:, 0].min()) - margin, 0, res)
        x1 = np.clip(np.ceil(xy[:, 0].max()) + margin, 0, res)
        y0 = np.clip(np.floor(xy[:, 1].min()) - margin, 0, res)
        y1 = np.clip(np.ceil(xy[:, 1].max()) + margin, 0, res)
        if (x1 - x0) > tile or (y1 - y0) > tile:
            fits = False
        oy = int(np.clip(y0, 0, res - tile))
        ox = int(np.clip(x0, 0, res - tile))
        offsets[i] = (oy, ox)
    return offsets, fits


def part_layouts_for_pair(pinv, valid, paste_fwd=None):
    """15-slot (upper x10 + lower x5) paste-tile layout.

    Returns (tile_offsets [15, 2] i32, tiles_fit)."""
    tile10, tiles_fit = paste_tile_layout(
        pinv, valid[:, 2], paste_fwd_parts=paste_fwd)
    tile_offsets = np.concatenate([tile10, tile10[list(LOWER_PARTS)]], axis=0)
    return tile_offsets.astype(np.int32), bool(tiles_fit)


# ---------------------------------------------------------------------------
# per-pair host preparation (serving.py)

def host_prepare(person, clothes, mode, use_sleeve_mask=True, cond="host"):
    """Host side: masks, scalars, homographies. Returns a dict of small
    numpy arrays (everything heavy stays un-warped full-res images).

    cond="device" defers the person-conditioning rasters (pose stick
    figure, palm/retain masks, skin median) to the device ingest stage:
    the dict then carries the raw parsing plane and the pose/palm scalar
    params instead of pose/retain_mask/skin_color. Requires `person`
    loaded with pose_raster="device"."""
    assert mode in ("full", "upper", "lower")
    assert cond in ("host", "device")
    if cond == "device" and person.pose_params is None:
        raise ValueError(
            "host_prepare(cond='device') needs load_person("
            "pose_raster='device') records (pose_params missing)")
    person_rt = pp.garment_class_routing(person.parsing)
    clothes_rt = pp.garment_class_routing(clothes.parsing)

    if mode == "full":
        upper_src, lower_src = clothes, clothes
        upper_rt, lower_rt = clothes_rt, clothes_rt
    elif mode == "upper":
        upper_src, lower_src = clothes, person
        upper_rt, lower_rt = clothes_rt, person_rt
    else:
        upper_src, lower_src = person, clothes
        upper_rt, lower_rt = person_rt, clothes_rt

    upper_labels = upper_rt["tops"][0] | upper_rt["dresses"][0]
    lower_labels = lower_rt["skirt"][0] | lower_rt["pants"][0]
    dress_transfer = False
    if mode == "upper" and clothes_rt["dresses"][1] > 0:
        lower_labels = frozenset()
        dress_transfer = True
    if mode == "lower" and person_rt["dresses"][1] > 0:
        lower_labels = frozenset()
        dress_transfer = True

    sleeve_src = person if mode == "lower" else clothes
    sleeve_gp = (sleeve_src.garment_parsing
                 if use_sleeve_mask else None)

    mu, ml, pinv, valid, pfwd = host_matrices_for_pair(
        upper_src.keypoints, lower_src.keypoints, person.keypoints,
        return_paste_fwd=True)
    tile_offsets, tiles_fit = part_layouts_for_pair(pinv, valid, pfwd)

    # Host-side conditioning scalars; the warp-dependent parts of the
    # bound are finished on device. bound[ub:] slice semantics normalized
    # to a start row.
    res = person.parsing.shape[0]
    bound_row = res
    if mode == "upper":
        lower_bbox = pp.bbox_of_labels(lower_src.parsing, lower_labels)
        lhip, rhip = person.keypoints[11], person.keypoints[8]
        ub = None
        if lhip[2] > 0.05 and rhip[2] > 0.05:
            hip_width = np.linalg.norm(lhip[0:2] - rhip[0:2])
            middle_y = (lhip[1] + rhip[1]) / 2
            ub = int(middle_y - (3 * hip_width / 4))
            if lower_bbox is not None:
                ub = min(ub, lower_bbox[1])
        elif lower_bbox is not None:
            ub = lower_bbox[1]
        if ub is not None and not dress_transfer:
            bound_row = ub if ub >= 0 else max(res + ub, 0)
    elif mode == "lower":
        lower_bbox = pp.bbox_of_labels(
            person.parsing,
            person_rt["skirt"][0] | person_rt["pants"][0])
        if lower_bbox is not None:
            bound_row = lower_bbox[1]

    # Lower-garment class label map.
    if mode == "upper":
        pants_n, skirt_n = lower_rt["pants"][1], lower_rt["skirt"][1]
        dress_n = clothes_rt["dresses"][1]
    elif mode == "lower":
        pants_n, skirt_n = lower_rt["pants"][1], lower_rt["skirt"][1]
        dress_n = person_rt["dresses"][1]
    else:
        pants_n, skirt_n, dress_n = (
            clothes_rt["pants"][1], clothes_rt["skirt"][1],
            clothes_rt["dresses"][1])
    if dress_transfer:
        pants_n = skirt_n = 0
    if pants_n > 0:
        cls = 0
    elif skirt_n > 0:
        cls = 1
    elif dress_n > 0:
        cls = 2
    else:
        cls = 1

    common = dict(
        upper_cut_m=mu, lower_cut_m=ml, paste_m_inv=pinv, part_valid=valid,
        image=person.image,
        sleeve_valid=np.asarray(
            1.0 if sleeve_gp is not None else 0.0, np.float32),
        tile_offsets=tile_offsets,
        tiles_fit=np.asarray(tiles_fit),
        dress_transfer=np.asarray(
            0.0 if (mode == "full" and clothes_rt["dresses"][1] > 0)
            else 1.0, np.float32),
    )

    if cond == "device":
        return dict(
            **common,
            parsing=person.parsing.astype(np.uint8, copy=False),
            upper_src_image=upper_src.image,
            lower_src_image=lower_src.image,
            upper_src_parsing=upper_src.parsing.astype(np.uint8, copy=False),
            lower_src_parsing=lower_src.parsing.astype(np.uint8, copy=False),
            upper_lut=pp.label_lut(upper_labels),
            lower_lut=pp.label_lut(lower_labels),
            sleeve_parsing=(
                sleeve_gp.astype(np.uint8, copy=False) if sleeve_gp is not None
                else np.zeros_like(person.parsing, np.uint8)),
            label_cls=np.asarray(cls, np.uint8),
            bound_row=np.asarray(bound_row, np.int32),
            **{k: np.asarray(v) for k, v in person.pose_params.items()},
            **{k: np.asarray(v)
               for k, v in palm_device_params(person.keypoints).items()},
        )

    # Host path: materialize the masks from the routing LUTs and rasterize
    # the conditioning on host; everything big ships as uint8.
    upper_mask = pp.label_lut(upper_labels)[upper_src.parsing]
    lower_mask = pp.label_lut(lower_labels)[lower_src.parsing]
    sleeve = pp.sleeve_mask_from(sleeve_src) if use_sleeve_mask else None
    bound = np.zeros((res, res, 1), np.uint8)
    bound[bound_row:, ...] = 255
    return dict(
        **common,
        upper_img=upper_mask * upper_src.image,
        lower_img=lower_mask * lower_src.image,
        upper_mask=upper_mask * np.uint8(255),
        lower_mask=lower_mask * np.uint8(255),
        sleeve=(sleeve if sleeve is not None
                else np.zeros_like(upper_mask)),
        pose=person.pose_img,
        retain_mask=pp.retain_mask_of(person),
        skin_color=np.asarray(
            pp.skin_median_color(person.image, person.parsing),
            np.float32),
        label_cls=np.full((res, res, 1), cls, np.uint8),
        bound=bound,
    )
