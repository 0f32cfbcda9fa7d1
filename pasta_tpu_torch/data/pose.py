"""OpenPose-18 keypoint tables, the host stick-figure raster and the quad
rasters of the palm masks.

The port's own copy of `pasta_tpu/data/pose.py`, unchanged in behaviour
(tests/test_torch_host.py holds each name equal to its original): the limb
and colour tables, the joint order of the patch geometry, the stick-figure
raster of the host loader with its keypoint-file reader, the half-plane
quad fill, the oriented rectangle around a limb segment, the palm mask
built from them and the left/right swap of an x-flip. Parity targets in the
reference's training/dataset.py: limbseq / kptcolors (:44-52), get_joints
(:815-823), draw_pose_from_cords (:779-813; cv2 5px limb lines and radius-5
joint disks, knees and ankles near the borders invalidated in place),
get_hand_mask / get_palm (:705-775, with training/utils.py:10-75;
pycocotools' polygon fill replaced by a vectorized half-plane
point-in-quad test).
"""

from __future__ import annotations

import json
import math

import cv2
import numpy as np

# Limb connectivity (1-based OpenPose indices) and per-limb/joint colors.
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
KPT_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85], [255, 0, 0],
]

# Joint order used by the patch geometry (dataset.py:1033-1035).
JOINT_ORDER = [
    "cnose", "cneck", "rshoulder", "relbow", "rwrist", "lshoulder",
    "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
    "lankle", "reye", "leye", "rear", "lear",
]


def _disk_coords(cx_row, cy_col, radius, shape):
    """Filled-circle pixel coords, replacing skimage.draw.circle (which the
    reference pins to skimage<=0.18; README.md:16)."""
    h, w = shape[:2]
    r0 = max(int(math.floor(cx_row - radius)), 0)
    r1 = min(int(math.ceil(cx_row + radius)) + 1, h)
    c0 = max(int(math.floor(cy_col - radius)), 0)
    c1 = min(int(math.ceil(cy_col + radius)) + 1, w)
    if r0 >= r1 or c0 >= c1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rr, cc = np.mgrid[r0:r1, c0:c1]
    keep = (rr - cx_row) ** 2 + (cc - cy_col) ** 2 < radius ** 2
    return rr[keep], cc[keep]


def draw_pose(pose_joints, img_size=(512, 320), radius=5, draw_limbs=True):
    """Rasterize an OpenPose skeleton to an RGB uint8 image.

    Mutates `pose_joints` like the reference: knee/ankle joints hugging the
    border get confidence 0.01 (so downstream get_crop treats them invalid).

    Args:
        pose_joints: [18, 3] float array (x, y, confidence). MUTATED.
        img_size:    (H, W).

    Returns:
        (colors [H, W, 3] uint8, pose_joints).
    """
    colors = np.zeros(tuple(img_size) + (3,), dtype=np.uint8)
    if draw_limbs:
        for i, (f1, t1) in enumerate(LIMB_SEQ):
            f, t = f1 - 1, t1 - 1
            if pose_joints[f][2] < 0.05 or pose_joints[t][2] < 0.05:
                continue
            p_from = (int(pose_joints[f][0]), int(pose_joints[f][1]))
            p_to = (int(pose_joints[t][0]), int(pose_joints[t][1]))
            cv2.line(colors, p_from, p_to, KPT_COLORS[i], 5)

    for i, joint in enumerate(pose_joints):
        if pose_joints[i][2] < 0.05:
            continue
        if i in (9, 10, 12, 13):  # knees/ankles near borders -> invalidate
            if (
                pose_joints[i][0] <= 0
                or pose_joints[i][1] <= 0
                or pose_joints[i][0] >= img_size[1] - 50
                or pose_joints[i][1] >= img_size[0] - 50
            ):
                pose_joints[i][2] = 0.01
                continue
        rr, cc = _disk_coords(int(joint[1]), int(joint[0]), radius, img_size)
        colors[rr, cc] = KPT_COLORS[i]
    return colors, pose_joints


def load_keypoints(path, img_size=(512, 320)):
    """Load an OpenPose JSON (path or file-like) and rasterize the skeleton.

    Returns (pose_img [H, W, 3] uint8, keypoints [18, 3]).
    """
    if hasattr(path, "read"):
        data = json.load(path)
    else:
        with open(path, "r") as f:
            data = json.load(f)
    if len(data["people"]) == 0:
        keypoints = np.zeros((18, 3))
    else:
        keypoints = np.array(
            data["people"][0]["pose_keypoints_2d"]).reshape(-1, 3)
    pose_img, keypoints = draw_pose(keypoints, img_size)
    return pose_img, keypoints


def _fill_quad(quad_xy, shape):
    """Rasterize a convex quad given as [(x, y)] * 4 in winding order.

    Replaces the reference's pycocotools frPyObjects/merge/decode path
    (training/utils.py:10-15). COCO RLE uses a half-open polygon fill; a
    half-plane test agrees except on boundary pixels -- immaterial here since
    every consumer dilates by >= 20px afterwards.
    """
    h, w = shape
    xs = quad_xy[:, 0]
    ys = quad_xy[:, 1]
    c0 = max(int(np.floor(xs.min())), 0)
    c1 = min(int(np.ceil(xs.max())) + 1, w)
    r0 = max(int(np.floor(ys.min())), 0)
    r1 = min(int(np.ceil(ys.max())) + 1, h)
    mask = np.zeros((h, w, 1), np.float32)
    if r0 >= r1 or c0 >= c1:
        return mask
    rr, cc = np.mgrid[r0:r1, c0:c1]
    inside = np.ones(rr.shape, bool)
    sign = 0.0
    for i in range(4):
        x0, y0 = quad_xy[i]
        x1, y1 = quad_xy[(i + 1) % 4]
        cross = (x1 - x0) * (rr - y0) - (y1 - y0) * (cc - x0)
        if sign == 0.0 and np.any(cross != 0):
            sign = 1.0 if cross.mean() >= 0 else -1.0
        inside &= (cross * sign) >= 0
    mask[r0:r1, c0:c1, 0] = inside.astype(np.float32)
    return mask


def _rectangle_quad(a, b, c, d):
    """Oriented rectangle corners around the segment (a,b)->(c,d), reference
    get_rectangle_mask (dataset.py:705-729) corner/winding selection."""
    x1, y1 = a + (b - d) / 4, b + (c - a) / 4
    x2, y2 = a - (b - d) / 4, b - (c - a) / 4
    x3, y3 = c + (b - d) / 4, d + (c - a) / 4
    x4, y4 = c - (b - d) / 4, d - (c - a) / 4

    v0 = np.array([c - a, d - b], np.float64)
    v1 = np.array([x3 - x1, y3 - y1], np.float64)
    v2 = np.array([x4 - x1, y4 - y1], np.float64)

    def _cos(u, v):
        den = np.linalg.norm(u) * np.linalg.norm(v)
        return float(u @ v / den) if den > 0 else 0.0

    if _cos(v0, v1) < _cos(v0, v2):
        return np.array([[x1, y1], [x2, y2], [x3, y3], [x4, y4]], np.float64)
    return np.array([[x1, y1], [x2, y2], [x4, y4], [x3, y3]], np.float64)


def _dilated_rect_mask(a, b, c, d, img_h, img_w, k):
    """Bool mask of the dilated (k x k ones) oriented rectangle.

    Equivalent to the reference's full-canvas rasterize + cv2.dilate
    (dataset.py:732-751) but computed only inside the rectangle's padded
    bounding box -- the canvas outside is identically zero, so dilation
    cannot reach past bbox + k//2."""
    quad = _rectangle_quad(a, b, c, d)
    pad = k  # k//2 margin on each side would do; k is safely larger
    c0 = max(int(np.floor(quad[:, 0].min())) - pad, 0)
    c1 = min(int(np.ceil(quad[:, 0].max())) + 1 + pad, img_w)
    r0 = max(int(np.floor(quad[:, 1].min())) - pad, 0)
    r1 = min(int(np.ceil(quad[:, 1].max())) + 1 + pad, img_h)
    out = np.zeros((img_h, img_w), bool)
    if r0 >= r1 or c0 >= c1:
        return out
    local = _fill_quad(quad - np.array([[c0, r0]], np.float64),
                       (r1 - r0, c1 - c0))[..., 0]
    roi = cv2.dilate((local > 0).astype(np.uint8),
                     np.ones((k, k), np.uint8), iterations=1)
    out[r0:r1, c0:c1] = roi > 0
    return out


def _palm_side(keypoints3, hand_bool, img_h, img_w):
    """Palm pixels for one side: hand parsing minus the dilated upper-arm
    and forearm rectangles (reference get_hand_mask + get_palm_mask,
    dataset.py:732-759). Missing shoulder/elbow (resp. elbow/wrist)
    confidence means the reference's all-ones region swallows the whole
    hand -> empty palm."""
    s_x, s_y, s_c = keypoints3[0]
    e_x, e_y, e_c = keypoints3[1]
    w_x, w_y, w_c = keypoints3[2]
    if not (s_c > 0.1 and e_c > 0.1) or not (e_c > 0.1 and w_c > 0.1):
        return np.zeros((img_h, img_w), bool)
    up = _dilated_rect_mask(s_x, s_y, e_x, e_y, img_h, img_w, 35)
    bottom = _dilated_rect_mask(e_x, e_y, w_x, w_y, img_h, img_w, 28)
    return hand_bool & ~up & ~bottom


def get_palm_mask(keypoints, parsing):
    """Palm region: hand parsing labels (14/15) minus dilated arm rectangles.

    Reference get_palm (dataset.py:761-775).

    Args:
        keypoints: [18, 3] in padded-image coordinates.
        parsing:   [H, W, 1] integer parsing map.

    Returns:
        [H, W, 1] uint8 mask.
    """
    img_h, img_w = parsing.shape[:2]
    p2 = parsing[..., 0]
    left = _palm_side(keypoints[[5, 6, 7], :], p2 == 14, img_h, img_w)
    right = _palm_side(keypoints[[2, 3, 4], :], p2 == 15, img_h, img_w)
    return (left | right).astype(np.uint8)[..., None]


# OpenPose-18 left/right joint swap (0-based): shoulders/elbows/wrists,
# hips/knees/ankles, eyes, ears. Used by the dataset --mirror xflip.
OPENPOSE_FLIP = [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]


def flip_keypoints(keypoints, width):
    """x-flip [18, 3] keypoints on a `width`-wide canvas, swapping L/R
    joints. Invalid joints (conf < 0.05) keep their coordinates."""
    kps = np.asarray(keypoints)[OPENPOSE_FLIP].copy()
    valid = kps[:, 2] >= 0.05
    kps[valid, 0] = width - 1 - kps[valid, 0]
    return kps
