"""Keypoint-driven patch geometry: body-part quads and homographies.

The port's own copy of `pasta_tpu/data/geometry.py`, unchanged in behaviour
(tests/test_torch_host.py holds each name equal to its original): the 10
body parts, their source quads with the keypoint fallback chains, and the
8x8 DLT solve of the perspective transforms that cut garment patches to
128^2 and paste them back -- batched for the device path's host stage
(`perspective_batch`, `part_quads`), one part at a time for the host
loader's cv2 warps (`get_perspective_transform`, `get_crop_matrices`).
Parity target: UvitonDataset.get_crop (the reference's
training/dataset.py:828-997).
"""

from __future__ import annotations

import numpy as np

from .pose import JOINT_ORDER

# The 10 body-part keypoint groups (dataset.py:1020-1030).
BODY_PARTS = [
    ["rshoulder", "rhip", "lhip", "lshoulder"],   # 0 torso
    ["lshoulder", "rshoulder", "cnose"],          # 1 head
    ["lshoulder", "lelbow"],                      # 2 left upper arm
    ["lelbow", "lwrist"],                         # 3 left forearm
    ["rshoulder", "relbow"],                      # 4 right upper arm
    ["relbow", "rwrist"],                         # 5 right forearm
    ["lhip", "lknee"],                            # 6 left thigh
    ["lknee", "lankle"],                          # 7 left shin
    ["rhip", "rknee"],                            # 8 right thigh
    ["rknee", "rankle"],                          # 9 right shin
]

# Parts whose patches route through the sleeve mask (arms).
SLEEVE_PARTS = (2, 3, 4, 5)
# Parts that also carry the lower garment (torso + legs).
LOWER_PARTS = (0, 6, 7, 8, 9)


def get_perspective_transform(src, dst):
    """3x3 homography mapping 4 src points to 4 dst points.

    Same math as cv2.getPerspectiveTransform: solve the 8x8 linear system
    for [a,b,c,d,e,f,g,h] with i=1.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((8, 8), np.float64)
    rhs = np.zeros(8, np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        rhs[2 * i] = u
        rhs[2 * i + 1] = v
    coeffs = np.linalg.solve(a, rhs)
    m = np.append(coeffs, 1.0).reshape(3, 3)
    return m.astype(np.float64)


def _valid(confidences):
    return bool((np.asarray(confidences) >= 0.1).all())


def _part_quad(joints, bpart, o_w, o_h, ar):
    """Source quad (4 points, [d?,a,b,c] order per reference) for a part,
    or None when keypoints are insufficient.

    Port of get_crop's fallback chains + quad construction
    (dataset.py:828-990). `joints` is [18,3] (x, y, conf) in padded coords.
    """
    order = JOINT_ORDER
    indices = [order.index(b) for b in bpart]
    part_src = np.float32(joints[indices][:, :2])

    if not _valid(joints[indices][:, 2]):
        fallbacks = {
            ("lhip", "lknee"): ["lhip"],
            ("rhip", "rknee"): ["rhip"],
            ("lknee", "lankle"): ["lknee"],
            ("rknee", "rankle"): ["rknee"],
            ("lshoulder", "rshoulder", "cnose"): ["lshoulder", "rshoulder", "rshoulder"],
        }
        key = tuple(bpart)
        if key in fallbacks:
            bpart = fallbacks[key]
            indices = [order.index(b) for b in bpart]
            part_src = np.float32(joints[indices][:, :2])
        if not _valid(joints[indices][:, 2]):
            return None

    if part_src.shape[0] == 1:
        # Single-hip/knee fallback: extrapolate along the limb direction by a
        # torso-length fraction (dataset.py:858-915).
        torso_indices = [order.index(b) for b in ["lhip", "rhip", "cneck"]]
        if not _valid(joints[torso_indices][:, 2]):
            return None
        a = part_src[0]
        invalid_label = {
            "lhip": "lknee", "rhip": "rknee",
            "lknee": "lankle", "rknee": "rankle",
        }[bpart[0]]
        invalid_joint = joints[order.index(invalid_label)]
        part_torso = np.float32(joints[torso_indices][:, :2])
        torso_length = (
            np.linalg.norm(part_torso[2] - part_torso[1])
            + np.linalg.norm(part_torso[2] - part_torso[0])
        ) / 2
        frac = 0.85 if "hip" in bpart[0] else 0.80
        if invalid_joint[2] > 0:
            direction = (invalid_joint[0:2] - a) / np.linalg.norm(a - invalid_joint[0:2])
            b = a + torso_length * direction * frac
        else:
            b = np.float32([a[0], a[1] + torso_length * frac])
        part_src = np.float32([a, b])

    def in_bounds(p):
        return 0 < p[0] < o_w and 0 < p[1] < o_h

    if part_src.shape[0] == 4:
        # Torso: widen hips by 1/4 and shoulders by 1/5 when in-bounds.
        hip_seg = (part_src[2] - part_src[1]) / 4
        if in_bounds(part_src[1] - hip_seg):
            part_src[1] = part_src[1] - hip_seg
        if in_bounds(part_src[2] + hip_seg):
            part_src[2] = part_src[2] + hip_seg
        shoulder_seg = (part_src[3] - part_src[0]) / 5
        if in_bounds(part_src[0] - shoulder_seg):
            part_src[0] = part_src[0] - shoulder_seg
        if in_bounds(part_src[3] + shoulder_seg):
            part_src[3] = part_src[3] + shoulder_seg
        return np.float32(part_src)

    if part_src.shape[0] == 3:
        # Head box from the shoulder line + upward normal (dataset.py:937-962).
        shoulder_seg = (part_src[0] - part_src[1]) / 5
        if in_bounds(part_src[1] - shoulder_seg):
            part_src[1] = part_src[1] - shoulder_seg
        if in_bounds(part_src[0] + shoulder_seg):
            part_src[0] = part_src[0] + shoulder_seg
        segment = part_src[1] - part_src[0]
        normal = np.array([-segment[1], segment[0]], np.float32)
        if normal[1] > 0.0:
            normal = -normal
        a = part_src[0] + normal
        b = part_src[0]
        c = part_src[1]
        d = part_src[1] + normal
        part_height = (c[1] + b[1]) / 2 - (a[1] + d[1]) / 2
        a[1] += part_height / 2
        d[1] += part_height / 2
        return np.float32([d, c, b, a])

    # Two-point limb: oriented rectangle of half-width ar/2, with per-side
    # asymmetric widening (dataset.py:963-990).
    assert part_src.shape[0] == 2
    segment = part_src[1] - part_src[0]
    normal = np.array([-segment[1], segment[0]], np.float32)
    alpha = ar / 2.0
    a = part_src[0] + alpha * normal
    b = part_src[0] - alpha * normal
    c = part_src[1] - alpha * normal
    d = part_src[1] + alpha * normal
    if "rhip" in bpart or "rknee" in bpart:
        a = a + alpha * normal
        d = d + alpha * normal
    if "lhip" in bpart or "lknee" in bpart:
        b = b - alpha * normal
        c = c - alpha * normal
    if "relbow" in bpart or "rwrist" in bpart:
        a = a + alpha * normal * 0.45
        d = d + alpha * normal * 0.45
        b = b - alpha * normal * 0.1
        c = c - alpha * normal * 0.1
    if "lelbow" in bpart or "lwrist" in bpart:
        a = a + alpha * normal * 0.1
        d = d + alpha * normal * 0.1
        b = b - alpha * normal * 0.45
        c = c - alpha * normal * 0.45
    return np.float32([a, d, c, b])


def perspective_batch(src, dst):
    """Batched perspective transform (cv2.getPerspectiveTransform's 8x8
    system with i = 1): src/dst [K, 4, 2] -> [K, 3, 3].

    One stacked LAPACK solve instead of K sequential 8x8 solves — the
    host-prep profile showed ~30 homography solves per pair dominated by
    per-call numpy overhead."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    k = src.shape[0]
    a = np.zeros((k, 8, 8), np.float64)
    rhs = dst.reshape(k, 8)
    x, y = src[:, :, 0], src[:, :, 1]
    u, v = dst[:, :, 0], dst[:, :, 1]
    ones = np.ones_like(x)
    a[:, 0::2, 0] = x
    a[:, 0::2, 1] = y
    a[:, 0::2, 2] = ones
    a[:, 0::2, 6] = -u * x
    a[:, 0::2, 7] = -u * y
    a[:, 1::2, 3] = x
    a[:, 1::2, 4] = y
    a[:, 1::2, 5] = ones
    a[:, 1::2, 6] = -v * x
    a[:, 1::2, 7] = -v * y
    coeffs = np.linalg.solve(a, rhs[:, :, None])[:, :, 0]
    m = np.concatenate([coeffs, np.ones((k, 1))], axis=1)
    return m.reshape(k, 3, 3)


def part_quads(joints, o_w, o_h):
    """All 10 part source quads at once: ([10, 4, 2] f32, [10] bool valid).

    Invalid parts carry zero quads (callers mask by `valid`)."""
    quads = np.zeros((len(BODY_PARTS), 4, 2), np.float32)
    valid = np.zeros(len(BODY_PARTS), bool)
    for i, bpart in enumerate(BODY_PARTS):
        ar = 0.5 if i < 6 else 0.4
        q = _part_quad(joints, bpart, o_w, o_h, ar)
        if q is not None:
            quads[i] = q
            valid[i] = True
    return quads, valid


def get_crop_matrices(joints, part_index, patch_w, patch_h, o_w, o_h):
    """(M, M_inv) perspective transforms for one body part, or (None, None).

    M maps image coords -> patch coords ([0,patch_w]x[0,patch_h]);
    M_inv maps back.
    """
    ar = 0.5 if part_index < 6 else 0.4
    quad = _part_quad(joints, BODY_PARTS[part_index], o_w, o_h, ar)
    if quad is None:
        return None, None
    dst = np.float32(
        [[0, 0], [0, patch_h], [patch_w, patch_h], [patch_w, 0]])
    m = get_perspective_transform(quad, dst)
    m_inv = get_perspective_transform(dst, quad)
    return m.astype(np.float32), m_inv.astype(np.float32)
