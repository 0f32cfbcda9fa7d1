"""CIHP 20-class parsing helpers + pose heatmap encodings.

The port's own copy of `pasta_tpu/data/cihp.py`; `label2onehot` gives a
torch tensor where the original gives a jax array.

Capability parity for the reference's parsing/pose utilities outside the
live path: flip_cihp / parsing2im / label2onehot (util_functions.py:89-159)
and the disc-heatmap pose encoding cords_to_map / get_pose_heatmaps
(training/dataset.py:363-399, used by its ImageFolderDataset metrics path).
"""

from __future__ import annotations

import numpy as np
import torch

# CIHP semantic classes whose left/right labels swap under an x-flip:
# 14/15 left-right arm... per the reference flip mapping
# (util_functions.py:105-131): swapped pairs (14,15), (16,17), (18,19).
_CIHP_FLIP_PAIRS = [(14, 15), (16, 17), (18, 19)]

# 20-entry colormap equivalent to the shipped human_colormap.mat (a MATLAB
# data file we don't redistribute); standard CIHP palette.
CIHP_COLORMAP = np.array([
    [0, 0, 0], [128, 0, 0], [255, 0, 0], [0, 85, 0], [170, 0, 51],
    [255, 85, 0], [0, 0, 85], [0, 119, 221], [85, 85, 0], [0, 85, 85],
    [85, 51, 0], [52, 86, 128], [0, 128, 0], [0, 0, 255], [51, 170, 221],
    [0, 255, 255], [85, 255, 170], [170, 255, 85], [255, 255, 0],
    [255, 170, 0]], np.uint8)


def flip_cihp(parsing, axis=1):
    """x-flip a parsing map, swapping left/right labels.

    parsing: [..., H, W] integer array; axis indexes W from the right.
    """
    flipped = np.flip(np.asarray(parsing), axis=-1).copy()
    out = flipped.copy()
    for a, b in _CIHP_FLIP_PAIRS:
        out[flipped == a] = b
        out[flipped == b] = a
    return out


def parsing2im(parsing, colormap=CIHP_COLORMAP):
    """[H, W] labels -> [H, W, 3] uint8 color visualization."""
    parsing = np.asarray(parsing).astype(np.int64)
    return colormap[np.clip(parsing, 0, len(colormap) - 1)]


def label2onehot(labels, num_classes=20):
    """[..., H, W] integer labels -> one-hot [..., H, W, num_classes]."""
    labels = torch.as_tensor(np.asarray(labels)).long()
    return torch.eye(num_classes, dtype=torch.float32)[
        labels.clamp(0, num_classes - 1)]


def cords_to_map(cords, img_size=(512, 320), sigma=8):
    """Keypoints -> per-joint Gaussian disc heatmaps [H, W, 18]
    (reference dataset.py:363-385: exp(-((y-y0)^2+(x-x0)^2)/(2 sigma^2)),
    invalid joints (conf<=0.1 or MISSING_VALUE) all-zero)."""
    cords = np.asarray(cords)
    h, w = img_size
    ys, xs = np.mgrid[0:h, 0:w]
    maps = np.zeros((h, w, len(cords)), np.float32)
    for i, joint in enumerate(cords):
        x0, y0 = joint[0], joint[1]
        conf = joint[2] if len(joint) > 2 else 1.0
        if conf <= 0.1 or x0 < 0 or y0 < 0:
            continue
        maps[..., i] = np.exp(
            -((ys - y0) ** 2 + (xs - x0) ** 2) / (2 * sigma ** 2))
    return maps


def get_pose_heatmaps(keypoints, img_size=(512, 320), sigma=8):
    """Alias with the reference's method name (dataset.py:387-399)."""
    return cords_to_map(keypoints, img_size, sigma)
