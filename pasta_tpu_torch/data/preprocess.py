"""Per-pair try-on preprocessing: the record and the label routing.

The port's own copy of what the serving path uses from
`pasta_tpu/data/preprocess.py`, unchanged in behaviour
(tests/test_torch_host.py holds each name equal to its original): the
decoded record of one image, the count-based garment class routing, the
label LUT and its bounding box, the sleeve mask, the retain mask and the
skin colour. The file loaders are not here: they belong to the data-loading
modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .pose import get_palm_mask


@dataclass
class PersonRecord:
    """Decoded, padded-to-square inputs for one image."""

    name: str
    image: np.ndarray          # [512, 512, 3] uint8 (white-padded)
    pose_img: np.ndarray       # [512, 512, 3] uint8 stick figure, or None
                               # when the raster is deferred to device
    keypoints: np.ndarray      # [18, 3] in padded coords
    parsing: np.ndarray        # [512, 512, 1] int
    garment_parsing: Optional[np.ndarray] = None  # [512, 512, 1] int or None
    pose_params: Optional[dict] = None  # host.pose_device_params


def garment_class_routing(parsing):
    """Count-based twin of garment_class_masks: which parsing labels end up
    in each class, without materializing any mask.

    The disambiguation cascade (dataset.py:2080-2107) only compares mask
    SUMS, and every mask is a union of disjoint label sets — so routing is
    fully determined by the label pixel counts (one bincount pass).

    Returns dict class -> (frozenset(labels), pixel_count).
    """
    cnt = np.bincount(parsing.ravel(), minlength=256)
    cls = {"tops": {5, 7}, "dresses": {6}, "pants": {9}, "skirt": {12}}
    n = {k: int(sum(cnt[l] for l in v)) for k, v in cls.items()}

    def merge(dst, src):
        cls[dst] |= cls[src]
        n[dst] += n[src]
        cls[src] = set()
        n[src] = 0

    if n["pants"] > n["skirt"]:
        merge("pants", "skirt")
    else:
        merge("skirt", "pants")
    if n["dresses"] > 0:
        if n["pants"] > 0:
            merge("tops", "dresses")
        elif n["dresses"] > n["tops"] + n["skirt"]:
            merge("dresses", "tops")
            merge("dresses", "skirt")
        else:
            if n["tops"] > n["skirt"]:
                merge("skirt", "dresses")
            else:
                merge("tops", "dresses")
    return {k: (frozenset(v), n[k]) for k, v in cls.items()}


def label_lut(labels):
    """[256] uint8 LUT: 1 on the given parsing labels."""
    lut = np.zeros(256, np.uint8)
    lut[list(labels)] = 1
    return lut


def mask_to_bbox(mask):
    """[x0, y0, x1, y1] of mask>=0.5, or None (dataset.py:999-1008).

    Row/column any-reductions + argmax instead of materializing the full
    index list (np.where on a 512^2 mask was a visible host-prep cost)."""
    m = np.asarray(mask) >= 0.5
    if m.ndim == 3:
        m = m.any(axis=2)
    rows = m.any(axis=1)
    if not rows.any():
        return None
    cols = m.any(axis=0)
    y0 = int(np.argmax(rows)); y1 = int(len(rows) - 1 - np.argmax(rows[::-1]))
    x0 = int(np.argmax(cols)); x1 = int(len(cols) - 1 - np.argmax(cols[::-1]))
    return [x0, y0, x1, y1]


def bbox_of_labels(parsing, labels):
    """mask_to_bbox of (parsing in labels) without materializing the mask."""
    if not labels:
        return None
    return mask_to_bbox(label_lut(labels)[parsing])


def sleeve_mask_from(record):
    """Sleeve regions (labels 10/11) of a garment-parsing map, or None."""
    if record.garment_parsing is None:
        return None
    gp = record.garment_parsing
    return ((gp == 10).astype(np.uint8) + (gp == 11).astype(np.uint8))


def skin_median_color(image, parsing):
    """[3] per-channel median of neck+face skin pixels (dataset.py:2062-2077)."""
    skin_mask = np.squeeze((parsing == 10) | (parsing == 13))
    skin = image[skin_mask]                       # [K, 3]
    meds = []
    for ch in range(3):
        valid = skin[:, ch][skin[:, ch] > 0]
        meds.append(np.median(valid) if valid.size else 0.0)
    return np.asarray(meds, np.float64)


_RETAIN_LUT = np.zeros(256, np.uint8)
_RETAIN_LUT[[18, 19, 1, 2, 4, 13]] = 1


def retain_mask_of(record):
    """Shoes + head + palms mask (dataset.py:2055-2060); one LUT pass for
    the six parsing labels."""
    p = record.parsing
    return _RETAIN_LUT[p] + get_palm_mask(record.keypoints, p)
