"""The one traffic generator: seeded synthetic persons and garments
written as a data root, and the (person, clothes) pairs a mix sends.

A copy of the port's `data/synthetic.py` drawing (a standing OpenPose-18
figure with seeded jitter, a CIHP parsing map of filled polygons along the
limbs, a 512x512 image coloured by label, sleeve labels 10/11 on the
garment parsing), kept here so that a change to the port cannot change the
yardstick. Draws come from numpy Generators seeded by (seed, index), so
any seed up to 2**63 gives the same kind of person: only the jitter,
colours and noise differ from seed to seed, never a size.

The root's layout is the one the port's `data/roots.py` reads:
image/<name>.png (512x320 RGB), keypoints/<name>_keypoints.json,
parsing/<name>.png, garment_parsing/<name>.png and dataset.json.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os

import numpy as np
import PIL.Image

RES = 512
ORIG_W = 320
LEFT = (RES - ORIG_W) // 2

# Standing figure in original (unpadded 512x320) coordinates, OpenPose-18
# order: nose, neck, r-shoulder/elbow/wrist, l-shoulder/elbow/wrist,
# r-hip/knee/ankle, l-hip/knee/ankle, r-eye, l-eye, r-ear, l-ear.
_TEMPLATE = np.float64([
    [160, 80], [160, 130], [110, 135], [94, 205], [89, 270],
    [210, 135], [226, 205], [231, 270], [130, 270], [126, 360],
    [124, 440], [190, 270], [194, 360], [196, 440], [150, 70],
    [170, 70], [140, 75], [180, 75],
])

# CIHP labels
HAIR, UPPER, PANTS, NECK, FACE = 2, 5, 9, 10, 13
L_ARM, R_ARM, L_LEG, R_LEG = 14, 15, 16, 17
L_SLEEVE, R_SLEEVE = 10, 11   # garment-parsing sleeve labels

_COLORS = {HAIR: (40, 30, 20), FACE: (225, 185, 160), NECK: (215, 175, 150),
           L_ARM: (220, 180, 155), R_ARM: (220, 180, 155),
           L_LEG: (215, 178, 150), R_LEG: (215, 178, 150)}


def _fill_quad(quad, shape):
    """Boolean mask of a convex quad [(x, y)] * 4 in winding order."""
    h, w = shape
    xs, ys = quad[:, 0], quad[:, 1]
    c0 = max(int(np.floor(xs.min())), 0)
    c1 = min(int(np.ceil(xs.max())) + 1, w)
    r0 = max(int(np.floor(ys.min())), 0)
    r1 = min(int(np.ceil(ys.max())) + 1, h)
    mask = np.zeros((h, w), bool)
    if r0 >= r1 or c0 >= c1:
        return mask
    rr, cc = np.mgrid[r0:r1, c0:c1]
    inside = np.ones(rr.shape, bool)
    sign = 0.0
    for i in range(4):
        x0, y0 = quad[i]
        x1, y1 = quad[(i + 1) % 4]
        cross = (x1 - x0) * (rr - y0) - (y1 - y0) * (cc - x0)
        if sign == 0.0 and np.any(cross != 0):
            sign = np.sign(cross[cross != 0][0])
        inside &= cross * sign >= 0
    mask[r0:r1, c0:c1] = inside
    return mask


def _limb_quad(a, b, half_width):
    d = b - a
    nrm = np.array([-d[1], d[0]]) / max(np.linalg.norm(d), 1e-6)
    return np.array([a + half_width * nrm, b + half_width * nrm,
                     b - half_width * nrm, a - half_width * nrm])


def _paint_quad(plane, quad, label):
    plane[_fill_quad(quad, plane.shape)] = label


def _paint_disk(plane, center, radius, label):
    r0 = max(int(center[1] - radius) - 1, 0)
    c0 = max(int(center[0] - radius) - 1, 0)
    yy, xx = np.mgrid[r0:int(center[1] + radius) + 2,
                      c0:int(center[0] + radius) + 2]
    inside = (xx - center[0]) ** 2 + (yy - center[1]) ** 2 < radius ** 2
    window = plane[r0:r0 + inside.shape[0], c0:c0 + inside.shape[1]]
    window[inside[:window.shape[0], :window.shape[1]]] = label


def make_person(seed, index, jitter):
    """Person `index` of the root of `seed`, wearing a sleeved top: (image
    [512, 320, 3], keypoints [18, 3] in its coordinates, parsing [512,
    320], garment parsing [512, 320]), all uint8 but the keypoints."""
    rng = np.random.default_rng([seed, index])
    kp = _TEMPLATE + rng.standard_normal(_TEMPLATE.shape) * jitter
    kp = np.concatenate([kp, rng.uniform(0.6, 0.99, (18, 1))], axis=1)
    j = {i: kp[i, :2] + [LEFT, 0] for i in range(18)}   # padded coords

    parsing = np.zeros((RES, RES), np.uint8)
    _paint_disk(parsing, j[0] + [0, -18], 34, HAIR)
    _paint_disk(parsing, j[0], 26, FACE)
    _paint_quad(parsing, _limb_quad(j[0] + [0, 20], j[1], 12), NECK)
    for hip, knee, ankle, leg in ((8, 9, 10, R_LEG), (11, 12, 13, L_LEG)):
        _paint_quad(parsing, _limb_quad(j[knee], j[ankle], 14), leg)
        _paint_quad(parsing, _limb_quad(j[hip], j[knee], 20), PANTS)
    _paint_quad(parsing, np.array([j[8], j[11], j[12], j[9]]), PANTS)
    torso = np.array([j[2] + [-6, 0], j[5] + [6, 0], j[11] + [4, 4],
                      j[8] + [-4, 4]])
    for sho, elb, wri, arm in ((2, 3, 4, R_ARM), (5, 6, 7, L_ARM)):
        _paint_quad(parsing, _limb_quad(j[sho], j[elb], 15), arm)
        _paint_quad(parsing, _limb_quad(j[elb], j[wri], 12), arm)
        _paint_disk(parsing, j[wri] + (j[wri] - j[elb]) * 0.25, 12, arm)
    garment_parsing = np.zeros((RES, RES), np.uint8)
    for sho, elb, sleeve in ((2, 3, R_SLEEVE), (5, 6, L_SLEEVE)):
        quad = _limb_quad(j[sho], j[elb], 16)
        _paint_quad(parsing, quad, UPPER)
        _paint_quad(garment_parsing, quad, sleeve)
    _paint_quad(garment_parsing, torso, UPPER)
    _paint_quad(parsing, torso, UPPER)

    colors = dict(_COLORS)
    colors[UPPER] = tuple(rng.integers(20, 235, 3))
    colors[PANTS] = tuple(rng.integers(20, 235, 3))
    image = np.full((RES, RES, 3), 244, np.float64)
    for label, rgb in colors.items():
        image[parsing == label] = rgb
    image += rng.standard_normal((RES, RES, 3)) * 6.0
    image = np.clip(image, 1, 255).astype(np.uint8)
    cols = slice(LEFT, LEFT + ORIG_W)
    return image[:, cols], kp, parsing[:, cols], garment_parsing[:, cols]


def _png_bytes(array):
    buf = io.BytesIO()
    PIL.Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def _write(path, rel, data):
    full = os.path.join(path, rel)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    with open(full, "wb") as f:
        f.write(data)


def write_root(path, seed, persons, jitter, threads=8):
    """Write the root of `seed` with `persons` persons into the directory
    `path`; returns their image names, sorted."""
    def one(i):
        image, kp, parsing, garment = make_person(seed, i, jitter)
        stem = f"synthetic_{i:04d}"
        _write(path, f"image/{stem}.png", _png_bytes(image))
        _write(path, f"keypoints/{stem}_keypoints.json", json.dumps(
            {"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}
        ).encode())
        _write(path, f"parsing/{stem}.png", _png_bytes(parsing))
        _write(path, f"garment_parsing/{stem}.png", _png_bytes(garment))
        return f"{stem}.png"

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        names = list(pool.map(one, range(persons)))
    _write(path, "dataset.json", json.dumps(dict(
        images=[dict(name=n, source="synthetic", has_garment_parsing=True)
                for n in names], count=persons)).encode())
    return sorted(names)


def draw_pairs(names, seed, count):
    """`count` (person, clothes) pairs of distinct persons of the root,
    drawn uniformly from the seed."""
    rng = np.random.default_rng([seed, 1 << 20])
    n = len(names)
    person = rng.integers(0, n, count)
    clothes = (person + rng.integers(1, n, count)) % n
    return [(names[p], names[c]) for p, c in zip(person, clothes)]


def load(name):
    """The parameters of traffic mix `name` (traffic/<name>.json)."""
    with open(os.path.join(os.path.dirname(__file__), f"{name}.json")) as f:
        return json.load(f)
