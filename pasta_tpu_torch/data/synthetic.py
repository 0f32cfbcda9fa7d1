"""Seeded synthetic person / garment records for the tests and the smoke.

No photographs, keypoint files or checkpoints are in the repository, so the
serving path runs on records drawn here with numpy from a seed: a standing
OpenPose-18 figure with seeded jitter, a CIHP parsing map painted as filled
polygons along the limbs, and a 512x512 uint8 image coloured by label. The
records are `data.preprocess.PersonRecord`s shaped as
`load_person(..., pose_raster="device")` returns them (a 512x320 original
padded to 512x512, `pose_params` from `data.host.pose_device_params`).

`write_dataset_root` writes such records as the files of a dataset root
(directory or zip), so that the training loaders, which read files, have
something to read where no dataset can be fetched; `write_tryon_root`
adds the test_pairs.txt that the inference run reads.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import PIL.Image

from .host import pose_device_params
from .pose import _fill_quad
from .preprocess import PersonRecord

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


def _limb_quad(a, b, half_width):
    d = b - a
    nrm = np.array([-d[1], d[0]]) / max(np.linalg.norm(d), 1e-6)
    return np.array([a + half_width * nrm, b + half_width * nrm,
                     b - half_width * nrm, a - half_width * nrm])


def _paint_quad(plane, quad, label):
    plane[_fill_quad(quad, plane.shape)[..., 0] > 0] = label


def _paint_disk(plane, center, radius, label):
    yy, xx = np.mgrid[0:plane.shape[0], 0:plane.shape[1]]
    plane[(xx - center[0]) ** 2 + (yy - center[1]) ** 2 < radius ** 2] = label


def make_person(seed, jitter=3.0, garment=False):
    """One synthetic record. `jitter` is the std (px) of the per-joint
    displacement; with `garment` the torso and upper arms are one top
    (label 5) and `garment_parsing` marks the sleeves (10/11)."""
    rng = np.random.RandomState(seed)
    kp = _TEMPLATE + rng.randn(*_TEMPLATE.shape) * jitter
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
    garment_parsing = None
    if garment:
        garment_parsing = np.zeros((RES, RES), np.uint8)
        for sho, elb, sleeve in ((2, 3, R_SLEEVE), (5, 6, L_SLEEVE)):
            quad = _limb_quad(j[sho], j[elb], 16)
            _paint_quad(parsing, quad, UPPER)
            _paint_quad(garment_parsing, quad, sleeve)
        _paint_quad(garment_parsing, torso, UPPER)
    _paint_quad(parsing, torso, UPPER)
    parsing[:, :LEFT] = 0
    parsing[:, LEFT + ORIG_W:] = 0

    colors = dict(_COLORS)
    colors[UPPER] = tuple(rng.randint(20, 235, 3))
    colors[PANTS] = tuple(rng.randint(20, 235, 3))
    image = np.full((RES, RES, 3), 244, np.float64)
    for label, rgb in colors.items():
        image[parsing == label] = rgb
    image += rng.randn(RES, RES, 3) * 6.0
    image = np.clip(image, 1, 255).astype(np.uint8)
    image[:, :LEFT] = 255
    image[:, LEFT + ORIG_W:] = 255

    keypoints = kp.copy()
    pose_params = pose_device_params(keypoints, RES, ORIG_W, LEFT)  # mutates
    keypoints = keypoints.copy()
    keypoints[:, 0] += LEFT
    return PersonRecord(
        name=f"synthetic_{seed}", image=image, pose_img=None,
        keypoints=keypoints, parsing=parsing[..., None],
        garment_parsing=(garment_parsing[..., None]
                         if garment_parsing is not None else None),
        pose_params=pose_params)


def make_garment(seed, jitter=3.0):
    """A synthetic clothes record: a person wearing a sleeved top, with
    `garment_parsing` (sleeves 10/11) set."""
    return make_person(seed, jitter=jitter, garment=True)


def _png_bytes(array):
    buf = io.BytesIO()
    PIL.Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def write_dataset_root(path, n, seed, as_zip=False):
    """Write `n` synthetic persons (`make_garment(seed + i)`) as a dataset
    root in the layout `data/roots.py` reads:

        image/<name>.png                    512x320 RGB (PNG: decodes exactly)
        keypoints/<name>_keypoints.json     OpenPose people[0].pose_keypoints_2d
        parsing/<name>.png                  CIHP labels, 8-bit gray
        garment_parsing/<name>.png          sleeve labels 10/11, 8-bit gray
        dataset.json                        the manifest

    `path` is a directory, or the .zip file to write with `as_zip`. The
    files hold the unpadded 512x320 originals with keypoints in their
    coordinates; `load_person` pads them back to the records drawn here.
    Returns the image file names, sorted as `DataRoot.list("image")` gives
    them."""
    if as_zip:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)

        def write(rel, data):
            zf.writestr(rel, data)
    else:
        zf = None

        def write(rel, data):
            full = os.path.join(path, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)

    manifest = []
    cols = slice(LEFT, LEFT + ORIG_W)
    try:
        for i in range(n):
            rec = make_garment(seed + i)
            stem = f"{rec.name}_{i:04d}"
            kp = rec.keypoints.copy()
            kp[:, 0] -= LEFT
            write(f"image/{stem}.png", _png_bytes(rec.image[:, cols]))
            write(f"keypoints/{stem}_keypoints.json", json.dumps(
                {"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}
            ).encode())
            write(f"parsing/{stem}.png", _png_bytes(rec.parsing[:, cols, 0]))
            write(f"garment_parsing/{stem}.png",
                  _png_bytes(rec.garment_parsing[:, cols, 0]))
            manifest.append(dict(name=f"{stem}.png", source="synthetic",
                                 has_garment_parsing=True))
        write("dataset.json", json.dumps(
            dict(images=manifest, count=n)).encode())
    finally:
        if zf is not None:
            zf.close()
    return sorted(m["name"] for m in manifest)


def write_tryon_root(path, n, seed=0):
    """`write_dataset_root(path, n, seed)` and a test_pairs.txt in it that
    pairs each person with the next one's garment (the reference's
    `<clothes> <person>` lines). Returns the (person, clothes) pairs."""
    names = write_dataset_root(path, n, seed)
    pairs = [(name, names[(i + 1) % n]) for i, name in enumerate(names)]
    with open(os.path.join(path, "test_pairs.txt"), "w") as f:
        f.write("".join(f"{c} {p}\n" for p, c in pairs))
    return pairs
