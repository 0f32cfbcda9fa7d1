"""Try-on preprocessing on the host: the record, its loader, the label
routing, the patch normalization and the per-pair pipeline of the test
modes.

The port's own copy of `pasta_tpu/data/preprocess.py`, unchanged in
behaviour (tests/test_torch_host.py, test_torch_roots.py,
test_torch_trainsets.py and test_torch_inference.py hold each name equal
to its original): the decoded record of one image and `load_person` that
reads it from a dataset root, the garment class masks and their
count-based routing, the label LUT and its bounding box, the sleeve mask,
the retain mask, the skin colour, `normalize_patches` (the cut and paste
warps, in cv2 or the `native` plugin), `preprocess_pair` (the host-side
conditioning of the test modes: the parity path of `cli/test.py`) and
`flip_person`. Mode semantics:

  mode='full'  -- both garments come from the clothes image; patches are cut
                  with the clothes homographies and pasted with the person's.
  mode='upper' -- upper garment from clothes; the person keeps their lower
                  garment (cut/kept in person space).
  mode='lower' -- lower garment from clothes; the person keeps their upper.

Parsing planes decode through the `native` plugin's libpng where it is
built (`_decode_label_plane`); `_warp` and `_erode_mask_255` take it only
with PASTA_USE_NATIVE=1 in the environment, as the original does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import cv2
import numpy as np

from .geometry import BODY_PARTS, LOWER_PARTS, SLEEVE_PARTS, get_crop_matrices
from .pose import get_palm_mask, load_keypoints
from .roots import as_root

RES = 512
PATCH = 128  # box_factor=2: 512 / 2**2


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


def _pad_width(h, w):
    left = (h - w) // 2
    return left, h - w - left


def _pad_lr(arr, left, right, value):
    """np.pad(((0,0),(left,right),(0,0)), constant) without np.pad's
    python overhead (~0.3 ms/call on this host; 6 calls/pair)."""
    h, w = arr.shape[:2]
    out = np.empty((h, w + left + right) + arr.shape[2:], arr.dtype)
    out[:, :left] = value
    out[:, left:left + w] = arr
    out[:, left + w:] = value
    return out


def _png_palette_blue(data):
    """[256] uint8 blue components of a PNG's PLTE chunk, or None.

    Chunk walk: 8-byte signature, then length/type/data/crc records."""
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        length = int.from_bytes(data[pos:pos + 4], "big")
        ctype = data[pos + 4:pos + 8]
        if ctype == b"PLTE":
            plte = np.frombuffer(
                data[pos + 8:pos + 8 + length], np.uint8).reshape(-1, 3)
            blue = np.zeros(256, np.uint8)
            blue[:len(plte)] = plte[:, 2]
            return blue
        if ctype == b"IDAT":
            return None                     # PLTE must precede IDAT
        pos += 12 + length
    return None


def _decode_label_plane(root, rel):
    """Parsing-map decode with cv2.imread-channel-0 semantics.

    PNGs of IHDR colour type 0 (grayscale, the common case), 2, 3 and 6 go
    through the native libpng path when the plugin is built (a palette
    index plane maps through the PLTE table to cv2's expanded blue
    channel); anything else, and every file without the plugin, through
    cv2 (the reference reads parsing with cv2.imread and takes [:, :, 0]).
    """
    data = root.read(rel)
    if len(data) > 25 and data[25] in (0, 2, 3, 6):
        from .. import native
        if native.available():
            try:
                plane = np.asarray(native.decode_image(data))
                if plane.ndim == 2:
                    if data[25] == 3:
                        blue = _png_palette_blue(data)
                        if blue is None:
                            raise ValueError("no PLTE")
                        plane = blue[plane]
                    return plane[..., None]
                if plane.shape[2] in (3, 4):
                    # cv2.imread(COLOR) yields BGR (alpha dropped); its
                    # channel 0 is the RGB blue channel
                    return plane[..., 2:3]
            except ValueError:
                pass
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else img[..., 0:1]


def load_person(root, image_name, with_garment_parsing=False,
                pose_raster="host"):
    """Load image + keypoints + parsing (+garment parsing), pad to square.

    Mirrors the reference file layout (dataset.py:1979-1987): image/<name>,
    keypoints/<name>_keypoints.json, parsing/<name>.png,
    garment_parsing/<name>.png. `root` is a directory path, a .zip path
    (dataset_tool output; reference zip semantics dataset.py:189-399), or a
    DataRoot.

    pose_raster="device" skips the host stick-figure raster: the record
    carries `pose_params` (host.pose_device_params) for the on-device
    raster instead and `pose_img` is None. Keypoint border validation is
    identical in both modes.
    """
    root = as_root(root)
    img = root.decode_image(f"image/{image_name}")
    h, w = img.shape[:2]
    left, right = _pad_width(h, w)
    image = _pad_lr(img, left, right, 255)

    stem = os.path.splitext(image_name)[0]
    pose_params = None
    if pose_raster == "device":
        import json as _json

        from .host import pose_device_params

        with root.open(f"keypoints/{stem}_keypoints.json") as f:
            data = _json.load(f)
        if len(data["people"]) == 0:
            keypoints = np.zeros((18, 3))
        else:
            keypoints = np.array(
                data["people"][0]["pose_keypoints_2d"]).reshape(-1, 3)
        pose_params = pose_device_params(keypoints, h, w, left)  # mutates
        pose_img = None
    else:
        pose_img, keypoints = load_keypoints(
            root.open(f"keypoints/{stem}_keypoints.json"),
            img_size=(h, w))
        pose_img = _pad_lr(pose_img, left, right, 0)
    keypoints = keypoints.copy()
    keypoints[:, 0] += left

    parsing = _decode_label_plane(root, f"parsing/{stem}.png")
    parsing = _pad_lr(parsing, left, right, 0)

    garment_parsing = None
    if with_garment_parsing and root.exists(f"garment_parsing/{stem}.png"):
        gp = _decode_label_plane(root, f"garment_parsing/{stem}.png")
        if gp is not None:
            garment_parsing = _pad_lr(gp, left, right, 0)
    return PersonRecord(image_name, image, pose_img, keypoints, parsing,
                        garment_parsing, pose_params)


def garment_class_masks(parsing):
    """Disambiguate tops/dress/pants/skirt masks (dataset.py:2080-2107).

    Returns dict of [H, W, 1] uint8 masks: tops, dresses, pants, skirt.
    """
    tops = (parsing == 5).astype(np.uint8) + (parsing == 7).astype(np.uint8)
    dresses = (parsing == 6).astype(np.uint8)
    pants = (parsing == 9).astype(np.uint8)
    skirt = (parsing == 12).astype(np.uint8)

    if pants.sum() > skirt.sum():
        pants += skirt
        skirt = skirt * 0
    else:
        skirt += pants
        pants = pants * 0

    if dresses.sum() > 0:
        if pants.sum() > 0:
            tops += dresses
            dresses = dresses * 0
        elif dresses.sum() > (tops.sum() + skirt.sum()):
            dresses = dresses + tops + skirt
            tops = tops * 0
            skirt = skirt * 0
        else:
            if tops.sum() > skirt.sum():
                skirt += dresses
            else:
                tops += dresses
            dresses = dresses * 0
    return dict(tops=tops, dresses=dresses, pants=pants, skirt=skirt)


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


def skin_average_map(image, parsing):
    """Per-channel median of neck+face skin, broadcast to [H, W, 3]
    (dataset.py:2062-2077)."""
    # broadcast view — callers treat it as read-only; the raw-batch path
    # reduces it back to the [3] color anyway
    return np.broadcast_to(
        skin_median_color(image, parsing), image.shape[:2] + (3,))


_RETAIN_LUT = np.zeros(256, np.uint8)
_RETAIN_LUT[[18, 19, 1, 2, 4, 13]] = 1


def retain_mask_of(record):
    """Shoes + head + palms mask (dataset.py:2055-2060); one LUT pass for
    the six parsing labels."""
    p = record.parsing
    return _RETAIN_LUT[p] + get_palm_mask(record.keypoints, p)


# ---------------------------------------------------------------------------
# patch normalization / denormalization


_USE_NATIVE = os.environ.get("PASTA_USE_NATIVE", "0") == "1"


def _warp(img, m, size):
    if _USE_NATIVE:
        from .. import native

        if native.available():
            return native.warp_perspective_batch(
                np.ascontiguousarray(img, np.uint8)[None],
                np.linalg.inv(np.asarray(m, np.float64))[None],
                size[1], size[0], num_threads=1)[0]
    return cv2.warpPerspective(img, m, size, borderMode=cv2.BORDER_CONSTANT)


def _erode_mask_255(mask_img, k):
    """Erode a {0,255} mask image and threshold back to {0,1} uint8."""
    if _USE_NATIVE:
        from .. import native

        if native.available():
            m = np.ascontiguousarray(mask_img, np.uint8)
            chan = m[..., 0] if m.ndim == 3 else m
            eroded = native.erode_batch(chan[None], k, num_threads=1)[0]
            return (eroded[..., np.newaxis] == 255).astype(np.uint8)
    eroded = cv2.erode(mask_img, np.ones((k, k), np.uint8), iterations=1)
    if eroded.ndim == 2:
        eroded = eroded[..., np.newaxis]
    return (eroded == 255).astype(np.uint8)


def normalize_patches(
    upper_img, lower_img, upper_mask_rgb, lower_mask_rgb, sleeve_mask,
    upper_cut_kps, lower_cut_kps, paste_kps, *,
    erode_k=5,
    track_wo_sleeve=False,
    zero_lower_under_upper=False,
    return_transforms=False,
    train_erasure_rng=None,
):
    """Cut garments into 10 normalized 128^2 patches and composite them back
    onto the paste pose.

    Parity target: the reference `normalize` methods (train dataset.py:
    1010-1195; test variants :2554-2700 etc.), with the cut/paste keypoint
    sources parameterized instead of class-copied.

    Args:
        upper_img/lower_img: [512,512,3] uint8 garment pixels (masked).
        *_mask_rgb: [512,512,3] {0,255} uint8 garment masks.
        sleeve_mask: [512,512,1] {0,1} or None — routes arm parts.
        upper_cut_kps / lower_cut_kps: keypoints defining the CUT transforms
            for each stream (clothes' or person's, mode-dependent).
        paste_kps: keypoints of the target person (paste/denormalize).
        erode_k: erosion kernel for denorm mask cleanup (5 or 8).
        track_wo_sleeve: also composite an upper denorm WITHOUT arm parts
            (upper mode uses its bbox for the conditioning bound).
        zero_lower_under_upper: zero lower patches where upper torso/hip
            patches overlap (upper/lower modes).

    Returns dict with: norm_img [128,128,30], norm_img_lower [128,128,15],
        denorm_upper_img, denorm_lower_img [512,512,3],
        (denorm_upper_img_wo_sleeve), (Ms, M_invs [10,3,3]).
    """
    o_h = o_w = RES
    w = h = PATCH
    kernel_k = erode_k

    part_imgs = []
    part_imgs_lower = []
    part_masks = []
    part_masks_lower = []
    ms, m_invs = [], []

    denorm_upper = np.zeros_like(upper_img)
    denorm_upper_wo_sleeve = np.zeros_like(upper_img)
    denorm_lower = np.zeros_like(upper_img)

    # Hoisted sleeve routing (was recomputed per part: 4 full-canvas
    # multiplies x 10 parts).
    if sleeve_mask is not None:
        up_img_s = upper_img * sleeve_mask
        up_mask_s = upper_mask_rgb * sleeve_mask
        up_img_b = upper_img * (1 - sleeve_mask)
        up_mask_b = upper_mask_rgb * (1 - sleeve_mask)
    else:
        up_img_s = up_img_b = upper_img
        up_mask_s = up_mask_b = upper_mask_rgb

    def _paste(dsts, part_img, part_mask, m_inv):
        """Composite a warped patch into each dst, restricted to the
        projected quad's bbox (+erode_k margin of warp-constant zeros, so
        cv2.erode's border behavior matches the full-canvas composite).
        Exact: outside the bbox the warped patch and its eroded mask are
        identically zero."""
        corners = np.array(
            [[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
            np.float64) @ np.asarray(m_inv, np.float64).T
        if np.any(np.abs(corners[:, 2]) < 1e-9):
            x0, y0, x1, y1 = 0, 0, o_w, o_h        # degenerate: full canvas
        else:
            xy = corners[:, :2] / corners[:, 2:3]
            x0 = max(int(np.floor(xy[:, 0].min())) - kernel_k, 0)
            y0 = max(int(np.floor(xy[:, 1].min())) - kernel_k, 0)
            x1 = min(int(np.ceil(xy[:, 0].max())) + kernel_k + 2, o_w)
            y1 = min(int(np.ceil(xy[:, 1].max())) + kernel_k + 2, o_h)
        if x0 >= x1 or y0 >= y1:
            return
        shift = np.array([[1, 0, -x0], [0, 1, -y0], [0, 0, 1]], np.float64)
        m_roi = shift @ np.asarray(m_inv, np.float64)
        patch = _warp(part_img, m_roi, (x1 - x0, y1 - y0))
        dmask = _erode_mask_255(
            _warp(part_mask, m_roi, (x1 - x0, y1 - y0))[..., 0:1], kernel_k)
        for dst in dsts:
            roi = dst[y0:y1, x0:x1]
            dst[y0:y1, x0:x1] = patch * dmask + roi * (1 - dmask)

    for ii in range(len(BODY_PARTS)):
        part_img = np.zeros((h, w, 3), np.uint8)
        part_img_lower = np.zeros((h, w, 3), np.uint8)
        part_mask = np.zeros((h, w, 3), np.uint8)
        part_mask_lower = np.zeros((h, w, 3), np.uint8)

        upper_m, _ = get_crop_matrices(upper_cut_kps, ii, w, h, o_w, o_h)
        lower_m, _ = get_crop_matrices(lower_cut_kps, ii, w, h, o_w, o_h)
        paste_m, paste_m_inv = get_crop_matrices(paste_kps, ii, w, h, o_w, o_h)

        if upper_m is not None:
            if ii in SLEEVE_PARTS:
                src_img, src_mask = up_img_s, up_mask_s
            else:
                src_img, src_mask = up_img_b, up_mask_b
            part_img = _warp(src_img, upper_m, (w, h))
            part_mask = _warp(src_mask, upper_m, (w, h))

            if paste_m_inv is not None:
                dsts = [denorm_upper]
                if track_wo_sleeve and ii not in SLEEVE_PARTS:
                    dsts.append(denorm_upper_wo_sleeve)
                _paste(dsts, part_img, part_mask, paste_m_inv)

        if ii in LOWER_PARTS and lower_m is not None:
            part_img_lower = _warp(lower_img, lower_m, (w, h))
            part_mask_lower = _warp(lower_mask_rgb, lower_m, (w, h))
            if paste_m_inv is not None:
                _paste([denorm_lower], part_img_lower, part_mask_lower,
                       paste_m_inv)

        if paste_m is not None:
            ms.append(paste_m[np.newaxis])
            m_invs.append(paste_m_inv[np.newaxis])
        else:
            ms.append(np.zeros((1, 3, 3), np.float32))
            m_invs.append(np.zeros((1, 3, 3), np.float32))

        part_imgs.append(part_img)
        part_masks.append(part_mask)
        if ii in LOWER_PARTS:
            part_imgs_lower.append(part_img_lower)
            part_masks_lower.append(part_mask_lower)

    if zero_lower_under_upper:
        # Person keeps one garment: zero the kept stream's torso/hip patches
        # where the transferred garment's patches cover them
        # (test variants dataset.py:2660-2670).
        for lower_idx, upper_idx in [(0, 0), (1, 6), (3, 8)]:
            occupied = (
                part_masks[upper_idx].sum(axis=2, keepdims=True) > 0
            ).astype(np.uint8)
            part_imgs_lower[lower_idx] = part_imgs_lower[lower_idx] * (1 - occupied)
            part_masks_lower[lower_idx] = part_masks_lower[lower_idx] * (1 - occupied)

    # Mirror a missing sleeve from the other side (dataset.py:1100-1129).
    for a, b in [(2, 4), (3, 5)]:
        if part_masks[a].sum() == 0 and part_masks[b].sum() > 0:
            part_imgs[a] = cv2.flip(part_imgs[b], 1)
            part_masks[a] = cv2.flip(part_masks[b], 1)
        elif part_masks[b].sum() == 0 and part_masks[a].sum() > 0:
            part_imgs[b] = cv2.flip(part_imgs[a], 1)
            part_masks[b] = cv2.flip(part_masks[a], 1)

    out = dict(
        norm_img=np.concatenate(part_imgs, axis=2),
        norm_img_lower=np.concatenate(part_imgs_lower, axis=2),
        denorm_upper_img=denorm_upper,
        denorm_lower_img=denorm_lower,
        norm_clothes_masks=np.concatenate(part_masks, axis=2),
        norm_clothes_masks_lower=np.concatenate(part_masks_lower, axis=2),
    )
    if train_erasure_rng is not None:
        # Train-time lower-garment erasure augmentation (dataset.py:1139-1170).
        from .trainsets import _train_erasure

        erased = _train_erasure(
            part_imgs_lower, part_masks_lower, train_erasure_rng)
        out["norm_img_lower_for_train"] = np.concatenate(erased, axis=2)
    if track_wo_sleeve:
        out["denorm_upper_img_wo_sleeve"] = denorm_upper_wo_sleeve
    if return_transforms:
        out["Ms"] = np.concatenate(ms, axis=0)
        out["M_invs"] = np.concatenate(m_invs, axis=0)
    return out


# ---------------------------------------------------------------------------
# full per-pair pipeline (test modes)


def preprocess_pair(person: PersonRecord, clothes: PersonRecord, mode: str,
                    use_sleeve_mask: bool = True) -> Dict[str, np.ndarray]:
    """person + clothes records -> model-ready arrays for one try-on pair.

    mode in {'full', 'upper', 'lower'}; see module docstring. Returns a dict
    of HWC uint8/float arrays (unnormalized; batching/scaling happens in the
    CLI/dataset layer).
    """
    assert mode in ("full", "upper", "lower")
    person_cls = garment_class_masks(person.parsing)
    clothes_cls = garment_class_masks(clothes.parsing)

    if mode == "full":
        upper_src, lower_src = clothes, clothes
        upper_masks, lower_masks = clothes_cls, clothes_cls
    elif mode == "upper":
        upper_src, lower_src = clothes, person
        upper_masks, lower_masks = clothes_cls, person_cls
    else:
        upper_src, lower_src = person, clothes
        upper_masks, lower_masks = person_cls, clothes_cls

    upper_mask = upper_masks["tops"] + upper_masks["dresses"]
    lower_mask = lower_masks["skirt"] + lower_masks["pants"]

    # Dress conflicts zero the other stream (dataset.py:2176-2184, lower
    # variant equivalent).
    dress_transfer = False
    if mode == "upper" and clothes_cls["dresses"].sum() > 0:
        lower_mask = lower_mask * 0
        dress_transfer = True
    if mode == "lower" and person_cls["dresses"].sum() > 0:
        lower_mask = lower_mask * 0
        dress_transfer = True

    upper_img = upper_mask * upper_src.image
    lower_img = lower_mask * lower_src.image
    upper_mask_rgb = np.repeat(upper_mask, 3, axis=2) * 255
    lower_mask_rgb = np.repeat(lower_mask, 3, axis=2) * 255

    sleeve_src = person if mode == "lower" else clothes
    sleeve = sleeve_mask_from(sleeve_src) if use_sleeve_mask else None

    norm = normalize_patches(
        upper_img, lower_img, upper_mask_rgb, lower_mask_rgb, sleeve,
        upper_cut_kps=upper_src.keypoints,
        lower_cut_kps=lower_src.keypoints,
        paste_kps=person.keypoints,
        erode_k=8 if mode == "upper" else 5,
        track_wo_sleeve=(mode == "upper"),
        zero_lower_under_upper=(mode in ("upper", "lower")),
    )
    denorm_upper = norm["denorm_upper_img"]
    denorm_lower = norm["denorm_lower_img"]

    # Kept-garment streams bypass the warp round-trip: the garment is already
    # on the person (dataset.py:2213-2216 upper / lower-variant :238-241).
    if mode == "upper":
        kept = _erode_mask_255(lower_mask_rgb, 8)
        denorm_lower = lower_img * kept
    if mode == "lower":
        kept = _erode_mask_255(upper_mask_rgb, 8)
        denorm_upper = upper_img * kept

    # Conditioning bound map for the lower garment.
    bound = np.zeros_like(lower_mask[..., 0:1], np.uint8)
    if mode == "upper":
        lower_bbox = mask_to_bbox(lower_mask.copy())
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
            bound[ub:, ...] += 255
        # Cut the bound above the transferred upper garment's bottom.
        wo_sleeve_mask = (
            norm["denorm_upper_img_wo_sleeve"].sum(axis=2, keepdims=True) > 0
        ).astype(np.uint8)
        upper_bbox = mask_to_bbox(wo_sleeve_mask)
        if upper_bbox is not None:
            bound[0:upper_bbox[3], ...] *= 0
    elif mode == "lower":
        lower_bbox = mask_to_bbox((person_cls["skirt"] + person_cls["pants"]).copy())
        if lower_bbox is not None:
            bound[lower_bbox[1]:, ...] += 255
    else:  # full
        denorm_lower_mask = (
            denorm_lower.sum(axis=2, keepdims=True) > 0).astype(np.uint8)
        lower_bbox = mask_to_bbox(denorm_lower_mask)
        if lower_bbox is not None and not (
                mode == "full" and clothes_cls["dresses"].sum() > 0):
            bound[lower_bbox[1]:, ...] += 255

    # Lower-garment class label map: pants 0, skirt 1/2, dress 1 (x255).
    label = np.ones_like(lower_mask)
    if mode == "upper":
        pants, skirt = person_cls["pants"], person_cls["skirt"]
        dress = clothes_cls["dresses"]
        if dress_transfer:
            pants, skirt = pants * 0, skirt * 0
    elif mode == "lower":
        pants, skirt = clothes_cls["pants"], clothes_cls["skirt"]
        dress = person_cls["dresses"]
        if dress_transfer:
            pants, skirt = pants * 0, skirt * 0
    else:
        pants, skirt = clothes_cls["pants"], clothes_cls["skirt"]
        dress = clothes_cls["dresses"]
    if pants.sum() > 0:
        label = label * 0
    elif skirt.sum() > 0:
        label = label * 1
    elif dress.sum() > 0:
        label = label * 2
    label = label / 2.0 * 255

    return dict(
        image=person.image,
        clothes=clothes.image,
        pose=person.pose_img,
        norm_img=norm["norm_img"],
        norm_img_lower=norm["norm_img_lower"],
        denorm_upper_img=denorm_upper,
        denorm_lower_img=denorm_lower,
        retain_mask=retain_mask_of(person),
        skin_average=skin_average_map(person.image, person.parsing),
        lower_label_map=label.astype(np.float64),
        lower_bound=bound.astype(np.float64),
        person_name=person.name,
        clothes_name=clothes.name,
    )


def flip_person(record: PersonRecord) -> PersonRecord:
    """x-flip a loaded PersonRecord (dataset --mirror xflip).

    The reference's base-class xflip bookkeeping (training/dataset.py:77-81)
    never reaches UvitonDatasetFull_512's sample assembly (its __getitem__
    reads only _raw_idx), so there is no reference parity surface here —
    this is an honest mirror: image/parsing/garment-parsing planes flip,
    CIHP left/right labels swap (flip_cihp), OpenPose joints swap sides and
    the pose raster re-derives from the flipped keypoints."""
    from .cihp import flip_cihp
    from .pose import draw_pose, flip_keypoints

    res = record.image.shape[0]
    keypoints = flip_keypoints(record.keypoints, res)

    parsing = flip_cihp(record.parsing[..., 0])[..., None]
    garment_parsing = None
    if record.garment_parsing is not None:
        gp = np.asarray(record.garment_parsing)[:, ::-1].copy()
        # sleeve labels 10/11 are a left/right pair
        swapped = gp.copy()
        swapped[gp == 10] = 11
        swapped[gp == 11] = 10
        garment_parsing = swapped

    pose_img = None
    pose_params = None
    if record.pose_params is not None:
        from .host import flip_pose_params

        pose_params = flip_pose_params(record.pose_params, res)
    else:
        # keypoints are already in padded square coords; re-raster on the
        # square canvas (pad region stays black like the padded raster)
        pose_img, _ = draw_pose(keypoints.copy(), img_size=(res, res))

    return PersonRecord(
        name=record.name + "_xflip",
        image=record.image[:, ::-1].copy(),
        pose_img=pose_img,
        keypoints=keypoints,
        parsing=parsing,
        garment_parsing=garment_parsing,
        pose_params=pose_params,
    )
