"""Training dataset: same-person reconstruction with erasure augmentation.

Port of `pasta_tpu/data/trainsets.py`. The host side (the dataset, the two
per-sample preprocessors and the batch stackers) is that module's code,
copied unchanged in behaviour; the two device assemblers are plain
functions on torch tensors, on whatever device the raw batch lies. Parity
target: UvitonDatasetFull_512 (the reference's training/dataset.py:
404-1248). Differences handled explicitly:

  * the reference's ACGPN random occlusion masks are files on disk
    (dataset.py:1226-1241); when no mask directory is supplied we synthesize
    random rectangle/ellipse blobs with the same role (p=0.9 per sample).
  * the train-time lower-garment erasure augmentation (dataset.py:1160-1170)
    is ported exactly (p=0.8 torso-patch zeroing / strip erasure).

Training consumes the ERASED lower patch stack and the `for_train` bound map
(training_loop_fullbody.py:551-553 unpacking).

The port has one warp implementation (the bilinear gather), so the lean
assembler takes no `warp_impl` and no `cut_windowed` yet: the cut windows
serve only the JAX package's matmul warps. `batch_to_lean_inputs` still
returns `(batch, tiled, windowed)`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import cv2
import numpy as np
import torch

from . import preprocess as pp
from .preprocess import (
    PersonRecord, garment_class_masks, load_person, mask_to_bbox,
    normalize_patches, retain_mask_of, skin_average_map, sleeve_mask_from,
    RES, PATCH)


def _train_erasure(part_imgs_lower, part_masks_lower, rng):
    """Random lower-garment patch erasure (dataset.py:1139-1170)."""
    h, w = PATCH, PATCH
    bbox = mask_to_bbox(part_masks_lower[0][..., 0:1].copy())
    out = [p.copy() for p in part_imgs_lower]
    if bbox is None:
        return out
    if rng.rand() < 0.80:
        if rng.rand() < 0.6:
            out[0] = np.zeros((h, w, 3), np.uint8)
            if rng.rand() < 0.75:
                erase = rng.randint(1, h // 10)
                out[1][0:erase, ...] = 0
                out[3][0:erase, ...] = 0
        else:
            ty = bbox[1]
            by = rng.randint(ty + 1, h + 1)
            out[0][ty:by, ...] = 0
    return out


def synthesize_occlusion_mask(rng, size=RES):
    """Procedural stand-in for the ACGPN random mask files: a blob of a few
    random rotated rectangles and ellipses, [size, size, 1] in {0,1}."""
    mask = np.zeros((size, size, 1), np.uint8)
    for _ in range(rng.randint(1, 4)):
        cx, cy = rng.randint(64, size - 64, 2)
        w, h = rng.randint(30, 140, 2)
        angle = rng.uniform(0, 180)
        if rng.rand() < 0.5:
            box = cv2.boxPoints(((float(cx), float(cy)),
                                 (float(w), float(h)), float(angle)))
            cv2.fillPoly(mask, [np.int32(box)], 1)
        else:
            cv2.ellipse(mask, (int(cx), int(cy)), (int(w // 2), int(h // 2)),
                        angle, 0, 360, 1, -1)
    return mask


def draw_occlusion_mask(rng, occlusion_mask_dir=None, occlusion_files=None):
    """p=0.9 random occlusion mask: an ACGPN file when a mask dir is
    supplied, else a synthesized blob (dataset.py:1226-1241)."""
    if rng.rand() >= 0.9:
        return np.zeros((RES, RES, 1), np.uint8)
    if occlusion_files:
        fname = occlusion_files[rng.randint(len(occlusion_files))]
        m = cv2.imread(os.path.join(occlusion_mask_dir or "", fname))
        return (m[..., 0:1] > 0).astype(np.uint8)
    return synthesize_occlusion_mask(rng)


def preprocess_person_train(person: PersonRecord,
                            rng: np.random.RandomState,
                            occlusion_mask_dir: Optional[str] = None,
                            occlusion_files=None) -> Dict[str, np.ndarray]:
    """One training sample (same-person cut+paste) -> model input arrays."""
    cls = garment_class_masks(person.parsing)
    p = person.parsing

    upper_mask = cls["tops"] + cls["dresses"]
    lower_mask = cls["skirt"] + cls["pants"]
    hand_leg = sum((p == i).astype(np.uint8) for i in (14, 15, 16, 17))
    neck = (p == 10).astype(np.uint8)
    # 7-class gt parsing (dataset.py:596-597)
    gt_parsing = (
        cls["tops"] * 1 + cls["pants"] * 2 + cls["skirt"] * 3
        + cls["dresses"] * 4 + neck * 5 + hand_leg * 6
    ).astype(np.float32)

    upper_img = upper_mask * person.image
    lower_img = lower_mask * person.image
    upper_mask_rgb = np.repeat(upper_mask, 3, axis=2) * 255
    lower_mask_rgb = np.repeat(lower_mask, 3, axis=2) * 255
    sleeve = sleeve_mask_from(person)

    norm = normalize_patches(
        upper_img, lower_img, upper_mask_rgb, lower_mask_rgb, sleeve,
        upper_cut_kps=person.keypoints,
        lower_cut_kps=person.keypoints,
        paste_kps=person.keypoints,
        erode_k=5,
        return_transforms=True,
        train_erasure_rng=rng,
    )

    # bound map (train variant: bbox only, dataset.py:612-616)
    bound = np.zeros_like(lower_mask[..., 0:1], np.float64)
    bbox = mask_to_bbox(lower_mask.copy())
    if bbox is not None:
        bound[bbox[1]:, ...] += 255

    label = np.ones_like(lower_mask)
    if cls["pants"].sum() > 0:
        label = label * 0
    elif cls["skirt"].sum() > 0:
        label = label * 1
    elif cls["dresses"].sum() > 0:
        label = label * 2
    label = label / 2.0 * 255

    # random occlusion of the denorm garments (dataset.py:1226-1241)
    denorm_upper = norm["denorm_upper_img"]
    denorm_lower = norm["denorm_lower_img"]
    occ = draw_occlusion_mask(rng, occlusion_mask_dir, occlusion_files)
    denorm_upper = denorm_upper * (1 - occ)
    denorm_lower = denorm_lower * (1 - occ)

    return dict(
        image=person.image,
        pose=person.pose_img,
        norm_img=norm["norm_img"],
        norm_img_lower=norm["norm_img_lower_for_train"],
        denorm_upper_img=denorm_upper,
        denorm_lower_img=denorm_lower,
        gt_parsing=gt_parsing,
        retain_mask=retain_mask_of(person),
        skin_average=skin_average_map(person.image, person.parsing),
        lower_label_map=label.astype(np.float64),
        lower_bound=bound,
        person_name=person.name,
    )


def _resize_item(item, res):
    """Downscale a preprocessed sample to `res` (debug/smoke configs only;
    the shipped pipeline is 512)."""
    out = {}
    for k, v in item.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        if v.shape[0] == RES:
            target = res
        elif v.shape[0] == PATCH:
            target = max(res // 4, 8)
        else:
            out[k] = v
            continue
        interp = cv2.INTER_NEAREST if k in ("gt_parsing", "retain_mask") \
            else cv2.INTER_AREA
        r = cv2.resize(v.astype(np.float32), (target, target),
                       interpolation=interp)
        if r.ndim == 2:
            r = r[..., np.newaxis]
        out[k] = r
    return out


class TryonTrainDataset:
    """Iterable same-person training dataset over an image-folder layout or
    a dataset_tool zip (reference zip semantics, dataset.py:189-399).

    Each sample needs image/, keypoints/, parsing/, garment_parsing/ entries
    (the reference's multi-source txt-list plumbing maps to passing an
    explicit file list)."""

    def __init__(self, root: str, image_names=None, seed: int = 0,
                 use_sleeve_mask: bool = True,
                 occlusion_mask_dir: Optional[str] = None,
                 resolution: int = RES, loader_impl: str = "host",
                 max_size: Optional[int] = None, xflip: bool = False,
                 random_seed: int = 0):
        from .roots import as_root

        assert loader_impl in ("host", "device")
        assert loader_impl == "host" or resolution == RES, \
            "the device loader ships full-res planes (no debug resizing)"
        self.root = as_root(root)
        self.use_sleeve_mask = use_sleeve_mask
        self.resolution = resolution
        self.loader_impl = loader_impl
        if image_names is None:
            image_names = self.root.list("image")
        self.image_names = list(image_names)
        self.rng = np.random.RandomState(seed)
        self.occlusion_mask_dir = occlusion_mask_dir
        self.occlusion_files = (
            sorted(os.listdir(occlusion_mask_dir))
            if occlusion_mask_dir and os.path.isdir(occlusion_mask_dir)
            else None)
        # max_size subsetting + xflip doubling: exact reference bookkeeping
        # (training/dataset.py:71-81, train.py:241-251 --mirror). Unlike the
        # reference — whose try-on __getitem__ never consults _xflip — the
        # flipped half is honestly mirrored (preprocess.flip_person).
        self._raw_idx = np.arange(len(self.image_names), dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip,
                                          np.ones_like(self._xflip)])

    def __len__(self):
        return self._raw_idx.size

    def _load(self, idx, pose_raster="host"):
        from .preprocess import flip_person

        person = load_person(self.root,
                             self.image_names[self._raw_idx[idx]],
                             with_garment_parsing=self.use_sleeve_mask,
                             pose_raster=pose_raster)
        if self._xflip[idx]:
            person = flip_person(person)
        return person

    def __getitem__(self, idx):
        # always the host path: the evaluator/grid consumers build
        # host-assembled inputs; the device loader uses lean_item
        person = self._load(idx)
        item = preprocess_person_train(
            person, self.rng, self.occlusion_mask_dir, self.occlusion_files)
        if self.resolution != RES:
            item = _resize_item(item, self.resolution)
        return item

    def lean_item(self, idx):
        """Host half only; assemble_train_batch_lean finishes on device."""
        person = self._load(idx, pose_raster="device")
        return preprocess_person_train_lean(
            person, self.rng, self.occlusion_mask_dir, self.occlusion_files)

    def infinite_batches(self, batch_size, shuffle=True):
        """Infinite shuffled batch iterator (misc.InfiniteSampler analogue)."""
        order = np.arange(len(self))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idxs = order[start:start + batch_size]
                yield [self[i] for i in idxs]


def batch_to_train_inputs(items):
    """Stack per-sample dicts -> train-step batch (training_loop
    :548-601 tensor assembly, NHWC)."""
    stack = lambda key: np.stack(
        [item[key] for item in items]).astype(np.float32)
    norm01 = lambda x: x / 127.5 - 1.0

    image = norm01(stack("image"))
    pose = norm01(stack("pose"))
    retain_mask = stack("retain_mask")
    retain = image * retain_mask - (1 - retain_mask)
    denorm_upper = stack("denorm_upper_img")
    denorm_lower = stack("denorm_lower_img")
    return dict(
        real_img=image,
        pose=np.concatenate([
            pose, norm01(stack("lower_label_map")),
            norm01(stack("lower_bound"))], axis=-1),
        style_input=np.concatenate(
            [norm01(stack("norm_img")), norm01(stack("norm_img_lower"))],
            axis=-1),
        retain=np.concatenate([retain, norm01(stack("skin_average"))], axis=-1),
        denorm_upper_input=norm01(denorm_upper),
        denorm_lower_input=norm01(denorm_lower),
        denorm_upper_mask=(
            denorm_upper.sum(axis=-1, keepdims=True) > 0).astype(np.float32),
        denorm_lower_mask=(
            denorm_lower.sum(axis=-1, keepdims=True) > 0).astype(np.float32),
        gt_parsing=stack("gt_parsing"),
    )


def batch_to_raw_inputs(items):
    """Stack per-sample dicts into a COMPACT raw batch for device upload.

    `batch_to_train_inputs` assembles ~27 MB of float32 per item on the
    host. This variant keeps every field in its storage dtype (~4 MB/item)
    — uint8 images/masks/labels plus a [3] skin color — and
    `assemble_train_batch` expands it on device with the exact same
    arithmetic.
    """
    # round-quantize: items are uint8 in the shipped 512 pipeline (raw
    # upload is then bit-exact); debug resolutions resize through float.
    u8 = lambda key: np.round(
        np.stack([item[key] for item in items])).astype(np.uint8)
    skin = np.stack([np.asarray(item["skin_average"])[0, 0]
                     for item in items]).astype(np.float32)       # [n, 3]
    # lower_label_map values are {0, 127.5, 255} (reference lower_label_map
    # in {0, .5, 1}*255, dataset.py:644-651): store the class index.
    cls = np.stack([
        np.round(np.asarray(item["lower_label_map"], np.float32) / 127.5)
        for item in items]).astype(np.uint8)
    return dict(
        image=u8("image"),
        pose=u8("pose"),
        norm_img=u8("norm_img"),
        norm_img_lower=u8("norm_img_lower"),
        denorm_upper_img=u8("denorm_upper_img"),
        denorm_lower_img=u8("denorm_lower_img"),
        retain_mask=u8("retain_mask"),
        gt_parsing=u8("gt_parsing"),
        skin_rgb=skin,
        lower_label_cls=cls,
        lower_bound=u8("lower_bound"),
    )


def preprocess_person_train_lean(person: PersonRecord,
                                 rng: np.random.RandomState,
                                 occlusion_mask_dir: Optional[str] = None,
                                 occlusion_files=None) -> Dict[str, np.ndarray]:
    """Host half of the DEVICE training loader: scalars + raw u8 planes.

    The host path (preprocess_person_train) runs ~30 cv2 warps plus the
    conditioning rasters per sample (~50 ms/core); here the host keeps only
    decode, keypoint scalar geometry, one bincount routing pass, the
    homography solves/layouts and the RNG draws — everything raster/warp
    runs inside assemble_train_batch_lean on the accelerator. Requires
    load_person(pose_raster="device") records.
    """
    from .host import (host_matrices_for_pair, palm_device_params,
                       part_layouts_for_pair)

    assert person.pose_params is not None, \
        "lean loader needs load_person(pose_raster='device')"
    rt = pp.garment_class_routing(person.parsing)
    upper_labels = rt["tops"][0] | rt["dresses"][0]
    lower_labels = rt["skirt"][0] | rt["pants"][0]

    # lower-garment class scalar (preprocess_person_train parity)
    if rt["pants"][1] > 0:
        cls = 0
    elif rt["skirt"][1] > 0:
        cls = 1
    elif rt["dresses"][1] > 0:
        cls = 2
    else:
        cls = 1
    bbox = pp.bbox_of_labels(person.parsing, lower_labels)
    bound_row = bbox[1] if bbox is not None else RES

    # 7-class gt-parsing garment values (tops 1 / pants 2 / skirt 3 /
    # dresses 4 after routing; neck 5 and limbs 6 are static on device)
    gt_lut = np.zeros(256, np.uint8)
    for val, k in ((1, "tops"), (2, "pants"), (3, "skirt"), (4, "dresses")):
        gt_lut[list(rt[k][0])] = val

    kps = person.keypoints
    mu, ml, pinv, valid, pfwd = host_matrices_for_pair(
        kps, kps, kps, return_paste_fwd=True)
    tile_offsets, tiles_fit, cut_window_offsets, cut_fits = \
        part_layouts_for_pair(mu, ml, pinv, valid, pfwd)

    # RNG draws for the erasure augmentation (dataset.py:1139-1170): the
    # branch conditions/uniforms are host scalars, the bbox-dependent strip
    # is finished on device. Fixed draw count (conditional draws in the
    # host oracle; distributional equivalence is the contract, SURVEY §7).
    erasure = np.asarray([
        rng.rand(),                       # < 0.80 gate
        rng.rand(),                       # < 0.6 branch
        rng.rand(),                       # < 0.75 top-strip gate
        rng.rand(),                       # by = ty+1+floor(u*(PATCH-ty))
        float(rng.randint(1, PATCH // 10)),
    ], np.float32)

    occ = draw_occlusion_mask(rng, occlusion_mask_dir, occlusion_files)

    gp = person.garment_parsing
    return dict(
        image=person.image,                                        # u8
        parsing=person.parsing.astype(np.uint8, copy=False),                   # u8
        garment_parsing=(gp.astype(np.uint8, copy=False) if gp is not None
                         else np.zeros_like(person.parsing, np.uint8)),
        sleeve_valid=np.asarray(1.0 if gp is not None else 0.0, np.float32),
        upper_lut=pp.label_lut(upper_labels),
        lower_lut=pp.label_lut(lower_labels),
        gt_lut=gt_lut,
        label_cls=np.asarray(cls, np.uint8),
        bound_row=np.asarray(bound_row, np.int32),
        upper_cut_m=mu, lower_cut_m=ml, paste_m_inv=pinv,
        part_valid=valid,
        tile_offsets=tile_offsets,
        tiles_fit=np.asarray(tiles_fit),
        cut_window_offsets=cut_window_offsets,
        cut_fits=np.asarray(cut_fits),
        erasure=erasure,
        occlusion=occ,
        **{k: np.asarray(v) for k, v in person.pose_params.items()},
        **{k: np.asarray(v) for k, v in palm_device_params(kps).items()},
        person_name=person.name,
    )


def batch_to_lean_inputs(items):
    """Stack lean per-sample dicts; returns (batch dict, tiled, windowed)."""
    tiled = all(bool(it["tiles_fit"]) for it in items)
    windowed = tiled and all(bool(it["cut_fits"]) for it in items)
    batch = {k: np.stack([it[k] for it in items])
             for k in items[0]
             if k not in ("tiles_fit", "cut_fits", "person_name")}
    return batch, tiled, windowed


def assemble_train_batch_lean(raw, tiled=True):
    """Device-side lean raw batch -> train-step inputs.

    `raw`: the batch of `batch_to_lean_inputs` as tensors on one device
    (`upload_batch`); everything here runs on that device. Mirrors
    preprocess_person_train + batch_to_train_inputs end to end: device
    conditioning (pose raster / palm / retain / skin -- data/device_cond.py),
    garment streams from routing LUTs, the 15-part cut/paste warps
    (data/device_warp.py, bilinear gathers), sleeve mirroring, erasure +
    occlusion augmentation, gt parsing, and the final normalization/concat.
    tiled=True takes the fixed-tile paste; the caller must have checked
    `tiles_fit` for every item (`batch_to_lean_inputs` does).
    """
    from .device_cond import (draw_pose_device, palm_mask_device,
                              retain_mask_device, skin_median_device,
                              garment_lut_mask)
    from .device_warp import (normalize_patches_device,
                              normalize_patches_device_tiled,
                              mirror_sleeves_device)

    parsing = raw["parsing"]
    b = parsing.shape[0]
    dev = parsing.device
    pose = draw_pose_device(
        raw["limb_pts"], raw["limb_valid"], raw["joint_pts"],
        raw["joint_valid"], raw["pose_xlim"])
    palm = palm_mask_device(raw["palm_quads"], raw["palm_valid"], parsing)
    retain_mask = retain_mask_device(parsing, palm)
    skin_rgb = skin_median_device(raw["image"], parsing)

    image_f = raw["image"].float()
    up = garment_lut_mask(raw["upper_lut"], parsing)
    low = garment_lut_mask(raw["lower_lut"], parsing)
    gp = raw["garment_parsing"]
    sleeve = ((gp == 10) | (gp == 11)).float()

    args = (up * image_f, low * image_f, up * 255.0, low * 255.0, sleeve,
            raw["upper_cut_m"].float(), raw["lower_cut_m"].float(),
            raw["paste_m_inv"].float(), raw["part_valid"])
    norm_kw = dict(erode_k=5, sleeve_valid=raw["sleeve_valid"])
    if tiled:
        norm = normalize_patches_device_tiled(*args, raw["tile_offsets"],
                                              **norm_kw)
    else:
        norm = normalize_patches_device(*args, **norm_kw)
    norm = mirror_sleeves_device(norm)

    # --- train-time lower-garment erasure (dataset.py:1139-1170) ----------
    imgs_l = norm["norm_img_lower"]
    masks_l = norm["norm_clothes_masks_lower"]
    m0 = masks_l[..., 0:1]
    present = (m0 >= 0.5).any(dim=3).any(dim=2)  # mask_to_bbox >=0.5; [B, P]
    row_idx = torch.arange(PATCH, device=dev)
    ty = torch.where(present, row_idx[None, :],
                     torch.full_like(row_idx, PATCH)[None, :]).amin(dim=1)
    exists = present.any(dim=1)
    r = raw["erasure"].float()                              # [B, 5]
    gate = (r[:, 0] < 0.8) & exists
    branch_a = r[:, 1] < 0.6
    strip = r[:, 2] < 0.75
    by = ty + 1 + torch.floor(r[:, 3] * (PATCH - ty).float()).long()
    erase_len = r[:, 4].long()

    in_strip = ((row_idx[None, :] >= ty[:, None])
                & (row_idx[None, :] < by[:, None]))         # [B, P]
    keep0 = torch.where(
        gate[:, None],
        torch.where(branch_a[:, None], torch.zeros_like(in_strip), ~in_strip),
        torch.ones_like(in_strip))
    keep13 = torch.where((gate & branch_a & strip)[:, None],
                         row_idx[None, :] >= erase_len[:, None],
                         torch.ones((b, PATCH), dtype=torch.bool, device=dev))
    parts = [imgs_l[..., i * 3:(i + 1) * 3] for i in range(5)]
    parts[0] = parts[0] * keep0[:, :, None, None].float()
    for i in (1, 3):
        parts[i] = parts[i] * keep13[:, :, None, None].float()
    norm_img_lower_train = torch.cat(parts, dim=-1)

    # --- occlusion + conditioning planes ----------------------------------
    occ = raw["occlusion"].float()
    denorm_upper = norm["denorm_upper_img"] * (1 - occ)
    denorm_lower = norm["denorm_lower_img"] * (1 - occ)

    p = parsing
    gt = garment_lut_mask(raw["gt_lut"], p)
    gt = gt + 5.0 * (p == 10)
    limbs = (p == 14) | (p == 15) | (p == 16) | (p == 17)
    gt = gt + 6.0 * limbs

    h = parsing.shape[1]
    yy = torch.arange(h, dtype=torch.int32, device=dev)
    bound = ((yy[None, :] >= raw["bound_row"][:, None]).float()
             * 255.0)[:, :, None, None].expand(b, h, h, 1)
    cls = raw["label_cls"].float()

    # --- final assembly (batch_to_train_inputs math) -----------------------
    norm01 = lambda x: x / 127.5 - 1.0
    image = norm01(image_f)
    retain = image * retain_mask - (1 - retain_mask)
    skin = (skin_rgb / 127.5 - 1.0)[:, None, None, :].expand(image.shape)
    return dict(
        real_img=image,
        pose=torch.cat([
            norm01(pose),
            (cls - 1.0)[:, None, None, None].expand(b, h, h, 1),
            norm01(bound)], dim=-1),
        style_input=torch.cat(
            [norm01(norm["norm_img"]), norm01(norm_img_lower_train)],
            dim=-1),
        retain=torch.cat([retain, skin], dim=-1),
        denorm_upper_input=norm01(denorm_upper),
        denorm_lower_input=norm01(denorm_lower),
        denorm_upper_mask=(
            denorm_upper.sum(dim=-1, keepdim=True) > 0).float(),
        denorm_lower_mask=(
            denorm_lower.sum(dim=-1, keepdim=True) > 0).float(),
        gt_parsing=gt.float(),
    )


def assemble_train_batch(raw):
    """Device-side raw batch -> train-step inputs; numerically identical to
    `batch_to_train_inputs` (runs on the device the raw tensors lie on, so
    the host->device transfer stays uint8)."""
    norm01 = lambda x: x.float() / 127.5 - 1.0
    image = norm01(raw["image"])
    n, h, w, _ = image.shape
    retain_mask = raw["retain_mask"].float()
    retain = image * retain_mask - (1 - retain_mask)
    skin = (raw["skin_rgb"].float() / 127.5 - 1.0)[:, None, None, :].expand(
        n, h, w, 3)
    denorm_upper = raw["denorm_upper_img"].float()
    denorm_lower = raw["denorm_lower_img"].float()
    return dict(
        real_img=image,
        pose=torch.cat([
            norm01(raw["pose"]),
            raw["lower_label_cls"].float() - 1.0,
            norm01(raw["lower_bound"])], dim=-1),
        style_input=torch.cat(
            [norm01(raw["norm_img"]), norm01(raw["norm_img_lower"])],
            dim=-1),
        retain=torch.cat([retain, skin], dim=-1),
        denorm_upper_input=denorm_upper / 127.5 - 1.0,
        denorm_lower_input=denorm_lower / 127.5 - 1.0,
        denorm_upper_mask=(
            denorm_upper.sum(dim=-1, keepdim=True) > 0).float(),
        denorm_lower_mask=(
            denorm_lower.sum(dim=-1, keepdim=True) > 0).float(),
        gt_parsing=raw["gt_parsing"].float(),
    )
