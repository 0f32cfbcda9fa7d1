"""The reference try-on: records of a data root and a weight dict in, the
finetune images out, in plain PyTorch at fp32 with TF32 off (or on, for
the control). `compute_device_cond`, `ingest_device` and
`assemble_inputs_device` are frozen copies of the port's serving stages;
`prepare_pair` and `upload` do what its pipeline does around them, without
pinned staging or threads."""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from .data import device_cond as dc
from .data import preprocess as pp
from .data.device_warp import (MASK_THRESH, bound_from_mask_top, erode,
                               mirror_sleeves_device, normalize_patches_device,
                               normalize_patches_device_tiled,
                               resolve_warp_impl, zero_bound_above_mask_bottom,
                               zero_conflicts_device)
from .data.host import CUT_WINDOW, host_prepare
from .data.roots import as_root
from .models.generator import Generator
from .shapes import assert_batch_shapes

_INGEST_F32_KEYS = ("upper_img", "lower_img", "upper_mask", "lower_mask",
                    "sleeve", "image", "pose", "retain_mask", "bound")


def compute_device_cond(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw parsing/image planes + scalar params -> every host-mode
    conditioning array (pose, retain_mask, skin_color, masked garment
    streams, label/bound planes)."""
    out = dict(host)
    parsing = out.pop("parsing")
    out["pose"] = dc.draw_pose_device(
        out.pop("limb_pts"), out.pop("limb_valid"),
        out.pop("joint_pts"), out.pop("joint_valid"), out.pop("pose_xlim"))
    palm = dc.palm_mask_device(out.pop("palm_quads"), out.pop("palm_valid"),
                               parsing)
    out["retain_mask"] = dc.retain_mask_device(parsing, palm)
    out["skin_color"] = dc.skin_median_device(host["image"], parsing)

    up = dc.garment_lut_mask(out.pop("upper_lut"), out.pop("upper_src_parsing"))
    low = dc.garment_lut_mask(out.pop("lower_lut"),
                              out.pop("lower_src_parsing"))
    out["upper_img"] = up * out.pop("upper_src_image").float()
    out["lower_img"] = low * out.pop("lower_src_image").float()
    out["upper_mask"] = up * 255.0
    out["lower_mask"] = low * 255.0
    gp = out.pop("sleeve_parsing")
    out["sleeve"] = ((gp == 10) | (gp == 11)).float()

    b, h = parsing.shape[0], parsing.shape[1]
    cls = out.pop("label_cls").float()
    out["label"] = (cls * 127.5)[:, None, None, None].expand(b, h, h, 1)
    row = out.pop("bound_row")
    yy = torch.arange(h, dtype=torch.int32, device=parsing.device)
    out["bound"] = (((yy[None, :] >= row[:, None]).float() * 255.0)
                    [:, :, None, None].expand(b, h, h, 1))
    return out


def ingest_device(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stage 1: uint8 host arrays -> fp32 model-input planes, with the
    person conditioning computed on the device for cond="device" batches."""
    out = dict(host)
    if "parsing" in out:
        out = compute_device_cond(out)
    for k in _INGEST_F32_KEYS:
        out[k] = out[k].float()
    if "label" not in out:
        out["label"] = out["label_cls"].float() * 127.5
    out.pop("label_cls", None)
    return out


def assemble_inputs_device(host: Dict[str, torch.Tensor], mode: str,
                           tiled: bool = False, warp_impl: str = "auto",
                           cut_windowed: bool = False):
    """Device: warps + assembly -> generator input dict.

    tiled=True uses the fixed-tile paste path; callers must have verified
    host["tiles_fit"] for every item. warp_impl: "auto" (the gather, as
    the JAX package resolves it off its TPU), "gather", "matmul" (one-hot
    two-pass, fp32 weights) or "matmul_bf16" (bf16 weights).
    cut_windowed=True (tiled only; callers must have verified
    host["cut_fits"] for every item) reads each cut warp's source through
    its CUT_WINDOW window, which serves the matmul warps alone. Accepts
    the raw host_prepare batch or ingest_device's output.
    """
    host = ingest_device(host)
    res = host["image"].shape[1]
    # input contracts (reference misc.assert_shape style): a transposed or
    # mis-stacked host array fails here by name, not inside the warps
    assert_batch_shapes(host, {
        "image": (None, res, res, 3), "pose": (None, res, res, 3),
        "upper_img": (None, res, res, 3), "lower_img": (None, res, res, 3),
        "upper_mask": (None, res, res, 1), "lower_mask": (None, res, res, 1),
        "sleeve": (None, res, res, 1),
        "retain_mask": (None, res, res, 1), "bound": (None, res, res, 1),
        "upper_cut_m": (None, None, 3, 3), "lower_cut_m": (None, None, 3, 3),
        "paste_m_inv": (None, None, 3, 3), "skin_color": (None, 3),
    }, name="host")
    erode_k = 8 if mode == "upper" else 5
    common = dict(erode_k=erode_k, track_wo_sleeve=(mode == "upper"),
                  warp_impl=warp_impl, sleeve_valid=host.get("sleeve_valid"))
    args = (host["upper_img"], host["lower_img"], host["upper_mask"],
            host["lower_mask"], host["sleeve"], host["upper_cut_m"],
            host["lower_cut_m"], host["paste_m_inv"], host["part_valid"])
    if tiled:
        if cut_windowed and "cut_window_offsets" in host:
            common.update(cut_window_offsets=host["cut_window_offsets"],
                          cut_window=CUT_WINDOW)
        norm = normalize_patches_device_tiled(*args, host["tile_offsets"],
                                              **common)
    else:
        norm = normalize_patches_device(*args, **common)
    if mode in ("upper", "lower"):
        norm = zero_conflicts_device(norm)
    norm = mirror_sleeves_device(norm)

    denorm_upper = norm["denorm_upper_img"]
    denorm_lower = norm["denorm_lower_img"]
    bound = host["bound"]
    if mode == "upper":
        kept = (erode(host["lower_mask"], 8) >= MASK_THRESH).float()
        denorm_lower = host["lower_img"] * kept
        wo_sleeve_mask = (norm["denorm_upper_img_wo_sleeve"].sum(
            dim=-1, keepdim=True) > 0).float()
        bound = zero_bound_above_mask_bottom(bound, wo_sleeve_mask)
    if mode == "lower":
        kept = (erode(host["upper_mask"], 8) >= MASK_THRESH).float()
        denorm_upper = host["upper_img"] * kept
    if mode == "full":
        denorm_lower_mask = (denorm_lower.sum(dim=-1, keepdim=True)
                             > 0).float()
        bound = (bound_from_mask_top(denorm_lower_mask)
                 * host["dress_transfer"][:, None, None, None])

    def norm01(x):
        return x / 127.5 - 1.0

    image = norm01(host["image"])
    retain = image * host["retain_mask"] - (1 - host["retain_mask"])
    n = image.shape[0]
    skin = norm01(host["skin_color"])[:, None, None, :].expand(image.shape)
    return dict(
        z=torch.zeros((n, 0), device=image.device),
        c=torch.cat([norm01(norm["norm_img"]),
                     norm01(norm["norm_img_lower"])], dim=-1),
        retain=torch.cat([retain, skin], dim=-1),
        pose=torch.cat([norm01(host["pose"]), norm01(host["label"]),
                        norm01(bound)], dim=-1),
        denorm_upper_input=norm01(denorm_upper),
        denorm_lower_input=norm01(denorm_lower),
        denorm_upper_mask=(denorm_upper.sum(dim=-1, keepdim=True)
                           > 0).float(),
        denorm_lower_mask=(denorm_lower.sum(dim=-1, keepdim=True)
                           > 0).float(),
    )


def prepare_pair(root, pair, mode="upper", cond="device",
                 use_sleeve_mask=True):
    """Decode a (person, clothes) pair of a data root and run the host
    stage on it, as the port's pipeline does on its prep threads."""
    pn, cn = pair
    sleeve_for = "person" if mode == "lower" else "clothes"
    person = pp.load_person(
        root, pn, pose_raster="device" if cond == "device" else "host",
        with_garment_parsing=use_sleeve_mask and sleeve_for == "person")
    clothes = pp.load_person(
        root, cn, pose_raster="device",
        with_garment_parsing=use_sleeve_mask and sleeve_for == "clothes")
    return host_prepare(person, clothes, mode, use_sleeve_mask, cond=cond)


def upload(items, device):
    """Stack each host array of the items onto `device`."""
    return {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items]))
            .to(device) for k in items[0] if k not in ("tiles_fit", "cut_fits")}


@contextlib.contextmanager
def matmul_precision(tf32):
    """fp32 products in full (tf32 False) or in TF32 (the control), in
    cuDNN and cuBLAS, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class ReferenceTryon:
    """The generator of `gen_kwargs` holding `weights` (a state dict by
    the reference's names), on `device`, and the path in front of it."""

    def __init__(self, gen_kwargs, weights, device, mode="upper",
                 cond="device", noise_mode="const", warp_impl="auto"):
        model = Generator(seed=None, **gen_kwargs).to(device)
        model.load_state_dict(weights)
        self.model = model.eval()
        self.device = torch.device(device)
        self.mode, self.cond, self.noise_mode = mode, cond, noise_mode
        self.warp_impl = resolve_warp_impl(warp_impl)

    @torch.no_grad()
    def inputs(self, items, tf32=False):
        """The generator's inputs of host items, taking the tiled paste
        path when every item's quads fit."""
        tiled = all(bool(it["tiles_fit"]) for it in items)
        with matmul_precision(tf32):
            return assemble_inputs_device(
                ingest_device(upload(items, self.device)), self.mode,
                tiled=tiled, warp_impl=self.warp_impl)

    @torch.no_grad()
    def forward(self, inputs, tf32=False):
        """The finetune images [B, H, W, 3] (fp32, on the device)."""
        with matmul_precision(tf32):
            _, finetune, _ = self.model(noise_mode=self.noise_mode, **inputs)
        return finetune

    def images(self, items, tf32=False):
        """Finetune images of host items: `inputs`, then `forward`."""
        return self.forward(self.inputs(items, tf32), tf32)
