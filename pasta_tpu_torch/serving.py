"""End-to-end try-on serving on one GPU: device preprocessing + generator
(port of pasta_tpu/serving.py, cond="device", gather warps).

The host does decode / keypoint parsing / label routing / homography solves
(numpy, data/host.py); everything else -- person conditioning rasters,
patch warps, erosion, compositing, sleeve mirroring, conflict zeroing,
input assembly and the generator forward -- runs as torch ops on the
device. The two-stage API of the JAX package (ingest_device, then
assemble_inputs_device) is kept; its TPU layout reason does not apply.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .data import device_cond as dc
from .data.device_warp import (MASK_THRESH, bound_from_mask_top, erode,
                               mirror_sleeves_device, normalize_patches_device,
                               normalize_patches_device_tiled,
                               zero_bound_above_mask_bottom,
                               zero_conflicts_device)
from .data.host import host_prepare

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


def _check_host_shapes(host, res):
    specs = {"image": (res, res, 3), "pose": (res, res, 3),
             "upper_img": (res, res, 3), "lower_img": (res, res, 3),
             "upper_mask": (res, res, 1), "lower_mask": (res, res, 1),
             "sleeve": (res, res, 1), "retain_mask": (res, res, 1),
             "bound": (res, res, 1), "skin_color": (3,)}
    for key, shape in specs.items():
        if tuple(host[key].shape[1:]) != shape:
            raise ValueError(f"host[{key}]: shape {tuple(host[key].shape)}, "
                             f"expected [B, {', '.join(map(str, shape))}]")


def assemble_inputs_device(host: Dict[str, torch.Tensor], mode: str,
                           tiled: bool = False):
    """Device: warps (bilinear gather) + assembly -> generator input dict.

    tiled=True uses the fixed-tile paste path; callers must have verified
    host["tiles_fit"] for every item. Accepts the raw host_prepare batch or
    ingest_device's output.
    """
    host = ingest_device(host)
    res = host["image"].shape[1]
    _check_host_shapes(host, res)
    erode_k = 8 if mode == "upper" else 5
    common = dict(erode_k=erode_k, track_wo_sleeve=(mode == "upper"),
                  sleeve_valid=host.get("sleeve_valid"))
    args = (host["upper_img"], host["lower_img"], host["upper_mask"],
            host["lower_mask"], host["sleeve"], host["upper_cut_m"],
            host["lower_cut_m"], host["paste_m_inv"], host["part_valid"])
    if tiled:
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


class TryonPipeline:
    """Batched serving on one device: host_prepare(cond="device") ->
    ingest_device -> assemble_inputs_device -> Generator, with the gather
    warps (the JAX package's warp_impl="auto" off the TPU) and
    noise_mode="const".

    `model` is the port's Generator with its weights loaded, on the device
    that serves. cond="host", the matmul warps, random noise, `mesh=` and
    `run_stream` of the JAX pipeline are not ported yet.
    """

    def __init__(self, model, mode="upper"):
        self.model = model
        self.mode = mode
        self.device = next(model.parameters()).device
        self.last_tiled = None

    def prepare(self, person, clothes, use_sleeve_mask=True):
        return host_prepare(person, clothes, self.mode, use_sleeve_mask,
                            cond="device")

    @torch.inference_mode()
    def run_batch(self, host_items):
        """host_prepare dicts -> finetune images [B, H, W, 3] fp32 on the
        device. Takes the tiled paste path when every item's quads fit.

        The JAX pipeline also selects cut windows when every item's cut
        quads fit (`cut_fits`); the windows feed only its matmul warps, and
        its gather cut reads the full source either way, as this one does.
        """
        tiled = all(bool(it["tiles_fit"]) for it in host_items)
        self.last_tiled = tiled
        batch = {
            k: torch.from_numpy(np.stack([it[k] for it in host_items])).to(
                self.device)
            for k in host_items[0] if k not in ("tiles_fit", "cut_fits")
        }
        inputs = assemble_inputs_device(ingest_device(batch), self.mode,
                                        tiled=tiled)
        _, finetune, _ = self.model(noise_mode="const", **inputs)
        return finetune
