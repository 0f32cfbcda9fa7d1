"""Perceptual path length for the try-on generator, port of
pasta_tpu/metrics/ppl.py.

The reference PPL (metrics/perceptual_path_length.py:23-130) is stale for
this model family (it calls the PASTA-GAN-v1 generator signature); this is
the JAX package's working reimplementation for the conditional try-on
generator:

  * the endpoints are the style codes of two garment conditions (the
    model's latent is the 512-d style code, z_dim=0);
  * lerp (or slerp) at a random t, perturb by epsilon, synthesize both,
    and measure the scaled perceptual distance d(I_t, I_{t+eps}) / eps^2;
  * the perceptual metric is a pluggable feature extractor:
    `make_lpips_feature_fn(vgg16)` for the reference's VGG16-LPIPS space
    (squared feature distance == LPIPS), or any other [N, D] embedding.

`t` is drawn from an explicit torch.Generator (the JAX package draws it
from a PRNG key, so the two give other numbers from one seed); a caller
may hand `t` in.
"""

from __future__ import annotations

import numpy as np
import torch


def make_lpips_feature_fn(vgg16, downsample_to=256):
    """LPIPS embedding feature_fn for compute_ppl; images above
    `downsample_to` px are box-downsampled by an integer factor first
    (perceptual_path_length.py:78-84)."""

    def feature_fn(images_pm1):
        h = images_pm1.shape[1]
        if downsample_to and h > downsample_to:
            factor = h // downsample_to
            n, hh, ww, c = images_pm1.shape
            images_pm1 = images_pm1.reshape(
                n, hh // factor, factor, ww // factor, factor, c).mean(
                    dim=(2, 4))
        return vgg16.lpips_features(images_pm1)

    return feature_fn


def lerp(a, b, t):
    return a + (b - a) * t


def slerp(a, b, t):
    a_n = a / a.norm(dim=-1, keepdim=True)
    b_n = b / b.norm(dim=-1, keepdim=True)
    d = (a_n * b_n).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1, 1))
    c = b_n - d * a_n
    c = c / (c.norm(dim=-1, keepdim=True) + 1e-12)
    d_out = a_n * torch.cos(p) + c * torch.sin(p)
    return d_out * a.norm(dim=-1, keepdim=True)


def compute_ppl(
    synth_from_code,     # (style_code [N, 512]) -> images [N, H, W, 3]
    feature_fn,          # (images) -> [N, D] perceptual features
    codes_a, codes_b,    # [N, 512] endpoint style codes
    generator=None,      # torch.Generator on the codes' device, for t
    epsilon=1e-4,
    interp="lerp",
    crop=None,           # (y0, y1, x0, x1) crop before the features
    t=None,              # [N, 1] path positions; drawn when None
):
    """Mean scaled perceptual distance along the style interpolation path:
    the trimmed mean between the 1st and 99th percentiles, or the plain
    mean where n is so small that the percentiles exclude every sample."""
    n = codes_a.shape[0]
    if t is None:
        t = torch.rand((n, 1), generator=generator, device=codes_a.device)
    t = torch.as_tensor(t, dtype=codes_a.dtype, device=codes_a.device)
    interp_fn = lerp if interp == "lerp" else slerp
    with torch.no_grad():
        img0 = synth_from_code(interp_fn(codes_a, codes_b, t))
        img1 = synth_from_code(interp_fn(codes_a, codes_b, t + epsilon))
        if crop is not None:
            y0, y1, x0, x1 = crop
            img0 = img0[:, y0:y1, x0:x1]
            img1 = img1[:, y0:y1, x0:x1]
        d = (feature_fn(img0) - feature_fn(img1)).square().sum(dim=-1) \
            / (epsilon ** 2)
    d = d.float().cpu().numpy()
    lo, hi = np.percentile(d, [1, 99])
    kept = d[(d >= lo) & (d <= hi)]
    return float(kept.mean() if kept.size else d.mean())


def build_tryon_ppl_ctx(model, dataroot, pairs, part="upper",
                        use_sleeve_mask=True):
    """Conditional-PPL context for the registered `ppl` metric, on the
    device of `model` (the port's Generator with its weights loaded).

    The endpoints are the style codes of two garment conditions on the
    same person: codes_a = (person, their own garment), codes_b = (person,
    the pair's garment). The synthesis runs on the pair condition's
    assembled inputs; only the style code moves (mapping, the pose
    encoder, the retain pyramid and the synthesis network, noise "const").

    Returns dict(synth_from_code, codes_a, codes_b) for compute_ppl.
    """
    from ..data import preprocess as pp
    from ..serving import (assemble_inputs_device, host_prepare,
                           ingest_device)

    device = next(model.parameters()).device
    items_a, items_b = [], []
    for clothes_name, person_name in pairs:
        person = pp.load_person(dataroot, person_name)
        clothes = pp.load_person(dataroot, clothes_name,
                                 with_garment_parsing=True)
        own = pp.load_person(dataroot, person_name,
                             with_garment_parsing=True)
        items_a.append(host_prepare(person, own, part, use_sleeve_mask))
        items_b.append(host_prepare(person, clothes, part, use_sleeve_mask))

    def to_inputs(items):
        batch = {}
        for k in items[0]:
            if k != "tiles_fit":
                t = torch.from_numpy(np.stack([np.asarray(it[k])
                                               for it in items]))
                # float64 as float32, what jnp.asarray makes of it
                batch[k] = (t.float() if t.dtype == torch.float64
                            else t).to(device)
        return assemble_inputs_device(ingest_device(batch), part)

    with torch.no_grad():
        inputs_a = to_inputs(items_a)
        inputs_b = to_inputs(items_b)
        codes_a = model.style_code(inputs_a["c"], inputs_a["retain"])
        codes_b = model.style_code(inputs_b["c"], inputs_b["retain"])

    def synth_from_code(code):
        # The metric may take fewer codes (--max-items): the conditioning
        # batch is cut to match.
        n = code.shape[0]
        cond = {k: v[:n] for k, v in inputs_b.items()}
        with torch.no_grad():
            ws = model.mapping(torch.zeros((n, 0), device=device), code)
            pose_feat = model.const_encoding(
                cond["pose"].to(model.enc_dtype))
            _, feats = model.style_encoding(cond["c"].to(model.enc_dtype),
                                            cond["retain"].to(
                                                model.enc_dtype))
            cat_feats = {str(f.shape[1]): f for f in feats}
            _, finetune, _ = model.synthesis(
                ws, pose_feat, cat_feats, cond["denorm_upper_input"],
                cond["denorm_lower_input"], cond["denorm_upper_mask"],
                cond["denorm_lower_mask"], None, noise_mode="const")
        return finetune.float()

    return dict(synth_from_code=synth_from_code, codes_a=codes_a,
                codes_b=codes_b)
