"""Projective (homography) image warp as one-hot-pair matrix products, port
of pasta_tpu/ops/projective_warp.py.

The serving compositor's per-part cut/paste warps are cv2.warpPerspective
semantics (reference training/dataset.py:1069-1085): bilinear sampling at
``(sx, sy) = H @ (x, y, 1)`` (projected), zero outside the source. The
gather (data/device_warp.py) reads those taps directly; this module is the
JAX package's other backend, the exact Catmull-Smith two-pass
decomposition of the projective map with each pass a dense one-hot-pair
matrix product:

  pass 1 (per source row l, resample along x over output columns v):
      pos1(l, v) = ((A0 + A1 l) v + (B0 + B1 l)) / (C v + D)
      with A0 = a00 a11 - a01 a10,  A1 = a01 p - a00 q,
           B0 = a02 a11 - a01 a12,  B1 = a01 r - a02 q,
           C  = p a11 - q a10,      D  = r a11 - q a12
  pass 2 (per output column v, resample along source rows j):
      pos2(v, y) = (a10 v + a11 y + a12) / (p v + q y + r)

Each pass builds bilinear one-hot-pair weights and contracts them with the
image, ``out[c, v] = sum_j src[c, j] * W[j, v]`` per sample and line. The
JAX package computes these products with `jnp.einsum` outside any Pallas
kernel, and so does this port with `torch.einsum` (cuBLAS on the card);
they differentiate like any other op.

Numerics: the sampling positions of the gather (the same divisions, fp32),
but two chained 1-D linear interpolations instead of one 2-D bilinear --
exact where the source row position is integral, a slightly softened
(hat*hat) kernel elsewhere. Sources are quarter-turn-normalized per sample
first, so that a rotation-heavy map does not squeeze pass 1 into few
samples. `w_dtype=torch.bfloat16` rounds the one-hot weights to bf16 and
multiplies in fp32, as the JAX package's "matmul_bf16" does off the TPU
(bf16 weights, fp32 image, default precision: XLA promotes the product to
fp32); fp32 products stay fp32 because every entry point turns TF32 off
(`ops/_build.py::pin_fp32_numerics`), the JAX package's HIGHEST precision.
"""

from __future__ import annotations

import numpy as np
import torch


def _safe(x, eps=1e-9):
    small = x.abs() < eps
    return torch.where(small, torch.where(x < 0, torch.full_like(x, -eps),
                                          torch.full_like(x, eps)), x)


def _finite_or_far(pos, far=-1e6):
    """Sanitize positions: NaN/inf (horizon-line denominators) become a far
    out-of-range coordinate whose one-hot row is all zero (zero border)."""
    return torch.where(torch.isfinite(pos), pos.clamp(-1e6, 1e6),
                       torch.full_like(pos, far))


def _onehot_pair(pos, n_src, dtype):
    """Bilinear tap weights as a dense matrix over the source axis.

    pos: [N, L, V] sampling positions. Returns [N, L, n_src, V] (source
    axis inserted at -2) with (1-f) at floor(pos) and f at floor(pos)+1;
    taps outside [0, n_src) are dropped (zero border)."""
    pos = _finite_or_far(pos)[:, :, None, :]          # [N, L, 1, V]
    j = torch.arange(n_src, dtype=torch.float32,
                     device=pos.device)[None, None, :, None]
    # hat(pos - j): 1-f at floor(pos), f at floor(pos)+1, zero elsewhere
    return (1.0 - (pos - j).abs()).clamp_min(0.0).to(dtype)


def _rot90_source(img):
    """img_q[a, b] = img[b, H-1-a] for planar [N, C, H, W] (square)."""
    return img.transpose(2, 3).flip(2)


def _rot90_fold(mats, src_h):
    """Fold a quarter-turn of the source into the homography: with the
    source replaced by _rot90_source(img), sampling positions become
    (sx', sy') = (sy, (H-1) - sx)."""
    row0, row1, row2 = mats[:, 0], mats[:, 1], mats[:, 2]
    return torch.stack([row1, float(src_h - 1) * row2 - row0, row2], dim=1)


def _needs_rot90(mats, out_h, out_w):
    """True where sx varies more along y than x at the output center
    (rotation-heavy map: pass 1 would bottleneck)."""
    cx, cy = (out_w - 1) / 2.0, (out_h - 1) / 2.0
    a00, a01, a02 = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    p, q, r = mats[:, 2, 0], mats[:, 2, 1], mats[:, 2, 2]
    den = _safe(p * cx + q * cy + r)
    nx = a00 * cx + a01 * cy + a02
    dsx_dx = (a00 * den - nx * p) / (den * den)
    dsx_dy = (a01 * den - nx * q) / (den * den)
    return dsx_dy.abs() > dsx_dx.abs()


def _pass_coeffs(mats):
    a00, a01, a02 = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    a10, a11, a12 = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    p, q, r = mats[:, 2, 0], mats[:, 2, 1], mats[:, 2, 2]
    return dict(
        A0=a00 * a11 - a01 * a10, A1=a01 * p - a00 * q,
        B0=a02 * a11 - a01 * a12, B1=a01 * r - a02 * q,
        C=p * a11 - q * a10, D=r * a11 - q * a12,
        a10=a10, a11=a11, a12=a12, p=p, q=q, r=r,
    )


def _contract(spec, src, w):
    """The pass's product in the image's dtype: bf16 weights are rounded
    already and multiply in fp32."""
    return torch.einsum(spec, src, w.to(src.dtype))


def _warp_core(src_p, mats, out_h, out_w, w_dtype):
    """Planar [N, C, sh, sw] -> [N, C, out_h, out_w]; mats [N, 3, 3]."""
    _, _, sh, sw = src_p.shape
    dev = src_p.device
    k = {n: v[:, None, None] for n, v in _pass_coeffs(mats.float()).items()}

    ls = torch.arange(sh, dtype=torch.float32, device=dev)      # source rows
    vs = torch.arange(out_w, dtype=torch.float32, device=dev)   # out columns
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)   # out rows

    # pass 1: pos1[n, l, v]
    num = ((k["A0"] + k["A1"] * ls[None, :, None]) * vs[None, None, :]
           + (k["B0"] + k["B1"] * ls[None, :, None]))
    den = _safe(k["C"] * vs[None, None, :] + k["D"])
    w1 = _onehot_pair(num / den, sw, w_dtype)                   # [n, l, sw, v]
    tmp = _contract("nclj,nljv->nclv", src_p, w1)              # [n, c, l, v]
    del w1

    # pass 2: pos2[n, v, y] over source rows
    num2 = (k["a10"] * vs[None, :, None] + k["a11"] * ys[None, None, :]
            + k["a12"])
    den2 = _safe(k["p"] * vs[None, :, None] + k["q"] * ys[None, None, :]
                 + k["r"])
    w2 = _onehot_pair(num2 / den2, sh, w_dtype)                 # [n, v, sh, y]
    out_t = _contract("ncvj,nvjy->ncvy", tmp.transpose(2, 3), w2)
    return out_t.transpose(2, 3)


def warp_perspective_matmul(img, m_dst_to_src, out_h, out_w,
                            w_dtype=torch.float32, rot90_normalize=True):
    """Drop-in for data.device_warp.warp_perspective (NHWC in and out).

    img: [N, H, W, C] (square H == W when rot90_normalize); m_dst_to_src:
    [N, 3, 3] output-pixel -> source-pixel homography. Zero border. The
    quarter-turn choice is made per sample on the device: both sources
    are formed and one is picked by `torch.where`, so nothing waits for
    the host.
    """
    _, sh, sw, _ = img.shape
    src_p = img.permute(0, 3, 1, 2)
    m = m_dst_to_src.float()
    if rot90_normalize:
        assert sh == sw, "rot90 normalization assumes a square source"
        swap = _needs_rot90(m, out_h, out_w)
        src_p = torch.where(swap[:, None, None, None], _rot90_source(src_p),
                            src_p)
        m = torch.where(swap[:, None, None], _rot90_fold(m, sh), m)
    out = _warp_core(src_p, m, out_h, out_w, w_dtype)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def _extract_windows(sel_p, offsets, win):
    """Per-part source windows: sel_p [B, K, C, H, W] planar sources,
    offsets [B, K, 2] integer (y0, x0) origins, clamped by the caller to
    [0, H-win] / [0, W-win]. Returns [B, K, C, win, win].

    The JAX package selects the window by two integer one-hot products (a
    TPU avoids gathers); a product with a 0/1 matrix only copies values, so
    the rows and columns are read here by index, with the same result."""
    b, k, c, h, w = sel_p.shape
    span = torch.arange(win, device=sel_p.device)
    rows = (offsets[:, :, 0:1].long() + span)[:, :, None, :, None]
    out = torch.gather(sel_p, 3, rows.expand(b, k, c, win, w))
    cols = (offsets[:, :, 1:2].long() + span)[:, :, None, None, :]
    return torch.gather(out, 4, cols.expand(b, k, c, win, win))


def warp_perspective_matmul_multi(src_stack, src_idx, m_dst_to_src,
                                  out_h, out_w, part_chunk=None,
                                  w_dtype=torch.float32,
                                  weight_budget_bytes=768 * 1024 ** 2,
                                  src_window_offsets=None, src_window=0):
    """Drop-in for data.device_warp.warp_perspective_multi.

    src_stack: [B, S, H, W, C] candidate sources; src_idx: [P] host ints;
    m_dst_to_src: [B, P, 3, 3]. Returns [B, P, out_h, out_w, C].

    Parts go in chunks so that the one-hot weight tensors stay bounded
    transients: part_chunk=None sizes a chunk so that the larger pass's
    weights stay under `weight_budget_bytes` (a cut warp reads a 512^2
    source: one sample's pass-1 weights alone are 512*512*out_w elements,
    ~134 MB fp32 at out_w=128).

    src_window_offsets / src_window: per-part source windows for large
    sources -- [B, P, 2] integer (y0, x0) origins of src_window-sized
    crops covering each part's source quad (host-computed,
    `data/host.py::cut_window_layout`; the caller falls back to the full
    source when a quad exceeds its window). The crop origin folds into the
    matrices, and the dense pass weights shrink by (H/win) * (W/win).
    """
    b, _, sh, sw, c = src_stack.shape
    p = m_dst_to_src.shape[1]
    src_idx = np.asarray(src_idx)
    use_window = (src_window_offsets is not None
                  and 0 < src_window < min(sh, sw))
    eff_h, eff_w = (src_window, src_window) if use_window else (sh, sw)
    if part_chunk is None:
        itemsize = torch.empty((), dtype=w_dtype).element_size()
        bytes_per = itemsize * max(eff_h * eff_w * out_w,   # pass-1 weights
                                   out_w * eff_h * out_h)   # pass-2 weights
        part_chunk = max(1, min(p, int(weight_budget_bytes
                                       // (bytes_per * b))))
    outs = []
    for lo in range(0, p, part_chunk):
        hi = min(lo + part_chunk, p)
        k = hi - lo
        sel = torch.stack([src_stack[:, int(i)] for i in src_idx[lo:hi]],
                          dim=1)                             # [B, k, H, W, C]
        mats = m_dst_to_src[:, lo:hi].reshape(b * k, 3, 3).float()
        if use_window:
            off = src_window_offsets[:, lo:hi].long().clamp(
                0, max(sh, sw) - src_window)
            wins = _extract_windows(sel.permute(0, 1, 4, 2, 3), off,
                                    src_window)              # [B, k, C, w, w]
            flat = wins.reshape(b * k, c, src_window, src_window).permute(
                0, 2, 3, 1)
            # source coordinates shift by the crop origin:
            # rows 0 / 1 -= off * row 2
            offf = off.reshape(b * k, 2).float()
            mats = torch.stack([mats[:, 0] - offf[:, 1:2] * mats[:, 2],
                                mats[:, 1] - offf[:, 0:1] * mats[:, 2],
                                mats[:, 2]], dim=1)
        else:
            flat = sel.reshape(b * k, sh, sw, c)
        out = warp_perspective_matmul(flat, mats, out_h, out_w,
                                      w_dtype=w_dtype)
        outs.append(out.reshape(b, k, out_h, out_w, c))
    return torch.cat(outs, dim=1)
