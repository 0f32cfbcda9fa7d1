"""The ADA geometric stage's batched affine warp, two-pass form, plain: a
frozen copy of the port's `ops/affine_warp.py` with the plain versions of
its row shift K2 and adjoint K3 in the kernels' place.

Each pass of the two-pass warp is a shared-rate 1-D resample (a banded
matrix built from iota, mirror boundary folded in, one batched matmul)
followed by a per-line fractional shift by the real-valued position q[r]:

  K2  out[r, x]   = (1 - f) wide[r, s + x] + f wide[r, s + x + 1]
  K3  dwide[r, c] = (1 - f) dout[r, c - s] + f dout[r, c - s - 1]

with q clamped to [0, V - out_w - 42], k = floor(q), f = q - k and s = kmin
+ clamp(k - kmin, 0, 38), kmin the least k of the row's block of 8 rows.
Here both are the port's plain forms: `_shift_prep` turns q into a
per-block start and a one-hot pair over 40 taps, summed in fp32.
`_ShiftApply` and `_ShiftAdjoint` are the port's pair of autograd
Functions whose backwards call each other, so R1's grad-of-grad through
the augmented real image takes the same route as in the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_TAPS = 40          # per-line tap window: covers |d shift/d line| * 8 + 2
_ROWS_PER_BLOCK = 8


def _mirror_coord(c, n):
    """Reflect (no edge repeat, torch 'reflect') into [0, n-1]."""
    m = n - 1
    t = torch.remainder(c, 2 * m)
    return torch.where(t > m, 2 * m - t, t)


def _shift_prep(q, out_w, v_dim):
    """From real-valued per-row positions q [R] (R a multiple of 8): the
    per-8-row-block 128-aligned base and remainder, and per-row [TAPS] tap
    weights (a one-hot pair; the tap offset is clamped to 38 past the
    block's minimum)."""
    r = q.shape[0]
    q = q.clamp(0.0, float(v_dim - out_w - _TAPS - 2))
    k = torch.floor(q)
    f = (q - k).float()
    k = k.to(torch.int32)
    kmin = k.view(r // _ROWS_PER_BLOCK, _ROWS_PER_BLOCK).amin(dim=1)
    base = torch.div(kmin, 128, rounding_mode="floor") * 128
    rem = kmin - base
    t = (k - kmin.repeat_interleave(_ROWS_PER_BLOCK)).clamp(0, _TAPS - 2)
    w = (F.one_hot(t.long(), _TAPS).float() * (1 - f)[:, None]
         + F.one_hot(t.long() + 1, _TAPS).float() * f[:, None])
    return base, rem, w


def _row_start(base, rem):
    """Per-row window start: base + rem repeated over each 8-row block."""
    return (base + rem).repeat_interleave(_ROWS_PER_BLOCK).to(torch.int32)


def _shift_rows_plain(wide, start, w, out_w):
    """Plain version of K2 with a per-row start: taps summed in fp32 in
    ascending order, columns past V read as 0, result in wide's dtype."""
    r, _ = wide.shape
    taps = w.shape[1]
    idx = start.long()[:, None] + torch.arange(out_w + taps,
                                               device=wide.device)[None]
    win = torch.gather(F.pad(wide, (0, out_w + taps)), 1, idx).float()
    out = torch.zeros((r, out_w), dtype=torch.float32, device=wide.device)
    for t in range(taps):
        out = out + w[:, t:t + 1] * win[:, t:t + out_w]
    return out.to(wide.dtype)


def _shift_rows_adjoint_plain(dout, start, w, v_dim):
    """Plain version of K3 with a per-row start: every [R, v_dim] element,
    zero outside each row's window."""
    r, out_w = dout.shape
    taps = w.shape[1]
    d32 = dout.float()
    dwin = torch.zeros((r, out_w + taps), dtype=torch.float32,
                       device=dout.device)
    for t in range(taps):
        dwin = dwin + F.pad(w[:, t:t + 1] * d32, (t, taps - t))
    idx = start.long()[:, None] + torch.arange(out_w + taps,
                                               device=dout.device)[None]
    dwide = torch.zeros((r, v_dim + out_w + taps), dtype=torch.float32,
                        device=dout.device).scatter(1, idx, dwin)
    return dwide[:, :v_dim].to(dout.dtype)


def _prep_rows(q, out_w, v_dim):
    """`_shift_prep` as the row kernels' plain versions take it: (start [R]
    int32, w [R, 40])."""
    base, rem, w = _shift_prep(q, out_w, v_dim)
    return _row_start(base, rem), w


def shift_fwd_plain(wide, q, out_w):
    """Plain version of K2 from q: `_shift_prep`, then the 40-tap sum."""
    return _shift_rows_plain(wide, *_prep_rows(q, out_w, wide.shape[1]),
                             out_w)


def shift_bwd_plain(dout, q, v_dim):
    """Plain version of K3 from q: `_shift_prep`, then the 40-tap adjoint."""
    return _shift_rows_adjoint_plain(
        dout, *_prep_rows(q, dout.shape[1], v_dim), v_dim)


# The shift and its adjoint are a mutually-defined linear pair: each
# Function's backward applies the other, so any tower of gradients (R1
# differentiates D(augment(x)) w.r.t. x and then w.r.t. D's parameters)
# stays on K2/K3. Neither differentiates q (it is stop-gradiented).

class _ShiftApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wide, q, out_w):
        ctx.save_for_backward(q)
        ctx.v_dim = wide.shape[1]
        return shift_fwd_plain(wide, q, out_w)

    @staticmethod
    def backward(ctx, dout):
        (q,) = ctx.saved_tensors
        return _ShiftAdjoint.apply(dout.contiguous(), q, ctx.v_dim), None, None


class _ShiftAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dout, q, v_dim):
        ctx.save_for_backward(q)
        ctx.out_w = dout.shape[1]
        return shift_bwd_plain(dout, q, v_dim)

    @staticmethod
    def backward(ctx, c):
        (q,) = ctx.saved_tensors
        return _ShiftApply.apply(c.contiguous(), q, ctx.out_w), None, None


def _row_shift(wide, q, out_w):
    """out[r, x] = (1-f) wide[r, k+x] + f wide[r, k+x+1], (k, f) = divmod q.

    wide: [R, V] (R a multiple of 8), q: [R] float positions (clamped to the
    valid window). Linear in `wide`; q is not differentiated."""
    return _ShiftApply.apply(wide.contiguous(),
                             q.detach().float().contiguous(), out_w)


# ---------------------------------------------------------------------------
# shared-rate mirror resample as a batched matmul
# ---------------------------------------------------------------------------

def _resample_matrix(alpha, w0, src_n, v_dim, dtype):
    """B[n, j, v]: bilinear taps of source column j at position
    alpha[n]*v + w0[n], mirror boundary folded in. Built from iota."""
    v = torch.arange(v_dim, dtype=torch.float32, device=alpha.device)[None]
    pos = alpha[:, None] * v + w0[:, None]                  # [n, V]
    fl = torch.floor(pos)
    fr = pos - fl
    j0 = _mirror_coord(fl, src_n)
    j1 = _mirror_coord(fl + 1, src_n)
    j = torch.arange(src_n, dtype=torch.float32,
                     device=alpha.device)[None, :, None]     # [1, J, 1]
    b = ((j0[:, None, :] == j) * (1 - fr)[:, None, :]
         + (j1[:, None, :] == j) * fr[:, None, :])
    return b.to(dtype)


def _safe(x, eps=1e-4):
    return torch.where(x.abs() < eps,
                       torch.where(x < 0, torch.full_like(x, -eps),
                                   torch.full_like(x, eps)), x)


def _warp_core_planar(xp, mat):
    """Two-pass warp on planar [n, c, H, W] input (square canvas). mat is
    the pixel-space [n, 3, 3] output->source map, (sx, sy, 1) =
    mat @ (x, y, 1). Returns planar [n, c, H, W]."""
    n, c, h, w = xp.shape
    if h != w:
        raise ValueError("two-pass warp assumes a square canvas")
    mat = mat.float()
    m00, m01, m02 = mat[:, 0, 0], mat[:, 0, 1], mat[:, 0, 2]
    m10, m11, m12 = mat[:, 1, 0], mat[:, 1, 1], mat[:, 1, 2]

    # rot90-normalize per sample: if |m01| > |m11|, read through a
    # quarter-turned source, img_q[y, x] = img[x, H-1-y], so pass 1's line
    # slope |m01/m11| <= 1; source coords (sx, sy) -> (sy, n-1-sx).
    swap = m01.abs() > m11.abs()
    img_q = xp.transpose(2, 3).flip(2)
    xp = torch.where(swap[:, None, None, None], img_q, xp)
    nm1 = float(h - 1)
    a00 = torch.where(swap, m10, m00)
    a01 = torch.where(swap, m11, m01)
    a02 = torch.where(swap, m12, m02)
    a10 = torch.where(swap, -m00, m10)
    a11 = torch.where(swap, -m01, m11)
    a12 = torch.where(swap, nm1 - m02, m12)

    det = a00 * a11 - a01 * a10
    a11s = _safe(a11)
    alpha1 = det / a11s                      # pass-1 resample rate
    beta1 = a01 / a11s                       # pass-1 per-row slope (|.|<=1)
    c1 = a02 - a01 * a12 / a11s

    v_dim = ((w + 2 * h + _TAPS + 127) // 128) * 128
    dtype = xp.dtype

    def one_pass(xq, alpha, beta, off, out_w):
        # xq: [n, c, L, J]  (resample along J, lines L)
        nn_, cc, ll, jj = xq.shape
        alpha_s = _safe(alpha)
        lines = torch.arange(ll, dtype=torch.float32, device=xq.device)
        qraw = (beta[:, None] * lines[None] + off[:, None]) / alpha_s[:, None]
        qmin = qraw.amin(dim=1)
        w0 = (qmin - 2.0) * alpha_s          # source-pos offset of v=0
        q = qraw - (qmin - 2.0)[:, None]     # per-line window start, >=2
        b = _resample_matrix(alpha_s, w0, jj, v_dim, dtype)
        wide = torch.matmul(xq, b[:, None])                  # [n, c, L, V]
        qrows = q[:, None, :].expand(nn_, cc, ll).reshape(-1)
        r = qrows.shape[0]
        pad_r = (-r) % _ROWS_PER_BLOCK
        widef = wide.reshape(r, v_dim)
        if pad_r:
            # Edge-pad qrows: zero-padding would drag the shared 8-row
            # block's kmin to 0 and clamp the real rows' tap offsets.
            widef = F.pad(widef, (0, 0, 0, pad_r))
            qrows = torch.cat([qrows, qrows[-1:].expand(pad_r)])
        out = _row_shift(widef, qrows, out_w)
        if pad_r:
            out = out[:r]
        return out.reshape(nn_, cc, ll, out_w)

    # pass 1: rows are source rows y_s; Sx(y_s, x_t) = alpha1 x_t + beta1 y_s + c1
    tmp = one_pass(xp, alpha1, beta1, c1, w)            # [n, c, y_s, x_t]
    # pass 2: lines are target columns x_t; Sy(x_t, y_t) = a11 y_t + a10 x_t + a12
    out_t = one_pass(tmp.transpose(2, 3), a11, a10, a12, h)
    return out_t.transpose(2, 3)                        # [n, c, y_t, x_t]


def upfirdn1d_matrix(f, n_in, up=1, down=1, pad0=0, pad1=0,
                     flip_filter=False, gain=1.0):
    """[n_out, n_in] numpy matrix equal to one separable axis pass of
    upfirdn2d (zero-stuff `up`, pad, correlate, stride `down`)."""
    f = np.asarray(f, np.float64) * float(gain)
    if not flip_filter:
        f = f[::-1]
    fl = len(f)
    n_out = (n_in * up + pad0 + pad1 - fl) // down + 1
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        for t in range(fl):
            k = i * down + t - pad0
            if 0 <= k < n_in * up and k % up == 0:
                m[i, k // up] += f[t]
    return m


def _upsample_matrix(f, n_in, up=2):
    """upsample2d's per-axis pass (gain included)."""
    fl = len(np.asarray(f))
    return upfirdn1d_matrix(
        f, n_in, up=up, pad0=(fl + up - 1) // 2, pad1=(fl - up) // 2,
        flip_filter=False, gain=up)


def _downsample_matrix(f, n_in, down=2, extra_pad=0):
    """downsample2d(padding=extra_pad, flip_filter=True)'s per-axis pass."""
    fl = len(np.asarray(f))
    return upfirdn1d_matrix(
        f, n_in, down=down, pad0=extra_pad + (fl - down + 1) // 2,
        pad1=extra_pad + (fl - down) // 2, flip_filter=True, gain=1)


def _fir_matrix(kind, taps, n_in, extra_pad, device, dtype):
    """`_upsample_matrix` / `_downsample_matrix` as a tensor on `device`."""
    m = (_upsample_matrix(taps, n_in) if kind == "up"
         else _downsample_matrix(taps, n_in, extra_pad=extra_pad))
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def geom_resample_twopass(images, mat_pix, f_taps, margin):
    """The ADA geometric stage as one planar pipeline: reflect-pad by
    `margin`, 2x FIR upsample, affine warp (`mat_pix` in up-canvas pixel
    coordinates), 2x FIR downsample with the margin cropped off. NHWC in
    and out; every 2x-canvas intermediate is planar [n, c, Y, X] and the
    FIR passes are matmuls."""
    n, h, w, c = images.shape
    if h != w:
        raise ValueError("two-pass warp assumes a square canvas")
    taps = tuple(float(t) for t in np.asarray(f_taps).ravel())
    xp = images.permute(0, 3, 1, 2)
    xp = F.pad(xp, (margin, margin, margin, margin), mode="reflect")
    npad = h + 2 * margin
    u = _fir_matrix("up", taps, npad, 0, xp.device, xp.dtype)
    xp = torch.matmul(xp, u.t())                 # upsample x
    xp = torch.matmul(u, xp)                     # upsample y
    xp = _warp_core_planar(xp, mat_pix)
    d = _fir_matrix("down", taps, 2 * npad, -2 * margin, xp.device, xp.dtype)
    xp = torch.matmul(xp, d.t())                 # downsample x + crop
    xp = torch.matmul(d, xp)                     # downsample y + crop
    return xp.permute(0, 2, 3, 1)
