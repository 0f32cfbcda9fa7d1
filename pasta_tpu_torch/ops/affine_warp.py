"""Batched affine image warp with mirror boundary, two-pass form, with the
per-row shift K2 and its adjoint K3 as hand-written Hopper kernels.

Port of pasta_tpu/ops/affine_warp.py. The ADA geometric stage warps each
image by a per-sample inverse affine matrix with bilinear sampling and
reflection. The two-pass form (Catmull & Smith) folds a quarter turn into
the source so the residual line slope is at most 1, then resamples rows and
columns in turn; each pass is a shared-rate 1-D resample (a banded matrix
built from iota, mirror boundary folded in, applied as one batched matmul)
followed by a per-line fractional shift by the real-valued position q[r]:

  K2  out[r, x]   = (1 - f) wide[r, s + x] + f wide[r, s + x + 1]  (shift_fwd)
  K3  dwide[r, c] = (1 - f) dout[r, c - s] + f dout[r, c - s - 1]  (shift_bwd)

with q clamped to [0, V - out_w - 42], k = floor(q), f = q - k and s = kmin
+ clamp(k - kmin, 0, 38), kmin the least k of the row's block of 8 rows
(the JAX package's blocking, which is part of its result). csrc/shift.cu
holds both kernels (CUDA C++ for sm_90a, built with nvcc at first use,
bound with ctypes); they take q and derive (s, f) themselves, so on a CUDA
tensor no op runs before the launch. `shift_fwd_rows` / `shift_bwd_rows`
launch the same kernels with (start, f) given per row, as the TPU design
probes of K2 have them.

The plain versions keep the JAX reference's form term for term: `_shift_prep`
turns q into a per-block start and a one-hot pair over 40 static taps, and
`_shift_rows_plain` / `_shift_rows_adjoint_plain` sum the 40 taps;
`shift_fwd_plain` and `shift_bwd_plain` are the two chained, the plain
versions of K2 and K3. One difference: for a non-finite `wide` the 40-tap
sum spreads 0 * inf = nan over 40 columns and the two-tap kernels do not;
the kernels are held to plain on finite inputs only.

`_ShiftApply` and `_ShiftAdjoint` are a pair of autograd Functions whose
backwards call each other, as the JAX package's custom_vjp pair does, so
R1's grad-of-grad through the augmented real image runs K2 and K3 again;
they save q ([R] fp32) and nothing else. On a CPU tensor the wrappers
compute the plain versions; on a CUDA tensor they launch the kernel or
raise. `shift_fwd.launches` and `shift_bwd.launches` count kernel launches.

The JAX package's `_spmd_wrap` (shard_map of the Pallas calls) is TPU
partitioning and is not ported. `bilinear_warp_gather` is the test oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ._build import load_library

_TAPS = 40          # per-line tap window: covers |d shift/d line| * 8 + 2
_ROWS_PER_BLOCK = 8
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _mirror_coord(c, n):
    """Reflect (no edge repeat, torch 'reflect') into [0, n-1]."""
    m = n - 1
    t = torch.remainder(c, 2 * m)
    return torch.where(t > m, 2 * m - t, t)


def bilinear_warp_gather(img, mat, out_hw=None):
    """Oracle warp: out[n, y, x] = img[n, sy, sx] bilinear with mirror, where
    (sx, sy, 1) = mat @ (x, y, 1) in pixel coordinates. NHWC."""
    n, h, w, _ = img.shape
    oh, ow = out_hw or (h, w)
    dev = img.device
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], 0)      # [3, oh, ow]
    src = torch.einsum("nij,jhw->nihw", mat.float(), coords)
    sx, sy = src[:, 0], src[:, 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    bi = torch.arange(n, device=dev)[:, None, None]

    def gather(yc, xc):
        yc = _mirror_coord(yc, h).long()
        xc = _mirror_coord(xc, w).long()
        return img[bi, yc, xc]

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


# ---------------------------------------------------------------------------
# per-line fractional shift
# ---------------------------------------------------------------------------

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


def _win(out_w):
    return ((out_w + _TAPS + 127) // 128 + 1) * 128


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


def _shift_fwd_plain(base, rem, w, wide, out_w):
    """Twin of the JAX package's `_shift_fwd_ref` (K2's plain version)."""
    return _shift_rows_plain(wide, _row_start(base, rem), w, out_w)


def _shift_bwd_plain(base, rem, w, dout, v_dim):
    """Twin of the JAX package's `_shift_bwd_ref` (K3's plain version)."""
    return _shift_rows_adjoint_plain(dout, _row_start(base, rem), w, v_dim)


def _prep_rows(q, out_w, v_dim):
    """`_shift_prep` as the row kernels' plain versions take it: (start [R]
    int32, w [R, 40])."""
    base, rem, w = _shift_prep(q, out_w, v_dim)
    return _row_start(base, rem), w


def _row_params_plain(q, out_w, v_dim):
    """The (s [R] int32, f [R] fp32) that K2 and K3 derive from q, read off
    `_shift_prep`'s result: s is the block's start plus the row's first
    non-zero tap (weight 1 - f > 0), f the weight of the tap after it."""
    start, w = _prep_rows(q, out_w, v_dim)
    t = (w != 0).int().argmax(dim=1)
    f = w.gather(1, (t + 1)[:, None])[:, 0]
    return start + t.to(torch.int32), f


def _two_taps(f):
    return torch.stack([1 - f, f], dim=1)


def shift_fwd_plain(wide, q, out_w):
    """Plain version of K2 from q: `_shift_prep`, then the 40-tap sum."""
    return _shift_rows_plain(wide, *_prep_rows(q, out_w, wide.shape[1]),
                             out_w)


def shift_bwd_plain(dout, q, v_dim):
    """Plain version of K3 from q: `_shift_prep`, then the 40-tap adjoint."""
    return _shift_rows_adjoint_plain(
        dout, *_prep_rows(q, dout.shape[1], v_dim), v_dim)


def _bind(lib):
    for fn in (lib.pasta_shift_fwd, lib.pasta_shift_bwd):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def build():
    """Compile csrc/shift.cu (once per source digest) and load it; returns
    (ctypes library, seconds spent compiling, compiler output)."""
    return load_library("shift.cu", _bind)


def _check(name, a, q, start, f, v_dim, out_w):
    """`a` [R, .] on a CUDA device in bf16/fp32, with either q [R] fp32 (R a
    multiple of 8, a non-empty clamp range) or start [R] int32 and f [R]
    fp32."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {a.dtype} not bf16/fp32")
    if a.ndim != 2 or a.shape[0] < 1 or v_dim < 1 or out_w < 1:
        raise ValueError(f"{name}: shape {tuple(a.shape)}, V {v_dim}, out_w "
                         f"{out_w}")
    r = a.shape[0]
    if q is not None:
        rows = [(q, torch.float32)]
        if r % _ROWS_PER_BLOCK or v_dim < out_w + _TAPS + 2:
            raise ValueError(f"{name}: from q, R = {r} must be a multiple of "
                             f"8 and V = {v_dim} >= out_w + 42 = {out_w + 42}")
    else:
        rows = [(start, torch.int32), (f, torch.float32)]
    for t, dtype in rows:
        if t.shape != (r,) or t.dtype != dtype:
            raise ValueError(f"{name}: per-row input {tuple(t.shape)} "
                             f"{t.dtype}, wanted ({r},) {dtype}")
    for t in [a] + [t for t, _ in rows]:
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous, one device")


def _plain_route(x):
    """CPU tensors take the plain version; every other device the kernel."""
    return x.device.type == "cpu"


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel(name, a, q, start, f, v_dim, out_w, return_rows=False):
    """One launch of K2 (name "shift_fwd": a = wide [R, v_dim]) or K3
    ("shift_bwd": a = dout [R, out_w]) into a fresh tensor with no autograd
    history. With `return_rows` also the (s, f) the kernel used."""
    _check(name, a, q, start, f, v_dim, out_w)
    lib, _, _ = build()
    r = a.shape[0]
    out = torch.empty((r, out_w if name == "shift_fwd" else v_dim),
                      dtype=a.dtype, device=a.device)
    s_out = f_out = None
    if return_rows:
        s_out = torch.empty(r, dtype=torch.int32, device=a.device)
        f_out = torch.empty(r, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = getattr(lib, "pasta_" + name)(
            a.data_ptr(), _ptr(q), _ptr(start), _ptr(f), out.data_ptr(),
            _ptr(s_out), _ptr(f_out), _DTYPE_CODE[a.dtype], r, v_dim, out_w,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed, CUDA error {err}")
    return (out, s_out, f_out) if return_rows else out


def shift_fwd(wide, q, out_w):
    """K2 from the rows' positions: wide [R, V] (bf16/fp32, R a multiple of
    8), q [R] fp32 -> [R, out_w]. The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _plain_route(wide):
        return shift_fwd_plain(wide, q, out_w)
    out = _kernel("shift_fwd", wide, q, None, None, wide.shape[1], out_w)
    shift_fwd.launches += 1
    return out


def shift_bwd(dout, q, v_dim):
    """K3, the adjoint of K2: dout [R, out_w], q [R] fp32 -> [R, v_dim]. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if _plain_route(dout):
        return shift_bwd_plain(dout, q, v_dim)
    dwide = _kernel("shift_bwd", dout, q, None, None, v_dim, dout.shape[1])
    shift_bwd.launches += 1
    return dwide


def shift_fwd_rows(wide, start, f, out_w):
    """K2 with the rows' (s, f) given: start [R] int32 in [0, V), f [R] fp32,
    any R (the design probes' form). Counts as a launch of K2."""
    if _plain_route(wide):
        return _shift_rows_plain(wide, start, _two_taps(f), out_w)
    out = _kernel("shift_fwd", wide, None, start, f, wide.shape[1], out_w)
    shift_fwd.launches += 1
    return out


def shift_bwd_rows(dout, start, f, v_dim):
    """K3 with the rows' (s, f) given. Counts as a launch of K3."""
    if _plain_route(dout):
        return _shift_rows_adjoint_plain(dout, start, _two_taps(f), v_dim)
    dwide = _kernel("shift_bwd", dout, None, start, f, v_dim, dout.shape[1])
    shift_bwd.launches += 1
    return dwide


shift_fwd.launches = 0
shift_bwd.launches = 0


# The shift and its adjoint are a mutually-defined linear pair: each
# Function's backward applies the other, so any tower of gradients (R1
# differentiates D(augment(x)) w.r.t. x and then w.r.t. D's parameters)
# stays on K2/K3. Neither differentiates q (it is stop-gradiented).

class _ShiftApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wide, q, out_w):
        ctx.save_for_backward(q)
        ctx.v_dim = wide.shape[1]
        return shift_fwd(wide, q, out_w)

    @staticmethod
    def backward(ctx, dout):
        (q,) = ctx.saved_tensors
        return _ShiftAdjoint.apply(dout.contiguous(), q, ctx.v_dim), None, None


class _ShiftAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dout, q, v_dim):
        ctx.save_for_backward(q)
        ctx.out_w = dout.shape[1]
        return shift_bwd(dout, q, v_dim)

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


def affine_warp_twopass(img, mat):
    """Two-pass warp with `bilinear_warp_gather`'s interface (square
    canvases, out size == in size), NHWC in and out."""
    out = _warp_core_planar(img.permute(0, 3, 1, 2), mat)
    return out.permute(0, 2, 3, 1)


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


def geom_resample_twopass(images, mat_pix, f_taps, margin):
    """The ADA geometric stage as one planar pipeline: reflect-pad by
    `margin`, 2x FIR upsample, affine warp (`mat_pix` in up-canvas pixel
    coordinates), 2x FIR downsample with the margin cropped off. NHWC in
    and out; every 2x-canvas intermediate is planar [n, c, Y, X] and the
    FIR passes are matmuls."""
    n, h, w, c = images.shape
    if h != w:
        raise ValueError("two-pass warp assumes a square canvas")
    f_taps = np.asarray(f_taps)
    xp = images.permute(0, 3, 1, 2)
    xp = F.pad(xp, (margin, margin, margin, margin), mode="reflect")
    npad = h + 2 * margin
    u = torch.from_numpy(_upsample_matrix(f_taps, npad)).to(
        device=xp.device, dtype=xp.dtype)
    xp = torch.matmul(xp, u.t())                 # upsample x
    xp = torch.matmul(u, xp)                     # upsample y
    xp = _warp_core_planar(xp, mat_pix)
    d = torch.from_numpy(
        _downsample_matrix(f_taps, 2 * npad, extra_pad=-2 * margin)).to(
            device=xp.device, dtype=xp.dtype)
    xp = torch.matmul(xp, d.t())                 # downsample x + crop
    xp = torch.matmul(d, xp)                     # downsample y + crop
    return xp.permute(0, 2, 3, 1)
