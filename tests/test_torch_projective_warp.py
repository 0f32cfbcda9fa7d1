"""The port's one-hot matmul warps (pasta_tpu_torch/ops/projective_warp.py)
against pasta_tpu/ops/projective_warp.py on the CPU: random perspective
quads, quarter turns (the per-sample rot90 normalization, both branches in
one batch), the source windows with their crop origins folded into the
matrices, the part chunking, bf16 one-hot weights, and the gradient with
respect to the source.

Tolerance: 1e-4 of the value range (0..255) for every output and, for the
gradient, 1e-4 of its largest magnitude. Both packages form the same fp32
positions and weights; the products sum in other orders.
"""

import functools

import numpy as np
import pytest
import torch
import cv2
import jax
import jax.numpy as jnp

from pasta_tpu.data.device_warp import cut_window_layout
from pasta_tpu.ops import projective_warp as jpw
from pasta_tpu_torch.data import device_warp as tdw
from pasta_tpu_torch.ops import projective_warp as tpw

TOL = 1e-4 * 255.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand_h(rng, src=64, out=64, persp=0.3, scale_lo=0.2, scale_hi=0.45):
    """dst->src homography of a random rotated / perspective quad."""
    dst = np.float32([[0, 0], [out - 1, 0], [out - 1, out - 1], [0, out - 1]])
    ang = rng.uniform(0, 2 * np.pi)
    rot = np.float32([[np.cos(ang), -np.sin(ang)],
                      [np.sin(ang), np.cos(ang)]])
    base = np.float32([[-1, -1], [1, -1], [1, 1], [-1, 1]]) \
        * rng.uniform(src * scale_lo, src * scale_hi)
    quad = (base @ rot.T) + src / 2 + rng.uniform(
        -persp * src * 0.2, persp * src * 0.2, (4, 2)).astype(np.float32)
    return cv2.getPerspectiveTransform(dst, quad.astype(np.float32))


def _smooth(rng, n, s, c):
    x = rng.uniform(0, 255, (n, s, s, c)).astype(np.float32)
    return np.stack([cv2.GaussianBlur(v, (5, 5), 1.2).reshape(s, s, c)
                     for v in x])


def _run_jax(w_dtype, fn, *args):
    """fn jitted for fp32 weights; op by op for bf16 weights, whose einsum
    then rounds the weights to bf16 and multiplies in fp32, as the port
    does (jitted, XLA's CPU dot takes the bf16 operand as it is)."""
    return (fn if w_dtype == "bfloat16" else jax.jit(fn))(*args)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_random_quads_and_quarter_turns(w_dtype):
    """Six random quads (some rotation-heavy: rot90 taken per sample), a
    pure quarter turn and an all-zero (invalid part) matrix, one batch."""
    rng = np.random.RandomState(3)
    src = _smooth(rng, 8, 48, 3)
    mats = [_rand_h(rng, src=48, out=40) for _ in range(6)]
    turn = np.zeros((3, 3))
    turn[0, 1], turn[1, 0], turn[1, 2], turn[2, 2] = 1.0, -1.0, 47.0, 1.0
    mats = np.stack(mats + [turn, np.zeros((3, 3))]).astype(np.float32)
    swaps = np.asarray(jpw._needs_rot90(jnp.asarray(mats), 40, 40))
    assert swaps.any() and not swaps.all()
    np.testing.assert_array_equal(
        tpw._needs_rot90(torch.from_numpy(mats), 40, 40).numpy(), swaps)
    got = tpw.warp_perspective_matmul(
        torch.from_numpy(src), torch.from_numpy(mats), 40, 40,
        w_dtype=getattr(torch, w_dtype))
    warp = functools.partial(
        jpw.warp_perspective_matmul, out_h=40, out_w=40,
        w_dtype=getattr(jnp, w_dtype),
        precision=(jax.lax.Precision.HIGHEST if w_dtype == "float32"
                   else jax.lax.Precision.DEFAULT))
    ref = _run_jax(w_dtype, warp, jnp.asarray(src), jnp.asarray(mats))
    assert np.isfinite(got.numpy()).all()
    _close(got, ref)


def test_multi_windows_and_chunks():
    """The multi-part warp with per-part source windows (the host's layout)
    and a weight budget that forces one part a chunk, against the JAX
    function; the windowed warp also agrees with the unwindowed one."""
    rng = np.random.RandomState(9)
    stack = rng.uniform(0, 255, (2, 2, 128, 128, 3)).astype(np.float32)
    src_idx = np.array([0, 1, 0])
    mats = []
    for _ in range(2):
        row = []
        for _ in range(3):
            m = _rand_h(rng, src=48, out=32, scale_lo=0.15, scale_hi=0.28)
            t = np.eye(3)
            t[0, 2], t[1, 2] = rng.randint(0, 70), rng.randint(0, 70)
            row.append(t @ m)
        mats.append(np.stack(row))
    mats = np.stack(mats).astype(np.float32)
    offs = np.zeros((2, 3, 2), np.int32)
    for b in range(2):
        offs[b], fits = cut_window_layout(mats[b], [True] * 3, res=128,
                                          win=64, margin=4, patch=32)
        assert fits
    args_t = (torch.from_numpy(stack), src_idx, torch.from_numpy(mats), 32,
              32)
    args_j = (jnp.asarray(stack), src_idx, jnp.asarray(mats), 32, 32)
    win_t = tpw.warp_perspective_matmul_multi(
        *args_t, src_window_offsets=torch.from_numpy(offs), src_window=64,
        weight_budget_bytes=1)
    win_j = jax.jit(lambda s, m, o: jpw.warp_perspective_matmul_multi(
        s, src_idx, m, 32, 32, src_window_offsets=o, src_window=64))(
        args_j[0], args_j[2], jnp.asarray(offs))
    _close(win_t, win_j)
    full_t = tpw.warp_perspective_matmul_multi(*args_t)
    _close(full_t, jax.jit(lambda s, m: jpw.warp_perspective_matmul_multi(
        s, src_idx, m, 32, 32))(args_j[0], args_j[2]))
    _close(win_t, full_t, tol=1e-2)   # the JAX package's own budget
    # the windows alone: exact copies of the source
    sel = torch.from_numpy(stack)[:, src_idx].permute(0, 1, 4, 2, 3)
    wins = tpw._extract_windows(sel, torch.from_numpy(offs), 64)
    ref = jax.jit(jpw._extract_windows, static_argnums=2)(
        jnp.asarray(sel.numpy()), jnp.asarray(offs), 64)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(ref))


def test_matches_gather_on_axis_aligned_maps():
    """Where the two passes are exact (integer shifts, axis-aligned scale)
    the matmul warp gives the gather's values."""
    rng = np.random.RandomState(2)
    src = rng.uniform(0, 255, (2, 64, 64, 2)).astype(np.float32)
    m = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    m[:, 0, 0] = [0.53, 1.0]
    m[:, 0, 2] = [3.0, -9.0]
    m[:, 1, 2] = [0.0, 12.0]
    t = [torch.from_numpy(src), torch.from_numpy(m)]
    _close(tpw.warp_perspective_matmul(*t, 48, 48),
           tdw.warp_perspective(*t, 48, 48))


def test_gradient_wrt_source():
    rng = np.random.RandomState(8)
    src = _smooth(rng, 2, 32, 2)
    m = np.stack([_rand_h(rng, src=32, out=32) for _ in range(2)]
                 ).astype(np.float32)
    x = torch.from_numpy(src).requires_grad_(True)
    (tpw.warp_perspective_matmul(x, torch.from_numpy(m), 32, 32) ** 2
     ).sum().backward()
    ref = jax.jit(jax.grad(lambda v: jnp.sum(jpw.warp_perspective_matmul(
        v, jnp.asarray(m), 32, 32) ** 2)))(jnp.asarray(src))
    g = x.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    _close(g, ref, tol=1e-4 * np.abs(np.asarray(ref)).max())
