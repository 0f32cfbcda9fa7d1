"""The port's two-pass ADA warp (ops/affine_warp.py) against pasta_tpu's.

Same seeded numpy inputs on both sides. K2/K3's plain versions are held
against the Pallas kernels themselves (they run in interpret mode off a
TPU, `interpret=jax.default_backend() != "tpu"`) and against the JAX
package's plain references. Tolerances: fp32 sums of the same 40 taps in
the same order, 1e-6 absolute on O(1) values; bf16 outputs one rounding of
an fp32 sum, 2^-7 of the output scale; the bf16 two-pass pipeline also
rounds each matmul's output, 2^-6 of the scale.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.ops import affine_warp as J
from pasta_tpu.ops import setup_filter as jax_setup_filter
from pasta_tpu.train.augment import WAVELETS
from pasta_tpu_torch.ops import affine_warp as P


H = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q(rows, hi, seed):
    """Per-row positions with the training path's bounded line slope, some
    past either clamp and some spread past 38 taps within a block."""
    rng = np.random.RandomState(seed)
    q = 30 + 0.8 * np.arange(rows) % (hi - 30) + rng.rand(rows)
    q[::11] = hi + 5.0
    q[3::13] = -2.0
    q[5::7] += 50 * rng.rand(len(q[5::7]))
    return q.astype(np.float32)


@pytest.mark.parametrize("rows,v_dim,out_w", [(32, 384, 128), (64, 512, 152)])
def test_shift_prep_equals_jax(rows, v_dim, out_w):
    q = _q(rows, v_dim - out_w - 42, rows)
    jb, jr, jw = J._shift_prep(jnp.asarray(q), out_w, v_dim)
    pb, pr, pw = P._shift_prep(torch.from_numpy(q), out_w, v_dim)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))


def _shift_inputs(dtype, rows=32, v_dim=384, out_w=128, seed=0):
    rng = np.random.RandomState(seed)
    q = _q(rows, v_dim - out_w - 42, seed + 1)
    wide = rng.randn(rows, v_dim).astype(np.float32)
    dout = rng.randn(rows, out_w).astype(np.float32)
    jb, jr, jw = J._shift_prep(jnp.asarray(q), out_w, v_dim)
    pb, pr, pw = P._shift_prep(torch.from_numpy(q), out_w, v_dim)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    return ((jb, jr, jw, jnp.asarray(wide, jd), jnp.asarray(dout, jd)),
            (pb, pr, pw, torch.from_numpy(wide).to(td),
             torch.from_numpy(dout).to(td)), v_dim, out_w)


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    scale = np.abs(ref).max()
    atol = 1e-6 if dtype == "fp32" else 2.0 ** -7 * scale
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_k2_k3_vs_pallas_kernels(dtype):
    (jb, jr, jw, jwide, jdout), (pb, pr, pw, pwide, pdout), v, ow = \
        _shift_inputs(dtype)
    _close(P._shift_fwd_plain(pb, pr, pw, pwide, ow),
           J._shift_fwd_pallas(jb, jr, jw, jwide, ow), dtype)
    _close(P._shift_bwd_plain(pb, pr, pw, pdout, v),
           J._shift_bwd_pallas(jb, jr, jw, jdout, v), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_k2_k3_vs_jax_refs(dtype):
    (jb, jr, jw, jwide, jdout), (pb, pr, pw, pwide, pdout), v, ow = \
        _shift_inputs(dtype, rows=48, v_dim=512, out_w=152, seed=3)
    _close(P._shift_fwd_plain(pb, pr, pw, pwide, ow),
           J._shift_fwd_ref(jb, jr, jw, jwide, ow), dtype)
    _close(P._shift_bwd_plain(pb, pr, pw, pdout, v),
           J._shift_bwd_ref(jb, jr, jw, jdout, v), dtype)


def test_adjoint_identity():
    _, (pb, pr, pw, wide, dout), v, ow = _shift_inputs("fp32", seed=5)
    start = P._row_start(pb, pr)
    lhs = (P.shift_fwd(wide, start, pw, ow).double() * dout.double()).sum()
    rhs = (wide.double() * P.shift_bwd(dout, start, pw, v).double()).sum()
    assert abs(lhs.item() - rhs.item()) <= 1e-5 * abs(lhs.item())


def test_shift_pair_gradgradcheck():
    """The mutually-adjoint Functions: backward of the shift is K3, its
    backward K2 (the plain versions on the CPU compute in fp32, hence the
    loose tolerances of a linear map checked in fp64)."""
    rng = np.random.RandomState(6)
    q = torch.from_numpy((rng.rand(8) * 13).astype(np.float32))
    wide = torch.from_numpy(rng.randn(8, 64)).requires_grad_(True)
    f = lambda a: P._row_shift(a, q, 8)
    assert torch.autograd.gradcheck(f, (wide,), eps=1e-3, atol=1e-3)
    assert torch.autograd.gradgradcheck(f, (wide,), eps=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(up=2, pad0=7, pad1=5),
                                dict(down=2, pad0=-7, pad1=-8,
                                     flip_filter=True),
                                dict(up=1, down=1, pad0=2, pad1=1,
                                     gain=2.0)])
def test_upfirdn1d_matrix_equals_jax(kw):
    f = np.asarray(WAVELETS["sym6"]) / np.sum(WAVELETS["sym6"])
    np.testing.assert_array_equal(P.upfirdn1d_matrix(f, 40, **kw),
                                  J.upfirdn1d_matrix(f, 40, **kw))


def _mat(theta=0.0, tx=0.0, ty=0.0, flip=False, n=(H + 12) * 2):
    c0 = (n - 1) / 2
    a = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
    if flip:
        a = a @ np.diag([-1.0, 1.0, 1.0])
    t1 = np.array([[1, 0, -c0], [0, 1, -c0], [0, 0, 1.0]])
    t2 = np.array([[1, 0, c0 + tx], [0, 1, c0 + ty], [0, 0, 1.0]])
    return (t2 @ a @ t1).astype(np.float32)


CASES = {
    "identity": [_mat(), _mat()],
    "integer_translate": [_mat(tx=4, ty=-8), _mat(tx=-30)],
    "rot90_flip": [_mat(theta=np.pi / 2), _mat(flip=True)],
    "rotation": [_mat(theta=0.4, tx=1.3, ty=-0.7), _mat(theta=-2.2)],
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_geom_resample_twopass_vs_jax(case, dtype):
    rng = np.random.RandomState(8)
    x = rng.rand(2, H, H, 3).astype(np.float32)
    mats = np.stack(CASES[case])
    f = jax_setup_filter(WAVELETS["sym6"])
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    ref = J.geom_resample_twopass(jnp.asarray(x, jd), jnp.asarray(mats), f,
                                  6, use_pallas=False)
    got = P.geom_resample_twopass(
        torch.from_numpy(x).to(torch.float32 if dtype == "fp32"
                               else torch.bfloat16),
        torch.from_numpy(mats), np.asarray(f), 6)
    ref = np.asarray(ref).astype(np.float32)
    atol = 1e-5 if dtype == "fp32" else 2.0 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)


def test_affine_warp_twopass_and_gather_vs_jax():
    rng = np.random.RandomState(9)
    x = rng.rand(2, H, H, 3).astype(np.float32)
    mats = np.stack([_mat(0.3, 1.2, -0.7, n=H), _mat(2.5, n=H)])
    jx, jm = jnp.asarray(x), jnp.asarray(mats)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mats)
    np.testing.assert_allclose(
        P.bilinear_warp_gather(tx, tm).numpy(),
        np.asarray(J.bilinear_warp_gather(jx, jm)), atol=1e-6)
    np.testing.assert_allclose(
        P.affine_warp_twopass(tx, tm).numpy(),
        np.asarray(J.affine_warp_twopass(jx, jm, use_pallas=False)),
        atol=1e-5)


def test_warp_grad_vs_jax_vjp():
    rng = np.random.RandomState(10)
    x = rng.rand(2, H, H, 3).astype(np.float32)
    y = rng.randn(2, H, H, 3).astype(np.float32)
    mats = np.stack([_mat(0.5, 1.2, -0.7, n=H), _mat(-0.7, n=H)])
    _, vjp = jax.vjp(lambda a: J.affine_warp_twopass(
        a, jnp.asarray(mats), use_pallas=False), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(P.affine_warp_twopass(
        xt, torch.from_numpy(mats)), xt, torch.from_numpy(y))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(y))[0]),
                               atol=1e-5)
