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
    _, (_, _, _, wide, dout), v, ow = _shift_inputs("fp32", seed=5)
    q = torch.from_numpy(_q(wide.shape[0], v - ow - 42, 6))
    lhs = (P.shift_fwd(wide, q, ow).double() * dout.double()).sum()
    rhs = (wide.double() * P.shift_bwd(dout, q, v).double()).sum()
    assert abs(lhs.item() - rhs.item()) <= 1e-5 * abs(lhs.item())


# K2 and K3 as the kernels compute them: (s, f) derived from q step by step,
# then two taps. Held against the 40-tap plain versions and the JAX
# package's `_row_shift` and its vjp. fp32: the same two products and one
# sum (the other 38 terms are exact zeros), 1e-6 absolute on O(1) values;
# bf16: one rounding of that sum, 2^-8 of the output scale.

def _rows_from_q(q, out_w, v_dim):
    q = np.minimum(np.maximum(q.astype(np.float32), np.float32(0)),
                   np.float32(v_dim - out_w - 42))
    k = np.floor(q)
    f = (q - k).astype(np.float32)
    k = k.astype(np.int32)
    kmin = np.repeat(k.reshape(-1, 8).min(axis=1), 8)
    return kmin + np.clip(k - kmin, 0, 38), f


def _take(a, j):
    """a[r, j[r, c]] with 0 outside the row."""
    ok = (j >= 0) & (j < a.shape[1])
    return np.where(ok, np.take_along_axis(a, np.clip(j, 0, a.shape[1] - 1),
                                           axis=1), np.float32(0))


def _two_tap_fwd(wide, s, f, out_w):
    j = s[:, None] + np.arange(out_w)[None]
    return (1 - f)[:, None] * _take(wide, j) + f[:, None] * _take(wide, j + 1)


def _two_tap_bwd(dout, s, f, v_dim):
    j = np.arange(v_dim)[None] - s[:, None]
    return (1 - f)[:, None] * _take(dout, j) + f[:, None] * _take(dout, j - 1)


TWO_TAP_SHAPES = [(40, 384, 128), (72, 520, 131)]    # ragged R, odd out_w


def _two_tap_inputs(dtype, rows, v_dim, out_w):
    rng = np.random.RandomState(rows + out_w)
    q = _q(rows, v_dim - out_w - 42, rows + 1)
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    wide = torch.from_numpy(rng.randn(rows, v_dim).astype(np.float32)).to(td)
    dout = torch.from_numpy(rng.randn(rows, out_w).astype(np.float32)).to(td)
    return q, wide, dout


def _close2(got, ref, dtype):
    got = np.asarray(got).astype(np.float32)
    atol = 1e-6 if dtype == "fp32" else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.float32 if t.dtype == torch.float32
                       else jnp.bfloat16)


@pytest.mark.parametrize("shape", TWO_TAP_SHAPES)
def test_row_params_from_q_step_by_step(shape):
    rows, v_dim, out_w = shape
    q = _q(rows, v_dim - out_w - 42, rows + 1)
    s, f = _rows_from_q(q, out_w, v_dim)
    assert (s - np.repeat(s.reshape(-1, 8).min(axis=1), 8)).max() == 38
    assert q.min() < 0 and q.max() > v_dim - out_w - 42
    ps, pf = P._row_params_plain(torch.from_numpy(q), out_w, v_dim)
    np.testing.assert_array_equal(ps.numpy(), s)
    np.testing.assert_array_equal(pf.numpy(), f)
    assert ps.dtype == torch.int32 and pf.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", TWO_TAP_SHAPES)
def test_two_tap_k2_vs_plain_and_jax(shape, dtype):
    rows, v_dim, out_w = shape
    q, wide, _ = _two_tap_inputs(dtype, *shape)
    ref = _two_tap_fwd(wide.float().numpy(), *_rows_from_q(q, out_w, v_dim),
                       out_w)
    tq = torch.from_numpy(q)
    _close2(P.shift_fwd_plain(wide, tq, out_w).float().numpy(), ref, dtype)
    _close2(P.shift_fwd(wide, tq, out_w).float().numpy(), ref, dtype)
    _close2(P._row_shift(wide, tq, out_w).float().numpy(), ref, dtype)
    _close2(J._row_shift(_jnp(wide), jnp.asarray(q), out_w, False), ref,
            dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", TWO_TAP_SHAPES)
def test_two_tap_k3_vs_plain_and_jax(shape, dtype):
    rows, v_dim, out_w = shape
    q, wide, dout = _two_tap_inputs(dtype, *shape)
    ref = _two_tap_bwd(dout.float().numpy(), *_rows_from_q(q, out_w, v_dim),
                       v_dim)
    tq = torch.from_numpy(q)
    _close2(P.shift_bwd_plain(dout, tq, v_dim).float().numpy(), ref, dtype)
    _close2(P.shift_bwd(dout, tq, v_dim).float().numpy(), ref, dtype)
    _, vjp = jax.vjp(lambda a: J._row_shift(a, jnp.asarray(q), out_w, False),
                     _jnp(wide))
    _close2(vjp(_jnp(dout))[0], ref, dtype)


@pytest.mark.parametrize("shape", TWO_TAP_SHAPES)
def test_two_tap_adjoint_identity(shape):
    rows, v_dim, out_w = shape
    q, wide, dout = _two_tap_inputs("fp32", *shape)
    s, f = _rows_from_q(q, out_w, v_dim)
    x, y = wide.numpy().astype(np.float64), dout.numpy().astype(np.float64)
    lhs = (_two_tap_fwd(x, s, f.astype(np.float64), out_w) * y).sum()
    rhs = (x * _two_tap_bwd(y, s, f.astype(np.float64), v_dim)).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_rows_entry_takes_start_and_f_as_given():
    """The probes' form: any R, a start per row (up to the last column,
    columns past V read as 0), f not rounded through q = k + f."""
    rng = np.random.RandomState(7)
    rows, v_dim, out_w = 37, 200, 61
    wide = rng.randn(rows, v_dim).astype(np.float32)
    dout = rng.randn(rows, out_w).astype(np.float32)
    s = rng.randint(0, v_dim, rows).astype(np.int32)
    f = rng.rand(rows).astype(np.float32)
    ts, tf = torch.from_numpy(s), torch.from_numpy(f)
    got2 = P.shift_fwd_rows(torch.from_numpy(wide), ts, tf, out_w)
    got3 = P.shift_bwd_rows(torch.from_numpy(dout), ts, tf, v_dim)
    np.testing.assert_allclose(got2.numpy(), _two_tap_fwd(wide, s, f, out_w),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got3.numpy(), _two_tap_bwd(dout, s, f, v_dim),
                               atol=1e-6, rtol=0)
    lhs = (got2.double() * torch.from_numpy(dout).double()).sum().item()
    rhs = (torch.from_numpy(wide).double() * got3.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


# The CUDA route of `_row_shift` driven on the CPU: a stand-in for the
# ctypes launch computes the two-tap formula from the q it is handed and,
# like the kernel, returns a fresh tensor with no autograd history.

@pytest.fixture
def kernel_route(monkeypatch):
    def stub(name, a, q, start, f, v_dim, out_w, return_rows=False):
        assert q is not None and start is None and f is None
        assert q.shape == (a.shape[0],) and q.dtype == torch.float32
        assert not q.requires_grad
        stub.calls.append(name)
        s, fr = _rows_from_q(q.numpy(), out_w, v_dim)
        x = a.detach().float().numpy()
        out = (_two_tap_fwd(x, s, fr, out_w) if name == "shift_fwd"
               else _two_tap_bwd(x, s, fr, v_dim))
        return torch.from_numpy(out.astype(np.float32)).to(a.dtype)

    def no_prep(*args, **kwargs):
        raise AssertionError("the kernel route ran a prep op")

    stub.calls = []
    monkeypatch.setattr(P, "_plain_route", lambda x: False)
    monkeypatch.setattr(P, "_kernel", stub)
    monkeypatch.setattr(P, "_shift_prep", no_prep)
    monkeypatch.setattr(P, "_row_start", no_prep)
    monkeypatch.setattr(P.F, "one_hot", no_prep)
    monkeypatch.setattr(torch, "repeat_interleave", no_prep)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", no_prep)
    monkeypatch.setattr(P.shift_fwd, "launches", 0)
    monkeypatch.setattr(P.shift_bwd, "launches", 0)
    return stub


def test_kernel_route_hands_the_kernel_q(kernel_route):
    q, wide, _ = _two_tap_inputs("fp32", 40, 384, 128)
    out = P._row_shift(wide.requires_grad_(True), torch.from_numpy(q), 128)
    assert kernel_route.calls == ["shift_fwd"]
    assert (P.shift_fwd.launches, P.shift_bwd.launches) == (1, 0)
    ref = _two_tap_fwd(wide.detach().numpy(), *_rows_from_q(q, 128, 384), 128)
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    # what backward keeps: q and nothing with a tap axis
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(40,)]
    assert saved[0].dtype == torch.float32


def test_kernel_route_backward_and_double_backward(kernel_route):
    """Backward of K2 is one launch of K3; the gradient of a function of that
    gradient (R1's pattern) goes through K2 again, and then K3."""
    q, wide, dout = _two_tap_inputs("fp32", 40, 384, 128)
    tq = torch.from_numpy(q)
    s, f = _rows_from_q(q, 128, 384)
    x = wide.requires_grad_(True)
    y = P._row_shift(x, tq, 128)
    ct = dout.clone().requires_grad_(True)
    gx, = torch.autograd.grad(y, x, ct, create_graph=True)
    assert kernel_route.calls == ["shift_fwd", "shift_bwd"]
    np.testing.assert_array_equal(gx.detach().numpy(),
                                  _two_tap_bwd(dout.numpy(), s, f, 384))
    # gx is linear in ct: d <gx, c> / d ct = K2 c
    c = torch.from_numpy(np.random.RandomState(1).randn(40, 384).astype(
        np.float32)).requires_grad_(True)
    gct, = torch.autograd.grad(gx, ct, c, create_graph=True)
    assert kernel_route.calls == ["shift_fwd", "shift_bwd", "shift_fwd"]
    np.testing.assert_array_equal(gct.detach().numpy(),
                                  _two_tap_fwd(c.detach().numpy(), s, f, 128))
    # and so on up the tower: d <gct, d> / d c = K3 d
    gc, = torch.autograd.grad(gct, c, dout)
    assert kernel_route.calls[3:] == ["shift_bwd"]
    np.testing.assert_array_equal(gc.numpy(),
                                  _two_tap_bwd(dout.numpy(), s, f, 384))
    assert (P.shift_fwd.launches, P.shift_bwd.launches) == (2, 2)


@pytest.mark.parametrize("case", ["device", "dtype", "rows", "window", "q",
                                  "start"])
def test_kernel_check_raises(case):
    """What the launch refuses (the checks that need no card run first)."""
    a = torch.zeros(16, 128)
    q = torch.zeros(16)
    if case == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            P._check("shift_fwd", a, q, None, None, 128, 64)
        return
    bad, message = {
        "dtype": (dict(a=a.half()), "not bf16/fp32"),
        "rows": (dict(a=a[:12], q=q[:12]), "multiple of 8"),
        "window": (dict(out_w=100), "out_w \\+ 42"),
        "q": (dict(q=q.double()), "per-row input"),
        "start": (dict(q=None, start=q, f=q), "per-row input")}[case]
    kw = dict(a=a, q=q, start=None, f=None, v_dim=128, out_w=64)
    kw.update(bad)
    with pytest.raises(ValueError, match=message):
        _check_off_device(**kw)


def _check_off_device(a, **kw):
    """`P._check` on a CPU tensor that claims to lie on a card."""
    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    P._check("shift_fwd", a.as_subclass(OnCard), **kw)


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
