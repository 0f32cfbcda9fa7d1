"""K1 (`ops/conv3x3.conv3x3_valid`) as a torch.autograd.Function.

On the CPU the Function's forward and its input-gradient launches run the
plain version; a stub launcher (a CPU stand-in for the ctypes launch, which
returns a fresh tensor with no autograd history) drives the kernel route.
Tolerances: fp32 sums of 9*C terms in different orders, 1e-5 relative to
the output scale; gradcheck in fp64 at its defaults (eps 1e-6, atol 1e-5).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck, gradgradcheck

from pasta_tpu_torch.ops import conv3x3 as k1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, h, wp, ci, co, out_w, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h + 2, wp, ci)).to(dtype)
    w = torch.from_numpy(rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).to(dtype)
    dy = torch.from_numpy(rng.randn(n, h, out_w, co)).to(dtype)
    return x, w, dy


def _autograd_ref(x, w, dy, out_w):
    """dX, dW of F.conv2d on the same VALID window (NCHW / OIHW)."""
    xn = x.detach().permute(0, 3, 1, 2).requires_grad_(True)
    wn = w.detach().permute(3, 2, 0, 1).requires_grad_(True)
    y = F.conv2d(xn[..., :out_w + 2], wn)
    dxn, dwn = torch.autograd.grad(y, (xn, wn), dy.permute(0, 3, 1, 2))
    return dxn.permute(0, 2, 3, 1), dwn.permute(2, 3, 1, 0)


# (C_in, C_out): every channel pair of the training path's K1 convs, and
# two whose dX (C_out -> C_in) falls outside K1's scope (the plain conv).
@pytest.mark.parametrize("ci,co", [(64, 64), (64, 128), (128, 64),
                                   (128, 128), (64, 32), (128, 100)])
def test_grads_match_autograd(ci, co):
    n, h, wp, out_w = 2, 5, 13, 9          # columns past out_w + 2 unused
    x, w, dy = _inputs(n, h, wp, ci, co, out_w, seed=ci + co)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = k1.conv3x3_valid(xg, wg, out_w=out_w)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    dxr, dwr = _autograd_ref(x, w, dy, out_w)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert torch.all(dx[:, :, out_w + 2:] == 0)
    for got, ref in ((dx, dxr), (dw, dwr)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=1e-5 * ref.abs().max().item())


@pytest.fixture
def small_scope(monkeypatch):
    """K1's channel scope widened to every channel count, so that the
    Function's input gradient takes its own route (the Function again) at
    the few channels a numerical Jacobian can afford."""
    monkeypatch.setattr(k1, "in_scope", lambda ci, co: True)


@pytest.mark.parametrize("ci,co", [(3, 2), (2, 4)])
def test_gradcheck_fp64(small_scope, ci, co):
    x, w, _ = _inputs(2, 3, 7, ci, co, 4, seed=co, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert gradcheck(lambda a, b: k1.conv3x3_valid(a, b, out_w=4), (x, w))


@pytest.mark.parametrize("ci,co", [(3, 2), (2, 4)])
def test_gradgradcheck_fp64(small_scope, ci, co):
    x, w, _ = _inputs(1, 2, 5, ci, co, 3, seed=co + 1, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert gradgradcheck(lambda a, b: k1.conv3x3_valid(a, b), (x, w))


def test_gradcheck_fp64_out_of_scope_dx():
    """C_out = 16: the input gradient is the plain conv (K1 cannot take a
    16 -> 64 conv), chosen from the shape."""
    x, w, _ = _inputs(1, 2, 4, 64, 16, 2, seed=9, dtype=torch.float64)
    x.requires_grad_(True)
    assert gradcheck(lambda a: k1.conv3x3_valid(a, w), (x,))


@pytest.fixture
def kernel_route(monkeypatch):
    """Send CPU tensors down the kernel route, with a CPU stand-in for the
    ctypes launch: like the kernel, it writes a fresh tensor that carries
    no autograd history."""
    def stub(x, w, out_w, pad=0):
        stub.calls.append((tuple(x.shape), out_w, pad))
        stub.inside = True
        out = k1.conv3x3_valid_plain(x.detach(), w.detach(), out_w, pad)
        stub.inside = False
        assert out.grad_fn is None and not out.requires_grad
        return out

    class CountingF:
        """torch.nn.functional, counting the wrapper's own F.pad calls
        (not those the stand-in's plain conv makes inside the launch)."""
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def pad(*args, **kwargs):
            if not stub.inside:
                stub.pads.append(tuple(args[1]))
            return F.pad(*args, **kwargs)

    stub.calls, stub.pads, stub.inside = [], [], False
    monkeypatch.setattr(k1, "F", CountingF())
    monkeypatch.setattr(k1, "_plain_route", lambda x: False)
    monkeypatch.setattr(k1, "_kernel", stub)
    monkeypatch.setattr(k1.conv3x3_valid, "launches", 0)
    monkeypatch.setattr(k1.conv3x3_valid, "launches_bwd", 0)
    return stub


def test_kernel_launch_alone_cuts_the_gradient(kernel_route):
    """The launch itself -- what the wrapper returned before it became an
    autograd Function -- has no grad_fn, so a backward through it fails
    (on the card the gradient was cut without an error)."""
    x, w, dy = _inputs(1, 4, 8, 64, 64, 6)
    xg = x.requires_grad_(True)
    y = kernel_route(xg, w, 6)
    with pytest.raises(RuntimeError):
        (y * dy).sum().backward()


def test_kernel_route_carries_gradients(kernel_route):
    x, w, dy = _inputs(2, 4, 10, 64, 128, 7)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = k1.conv3x3_valid(xg, wg, out_w=7)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    dxr, dwr = _autograd_ref(x, w, dy, 7)
    np.testing.assert_allclose(dx.numpy(), dxr.numpy(),
                               atol=1e-5 * dxr.abs().max().item())
    np.testing.assert_allclose(dw.numpy(), dwr.numpy(),
                               atol=1e-5 * dwr.abs().max().item())
    # one forward launch; the dX (128 -> 64) is one more, counted apart
    assert (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_bwd) == (1, 1)


def test_kernel_route_double_backward(kernel_route):
    """R1's pattern: a gradient w.r.t. the input with a graph, then a
    backward of its square to the weights -- both through K1's route."""
    x, w, _ = _inputs(1, 3, 6, 64, 64, 4, seed=3)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(k1.conv3x3_valid(xg, wg).square().sum(), xg,
                                create_graph=True)
    (gw,) = torch.autograd.grad(gx.square().sum(), wg)
    xr = x.clone().permute(0, 3, 1, 2).requires_grad_(True)
    wr = w.clone().permute(3, 2, 0, 1).requires_grad_(True)
    (gxr,) = torch.autograd.grad(F.conv2d(xr, wr).square().sum(), xr,
                                 create_graph=True)
    (gwr,) = torch.autograd.grad(gxr.square().sum(), wr)
    np.testing.assert_allclose(gw.numpy(), gwr.permute(2, 3, 1, 0).numpy(),
                               atol=1e-5 * gwr.abs().max().item())
    assert k1.conv3x3_valid.launches == 1
    assert k1.conv3x3_valid.launches_bwd >= 2


def test_kernel_route_bf16_dx_is_one_launch_on_dy(kernel_route):
    """A bf16 input gradient reaches the launcher with dY as it lies,
    pad = 2 and the input's full width W' as out_w: no pad copy before the
    launch and none after it."""
    n, h, wp, out_w = 2, 4, 12, 7                     # W' > out_w + 2
    x, w, dy = _inputs(n, h, wp, 64, 128, out_w, dtype=torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    y = k1.conv3x3_valid(xg, w, out_w=out_w)
    (dx,) = torch.autograd.grad(y, xg, dy)
    assert kernel_route.calls == [((n, h + 2, wp, 64), out_w, 0),
                                  ((n, h, out_w, 128), wp, 2)]
    assert kernel_route.pads == []
    assert (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_bwd) == (1, 1)
    assert dx.shape == x.shape and torch.all(dx[:, :, out_w + 2:] == 0)
    dxr, _ = _autograd_ref(x.float(), w.float(), dy.float(), out_w)
    # one bf16 rounding of an fp32 sum on each side's result
    np.testing.assert_allclose(dx.float().numpy(), dxr.numpy(),
                               atol=2.0 ** -7 * dxr.abs().max().item())


def test_kernel_route_fp32_dx_still_pads(kernel_route):
    """The fp32 kernel cannot take a halo from the tensor's bounds: dY is
    padded by 2 before the launch (pad = 0) and dX is padded back to W'."""
    n, h, wp, out_w = 2, 4, 12, 7
    x, w, dy = _inputs(n, h, wp, 64, 128, out_w)
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(k1.conv3x3_valid(xg, w, out_w=out_w), xg, dy)
    assert kernel_route.calls == [((n, h + 2, wp, 64), out_w, 0),
                                  ((n, h + 4, out_w + 4, 128), out_w + 2, 0)]
    assert kernel_route.pads == [(0, 0, 2, 2, 2, 2),
                                 (0, 0, 0, wp - out_w - 2)]
    dxr, _ = _autograd_ref(x, w, dy, out_w)
    np.testing.assert_allclose(dx.numpy(), dxr.numpy(),
                               atol=1e-5 * dxr.abs().max().item())


def test_kernel_route_double_backward_bf16(kernel_route):
    """R1's pattern in bf16 through the kernel route: the input gradient is
    a launch with pad = 2, its own backward launches with pad 0 and 2
    again, and no pad copy runs outside the launches."""
    x, w, _ = _inputs(1, 3, 6, 64, 64, 4, seed=3, dtype=torch.bfloat16)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(
        k1.conv3x3_valid(xg, wg).float().square().sum(), xg,
        create_graph=True)
    (gw,) = torch.autograd.grad(gx.float().square().sum(), wg)
    xr = x.float().permute(0, 3, 1, 2).requires_grad_(True)
    wr = w.float().permute(3, 2, 0, 1).requires_grad_(True)
    (gxr,) = torch.autograd.grad(F.conv2d(xr, wr).square().sum(), xr,
                                 create_graph=True)
    (gwr,) = torch.autograd.grad(gxr.square().sum(), wr)
    # three chained bf16 results (y, dX, then the products into dW), each
    # rounded to 2^-9 relative: 2^-5 of the scale
    np.testing.assert_allclose(gw.float().numpy(),
                               gwr.permute(2, 3, 1, 0).numpy(),
                               atol=2.0 ** -5 * gwr.abs().max().item())
    pads = [c[2] for c in kernel_route.calls]
    assert pads[:2] == [0, 2] and set(pads[2:]) == {0, 2}
    assert kernel_route.pads == []     # dW of the pad-2 conv pads implicitly
    assert k1.conv3x3_valid.launches == 1
    assert k1.conv3x3_valid.launches_bwd >= 3


@pytest.fixture
def implicit_halo(monkeypatch):
    """Every dtype takes the bf16 kernel's route for input gradients (the
    Function with pad 2, then pad 0, ...), so that fp64 can check it."""
    monkeypatch.setattr(k1, "_implicit_halo", lambda t: True)


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("ci,co", [(3, 2), (2, 4)])
def test_gradcheck_fp64_with_pad(small_scope, implicit_halo, ci, co, pad):
    x, w, _ = _inputs(2, 3, 7, ci, co, 4, seed=co + pad, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert gradcheck(lambda a, b: k1._Conv3x3.apply(a, b, 4, False, pad),
                     (x, w))


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("halo", ["implicit", "copied"])
def test_gradgradcheck_fp64_with_pad(small_scope, monkeypatch, halo, pad):
    """The Function is closed under differentiation on both routes: with
    the halo implicit (pad 0 <-> pad 2) and with dY padded by a copy."""
    if halo == "implicit":
        monkeypatch.setattr(k1, "_implicit_halo", lambda t: True)
    x, w, _ = _inputs(1, 2, 5, 2, 3, 3, seed=pad, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    out_w = 6 if pad else 3            # pad 2: one column past W + 2 - 2
    assert gradgradcheck(
        lambda a, b: k1._Conv3x3.apply(a, b, out_w, False, pad), (x, w))
