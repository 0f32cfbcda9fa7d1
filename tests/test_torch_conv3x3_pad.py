"""K1's `pad` (the implicit 2-px halo of its bf16 input gradient) on the CPU.

`conv3x3_valid_plain(x, w, out_w, pad=2)` and the port's Function are held
against the JAX package's plain path for the same function,
`pasta_tpu.ops.conv2d_resample._conv2d` with padding 2 (the lax conv that
pallas_conv.py names as the Pallas kernel's reference; the Pallas kernel
itself does not run on a CPU), on the same seeded numpy inputs.

Tolerances: fp32 sums of up to 9 * 128 products in different orders, 1e-5
of the output scale. bf16: both sides start from the same bf16-rounded
inputs; the reference sums in fp32, the port rounds each result once to
bf16 (2^-9 relative at most) and its CPU conv may also round partial sums
of a long reduction, so 2^-7 of the output scale for y and dX and 2^-6 for
dW (a sum over N * H * W bf16 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasta_tpu.ops.conv2d_resample import _conv2d as lax_conv2d
from pasta_tpu_torch.ops import conv3x3 as k1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lax_pad2(x, w, out_w):
    """The 3x3 conv of x inside a 2-px border of zeros, out_w columns."""
    right = max(2, out_w - x.shape[2])
    return lax_conv2d(x, w, padding=((2, 2), (2, right)))[:, :, :out_w]


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _close(got, ref, rel):
    got = got.detach().float().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


# out_w below, at and past W + 2 (the last asks for columns no input reaches)
@pytest.mark.parametrize("out_w", [9, 15, 19])
@pytest.mark.parametrize("ci,co", [(64, 100), (128, 7), (64, 64)])
def test_plain_pad2_vs_lax_fp32(ci, co, out_w):
    rng = np.random.RandomState(ci + co + out_w)
    x = rng.randn(2, 6, 13, ci).astype(np.float32)
    w = (rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
    ref = _lax_pad2(jnp.asarray(x), jnp.asarray(w), out_w)
    got = k1.conv3x3_valid_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 out_w, pad=2)
    assert tuple(got.shape) == (2, 8, out_w, co)
    _close(got, ref, 1e-5)
    if out_w > 15:
        assert torch.all(got[:, :, 15:] == 0)


def test_plain_pad2_default_width_and_one_row():
    """out_w defaults to W + 2; an input of a single row is legal."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 1, 3, 64).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) / 24).astype(np.float32)
    got = k1.conv3x3_valid_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 pad=2)
    assert tuple(got.shape) == (1, 3, 5, 64)
    _close(got, _lax_pad2(jnp.asarray(x), jnp.asarray(w), 5), 1e-5)


@pytest.mark.parametrize("ci,co", [(64, 100), (128, 7), (128, 64), (64, 128)])
def test_bf16_forward_and_grads_vs_lax_vjp(ci, co):
    """conv3x3_valid in bf16 at a ragged shape (W' > out_w + 2): forward, dX
    (the conv with pad = 2 of dY as it lies; the plain conv when C_out is
    outside K1's scope) and dW against jax.vjp of the lax conv in fp32."""
    rng = np.random.RandomState(ci * co)
    n, h, wp, out_w = 2, 5, 14, 9
    x = _bf16_round(rng.randn(n, h + 2, wp, ci).astype(np.float32))
    w = _bf16_round((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                    .astype(np.float32))
    dy = _bf16_round(rng.randn(n, h, out_w, co).astype(np.float32))
    ref, vjp = jax.vjp(lambda a, b: lax_conv2d(a[:, :, :out_w + 2], b),
                       jnp.asarray(x), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    got = k1.conv3x3_valid(tx, tw, out_w=out_w)
    dx, dw = torch.autograd.grad(got, (tx, tw),
                                 torch.from_numpy(dy).to(torch.bfloat16))
    assert got.dtype == dx.dtype == dw.dtype == torch.bfloat16
    assert torch.all(dx[:, :, out_w + 2:] == 0)
    _close(got, ref, 2.0 ** -7)
    _close(dx, ref_dx, 2.0 ** -7)
    _close(dw, ref_dw, 2.0 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_with_pad2_vs_lax_vjp(dtype):
    """The Function called with pad = 2 (what a bf16 input gradient is):
    forward against the padded lax conv, its dX (pad 0 again) and dW
    against that conv's vjp."""
    rng = np.random.RandomState(11)
    n, h, w_in, ci, co, out_w = 2, 4, 9, 64, 64, 13     # out_w past W + 2
    x = _bf16_round(rng.randn(n, h, w_in, ci).astype(np.float32))
    w = _bf16_round((rng.randn(3, 3, ci, co) / 24).astype(np.float32))
    dy = _bf16_round(rng.randn(n, h + 2, out_w, co).astype(np.float32))
    ref, vjp = jax.vjp(lambda a, b: _lax_pad2(a, b, out_w), jnp.asarray(x),
                       jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    got = k1._Conv3x3.apply(tx, tw, out_w, False, 2)
    dx, dw = torch.autograd.grad(got, (tx, tw), torch.from_numpy(dy).to(dtype))
    y_tol, dw_tol = ((1e-5, 1e-5) if dtype == torch.float32
                     else (2.0 ** -7, 2.0 ** -6))
    _close(got, ref, y_tol)
    _close(dx, ref_dx, y_tol)
    _close(dw, ref_dw, dw_tol)
