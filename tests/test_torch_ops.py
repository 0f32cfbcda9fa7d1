"""Port ops vs pasta_tpu.ops on the CPU, fp32, at the shapes of
tests/test_ops_parity.py. Inputs are made with numpy from a seed and fed
to both packages; layouts are NHWC / HWIO on both sides.

Tolerances: the two packages sum the same products in different orders
(XLA's conv emitter vs ATen's), so fp32 results agree to a few ulps of the
largest partial sums: rtol 1e-5 / atol 1e-5 for the filters, 1e-4 for the
convs (up to 9*C_in-term dot products).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pasta_tpu import ops as jops
from pasta_tpu.ops.conv2d_resample import _conv2d as lax_conv2d
from pasta_tpu_torch import ops
from pasta_tpu_torch.ops import conv3x3
from pasta_tpu_torch.ops.conv2d_resample import _conv2d as port_conv2d


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


class TestSetupFilter:
    @pytest.mark.parametrize("f", [None, 1, [1, 3, 3, 1], [1, 2, 1],
                                   list(range(1, 9)), "rand4x4"])
    def test_matches_jax(self, f):
        if f == "rand4x4":
            f = np.random.RandomState(0).randn(4, 4)
        for flip in (False, True):
            for gain in (1, 4):
                ours = ops.setup_filter(f, flip_filter=flip, gain=gain)
                ref = jops.setup_filter(f, flip_filter=flip, gain=gain)
                np.testing.assert_array_equal(_np(ours), ref)


class TestUpfirdn2d:
    @pytest.mark.parametrize("up,down,padding", [
        (1, 1, 0), (2, 1, 1), (1, 2, 1), (2, 1, [2, 1]), (1, 1, [1, 2, 3, 4]),
        (1, 1, [-1, -1]), (2, 2, [1, 1, 2, 2]), ((2, 1), 1, 1), (4, 1, 2),
    ])
    @pytest.mark.parametrize("sep", [False, True])
    def test_vs_jax(self, up, down, padding, sep):
        x = np.random.RandomState(0).randn(2, 13, 11, 3).astype(np.float32)
        taps = [1, 3, 3, 1, 2, 2, 1, 1] if sep else [1, 3, 3, 1]
        (jx,), (tx,) = _both(x)
        ref = jops.upfirdn2d(jx, jops.setup_filter(taps), up=up, down=down,
                             padding=padding, gain=2.0)
        got = ops.upfirdn2d(tx, ops.setup_filter(taps), up=up, down=down,
                            padding=padding, gain=2.0)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)

    def test_flip_filter(self):
        rng = np.random.RandomState(1)
        x = rng.randn(1, 8, 8, 2).astype(np.float32)
        f = rng.randn(3, 3).astype(np.float32)
        (jx, jf), (tx, tf) = _both(x, f)
        ref = jops.upfirdn2d(jx, jf, padding=1, flip_filter=True)
        got = ops.upfirdn2d(tx, tf, padding=1, flip_filter=True)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2), (2, 2)])
    @pytest.mark.parametrize("sep", [False, True])
    def test_grad_vs_jax_vjp(self, up, down, sep):
        """The FIR pair's backward (a transposed depthwise correlation)
        against JAX's vjp, on odd sizes that leave a ragged stride edge."""
        import jax

        rng = np.random.RandomState(3)
        x = rng.randn(2, 13, 11, 3).astype(np.float32)
        taps = [1, 3, 3, 1, 2, 2, 1, 1] if sep else [1, 3, 3, 1]
        kw = dict(up=up, down=down, padding=[1, 2, 2, 1], gain=2.0)
        (jx,), (tx,) = _both(x)
        ref, vjp = jax.vjp(lambda a: jops.upfirdn2d(
            a, jops.setup_filter(taps), **kw), jx)
        ct = rng.randn(*ref.shape).astype(np.float32)
        (jg,) = vjp(jnp.asarray(ct))
        tx.requires_grad_(True)
        (g,) = torch.autograd.grad(
            ops.upfirdn2d(tx, ops.setup_filter(taps), **kw),
            tx, torch.from_numpy(ct))
        np.testing.assert_allclose(_np(g), _np(jg), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("up,down", [(2, 1), (1, 2)])
    def test_gradgradcheck_fp64(self, up, down):
        """R1 differentiates the discriminator's FIR filters twice."""
        x = torch.from_numpy(np.random.RandomState(4).randn(1, 7, 6, 2))
        f = ops.setup_filter([1, 3, 3, 1]).double()
        fn = lambda a: ops.upfirdn2d(a, f, up=up, down=down, padding=1)
        x.requires_grad_(True)
        assert torch.autograd.gradcheck(fn, (x,))
        assert torch.autograd.gradgradcheck(fn, (x,))

    @pytest.mark.parametrize("wrapper", ["upsample2d", "downsample2d",
                                         "filter2d"])
    def test_wrappers(self, wrapper):
        x = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
        (jx,), (tx,) = _both(x)
        ref = getattr(jops, wrapper)(jx, jops.setup_filter([1, 3, 3, 1]))
        got = getattr(ops, wrapper)(tx, ops.setup_filter([1, 3, 3, 1]))
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


class TestBiasAct:
    @pytest.mark.parametrize("act", sorted(jops.activation_funcs))
    def test_vs_jax(self, act):
        assert sorted(ops.activation_funcs) == sorted(jops.activation_funcs)
        rng = np.random.RandomState(3)
        x = rng.randn(4, 6, 5, 8).astype(np.float32)
        b = rng.randn(8).astype(np.float32)
        (jx, jb), (tx, tb) = _both(x, b)
        for gain, clamp in [(None, None), (2.0, None), (None, 0.5),
                            (1.5, 1.0)]:
            ref = jops.bias_act(jx, jb, act=act, gain=gain, clamp=clamp)
            got = ops.bias_act(tx, tb, act=act, gain=gain, clamp=clamp)
            # elementwise transcendental functions: libm vs XLA, ~1 ulp
            np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-6,
                                       atol=2e-6)


class TestConv2dResample:
    @pytest.mark.parametrize("k,up,down,padding,groups", [
        (3, 1, 1, 1, 1), (3, 2, 1, 1, 1), (3, 1, 2, 1, 1), (1, 1, 2, 0, 1),
        (1, 2, 1, 0, 1), (4, 2, 1, [1, 2], 1), (3, 1, 1, [0, 1, 0, 1], 1),
        (3, 1, 1, 1, 2), (3, 2, 2, 1, 1),
    ])
    @pytest.mark.parametrize("flip_weight", [True, False])
    def test_vs_jax(self, k, up, down, padding, groups, flip_weight):
        rng = np.random.RandomState(4)
        in_ch, out_ch = 6, 8
        x = rng.randn(2, 12, 10, in_ch).astype(np.float32)
        w = (rng.randn(k, k, in_ch // groups, out_ch) * 0.1).astype(np.float32)
        (jx, jw), (tx, tw) = _both(x, w)
        kw = dict(up=up, down=down, padding=padding, groups=groups,
                  flip_weight=flip_weight)
        ref = jops.conv2d_resample(jx, jw, f=jops.setup_filter([1, 3, 3, 1]),
                                   **kw)
        got = ops.conv2d_resample(tx, tw, f=ops.setup_filter([1, 3, 3, 1]),
                                  **kw)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)

    def test_k1_scope_on_cpu_is_the_plain_conv(self):
        """A conv in K1's scope (3x3, 64 -> 64, padded) on CPU tensors goes
        through conv3x3_valid's plain version and still equals lax."""
        rng = np.random.RandomState(5)
        x = rng.randn(1, 16, 16, 64).astype(np.float32)
        w = (rng.randn(3, 3, 64, 64) / 24).astype(np.float32)
        (jx, jw), (tx, tw) = _both(x, w)
        before = conv3x3.conv3x3_valid.launches
        got = ops.conv2d_resample(tx, tw, padding=1)
        assert conv3x3.conv3x3_valid.launches == before   # nothing launched
        ref = jops.conv2d_resample(jx, jw, padding=1)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-4)


class TestConv3x3Plain:
    """conv3x3_valid_plain (K1's plain version) against the JAX package's
    plain path for the same function: lax.conv_general_dilated with VALID
    padding via pasta_tpu.ops.conv2d_resample._conv2d -- the reference the
    Pallas kernel names (pallas_conv.py:27-29); the Pallas kernel itself
    does not run on a CPU."""

    @pytest.mark.parametrize("ci", [64, 128])
    @pytest.mark.parametrize("co", [64, 128])
    def test_vs_lax(self, ci, co):
        rng = np.random.RandomState(ci + co)
        h = w = 16
        wp, out_w = w + 4, w - 3          # alignment columns past out_w + 2
        x = rng.randn(2, h + 2, wp, ci).astype(np.float32)
        wt = (rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
        (jx, jw), (tx, tw) = _both(x, wt)
        ref = lax_conv2d(jx[:, :, :out_w + 2], jw)
        for fn in (conv3x3.conv3x3_valid_plain, conv3x3.conv3x3_valid):
            got = fn(tx, tw, out_w=out_w)      # the wrapper: CPU -> plain
            assert tuple(got.shape) == (2, h, out_w, co)
            # 9*C_in-term fp32 dot products in different orders
            np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4,
                                       atol=1e-4)

    @pytest.mark.parametrize("ci", [64, 128])
    def test_fp32_ragged_forward_and_grads_vs_lax(self, ci):
        """fp32 at a ragged shape (odd H, out_w < W' - 2, C_out = 100 above
        one 64-channel tile and below the 128 one): forward, dX and dW of
        the port's Function against jax.vjp of the lax conv, to 1e-5 of
        each output's scale (fp32 sums of up to 9 * 128 products, and
        N * H * W for dW, in different orders)."""
        import jax

        rng = np.random.RandomState(ci)
        n, h, wp, out_w, co = 2, 7, 23, 17, 100
        x = rng.randn(n, h + 2, wp, ci).astype(np.float32)
        wt = (rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
        dy = rng.randn(n, h, out_w, co).astype(np.float32)
        (jx, jw, jdy), (tx, tw, tdy) = _both(x, wt, dy)
        ref, vjp = jax.vjp(lambda a, b: lax_conv2d(a[:, :, :out_w + 2], b),
                           jx, jw)
        ref_dx, ref_dw = vjp(jdy)
        tx.requires_grad_(True)
        tw.requires_grad_(True)
        got = conv3x3.conv3x3_valid(tx, tw, out_w=out_w)
        got_dx, got_dw = torch.autograd.grad(got, (tx, tw), tdy)
        for a, b in ((got, ref), (got_dx, ref_dx), (got_dw, ref_dw)):
            a, b = _np(a), _np(b)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()

    def test_same_matches_padded_lax(self):
        """An in-scope SAME conv takes K1's route (zero pad, then
        conv3x3_valid, here its plain version) in the port's _conv2d."""
        rng = np.random.RandomState(6)
        x = rng.randn(1, 16, 16, 64).astype(np.float32)
        wt = (rng.randn(3, 3, 64, 128) / 24).astype(np.float32)
        (jx, jw), (tx, tw) = _both(x, wt)
        np.testing.assert_allclose(
            _np(port_conv2d(tx, tw, padding=1)),
            _np(lax_conv2d(jx, jw, padding=1)), rtol=1e-4, atol=1e-4)

    def test_wrapper_never_falls_back_off_cpu(self):
        """A tensor that is neither on the CPU nor on CUDA raises: the
        plain version serves CPU tensors only."""
        x = torch.empty(1, 6, 6, 64, device="meta")
        w = torch.empty(3, 3, 64, 64, device="meta")
        with pytest.raises(ValueError):
            conv3x3.conv3x3_valid(x, w)


class TestModulatedConv2d:
    @pytest.mark.parametrize("demodulate", [True, False])
    @pytest.mark.parametrize("up", [1, 2])
    def test_vs_jax(self, demodulate, up):
        rng = np.random.RandomState(7)
        n, in_ch, out_ch, k, res = 3, 6, 8, 3, 8
        x = rng.randn(n, res, res, in_ch).astype(np.float32)
        w = (rng.randn(k, k, in_ch, out_ch) * 0.2).astype(np.float32)
        s = (rng.randn(n, in_ch) * 0.5 + 1).astype(np.float32)
        noise = rng.randn(n, res * up, res * up, 1).astype(np.float32)
        (jx, jw, js, jn), (tx, tw, ts, tn) = _both(x, w, s, noise)
        kw = dict(up=up, padding=k // 2, demodulate=demodulate,
                  flip_weight=(up == 1))
        ref = jops.modulated_conv2d(jx, jw, js, noise=jn,
                                    resample_filter=jops.setup_filter(
                                        [1, 3, 3, 1]), **kw)
        got = ops.modulated_conv2d(tx, tw, ts, noise=tn,
                                   resample_filter=ops.setup_filter(
                                       [1, 3, 3, 1]), **kw)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)

    def test_bf16_prenormalisation(self):
        """The bf16 branch (weight/style pre-normalisation). Both packages
        compute in bf16 here, so the bound is bf16's: 3e-2 of the output
        scale (8-bit mantissas through a 54-term conv)."""
        rng = np.random.RandomState(8)
        x = rng.randn(2, 8, 8, 6).astype(np.float32)
        w = rng.randn(3, 3, 6, 8).astype(np.float32)
        s = (rng.randn(2, 6) * 0.5 + 1).astype(np.float32)
        (jx, jw, js), (tx, tw, ts) = _both(x, w, s)
        ref = _np(jops.modulated_conv2d(jx.astype(jnp.bfloat16), jw, js,
                                        padding=1).astype(jnp.float32))
        got = _np(ops.modulated_conv2d(tx.to(torch.bfloat16), tw, ts,
                                       padding=1).float())
        assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()
