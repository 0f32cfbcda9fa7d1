"""SPADE's normalisation with the next conv's pre-activation
(`ops/spade_norm.py`).

On the CPU every call computes `spade_norm_act_plain`, which must be the
chain the SPADE blocks ran before the fusion, op for op, so that the CPU
parity tests against the JAX package stay bit for bit. A stub (the
kernels' arithmetic written in torch: moments, apply, and the backward's
two sums and its dx / dgb formula) drives the kernel route on the CPU for
the routing, the counters, the shared moments and the backward's formula.
Tolerances: fp32, moments summed in another order, 1e-5 of the scale;
float64 gradcheck at its defaults.
"""

import importlib
import math

import pytest
import torch
from torch.autograd import gradcheck

from pasta_tpu_torch.ops.bias_act import bias_act

sn = importlib.import_module("pasta_tpu_torch.ops.spade_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(x, gb, gain, clamp):
    """The blocks' chain before the fusion: SpadeNormBlock's normalisation
    and affine, then SpadeConv2dLayer's pre-activation (no bias)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    normalized = ((x32 - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    gamma, beta = gb.chunk(2, dim=-1)
    out = normalized * (1 + gamma) + beta
    return bias_act(out, None, act="relu", gain=math.sqrt(2.0) * gain,
                    clamp=256.0 * gain)


def _inputs(n, h, w, c, layout, dtype=torch.float32, seed=0):
    """x [n, h, w, c] and gb [n, h, w, 2c]: NHWC-contiguous, or the
    permuted view of an NCHW tensor (an F.conv2d output)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, h, w, c, generator=g) * 3 + 1).to(dtype)
    if layout == "nhwc":
        gb = torch.randn(n, h, w, 2 * c, generator=g).to(dtype)
    else:
        gb = torch.randn(n, 2 * c, h, w, generator=g).to(dtype)
        gb = gb.permute(0, 2, 3, 1)
    return x, gb


def _counts():
    f = sn.spade_norm_act
    return f.launches, f.launches_bwd, f.launches_plain


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("gain", [1.0, math.sqrt(0.5)])
def test_plain_route_is_the_chain_bit_for_bit(layout, c, gain):
    x, gb = _inputs(2, 5, 6, c, layout)
    want = _chain(x, gb, gain, None)
    got = sn.spade_norm_act(x, gb, math.sqrt(2.0) * gain, 256.0 * gain)
    assert torch.equal(got, want)
    xa, gba = x.clone().requires_grad_(), gb.clone().requires_grad_()
    xb, gbb = x.clone().requires_grad_(), gb.clone().requires_grad_()
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    _chain(xa, gba, gain, None).backward(dy)
    sn.spade_norm_act(xb, gbb, math.sqrt(2.0) * gain,
                      256.0 * gain).backward(dy)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(gba.grad, gbb.grad)


def test_plain_route_gradcheck_float64():
    # clamp 2.5 cuts some values (|y| reaches ~5), none within the
    # difference step of a kink at these seeds
    x, gb = _inputs(2, 3, 4, 8, "nchw", torch.float64, seed=3)
    x.requires_grad_()
    gb.requires_grad_()
    assert gradcheck(lambda a, b: sn.spade_norm_act_plain(a, b, 1.3, 2.5),
                     (x, gb))
    y = sn.spade_norm_act_plain(x, gb, 1.3, 2.5)
    assert bool((y.abs() == 2.5).any()) and bool((y == 0).any())


def _norm_in(x, dtype):
    """instance_norm_2d's formula with its moments in `dtype`."""
    xm = x.to(dtype)
    mean = xm.mean(dim=(1, 2), keepdim=True)
    var = (xm - mean).square().mean(dim=(1, 2), keepdim=True)
    return ((xm - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_instance_norm_moments_dtype(dtype):
    """fp32 and bf16 inputs take their moments in fp32, bit for bit as the
    norm did before it moved here (`x.float()`); float64 keeps float64,
    which the plain route's gradcheck needs, where `x.float()` rounded it."""
    x, _ = _inputs(2, 5, 6, 8, "nhwc", dtype, seed=5)
    got = sn.instance_norm_2d(x)
    assert got.dtype == dtype
    if dtype == torch.float64:
        assert torch.equal(got, _norm_in(x, torch.float64))
        assert not torch.equal(got, _norm_in(x, torch.float32))
    else:
        assert torch.equal(got, _norm_in(x, torch.float32))


@pytest.mark.parametrize("kw,fused", [
    (dict(use_bias=False), True),
    (dict(), False),
    (dict(use_bias=False, activation="lrelu"), False),
])
def test_fused_pre_activation_is_relu_without_bias(kw, fused):
    """SpadeConv2dLayer.act_args hands spade_norm_act its gain and clamp
    only where the layer's own pre-activation is what the kernels apply:
    a relu with no bias."""
    from pasta_tpu_torch.nn.synthesis import SpadeConv2dLayer
    from pasta_tpu_torch.ops.bias_act import activation_funcs

    layer = SpadeConv2dLayer(8, 8, 3, conv_clamp=256.0, **kw)
    gain = math.sqrt(0.5)
    if fused:
        assert layer.act_args(gain) == (
            activation_funcs["relu"].def_gain * gain, 256.0 * gain)
    else:
        with pytest.raises(ValueError, match="relu pre-activation"):
            layer.act_args(gain)


# -- the kernel route, driven on the CPU by a stub of the kernels ----------

def _stub_stats(x):
    x = x.detach()      # the kernel's moments carry no autograd history
    mean = x.mean(dim=(1, 2))
    var = (x - mean[:, None, None]).square().mean(dim=(1, 2))
    return mean, 1.0 / torch.sqrt(var + sn.EPS)


def _parts(x, gb, mean, rstd, gain, clamp):
    c = x.shape[-1]
    xh = (x - mean[:, None, None]) * rstd[:, None, None]
    g1 = 1 + gb[..., :c]
    z = xh * g1 + gb[..., c:]
    u = torch.where(z < 0, torch.zeros_like(z), z) * gain
    return xh, g1, z, u


def _stub_apply(x, gb, mean, rstd, gain, clamp):
    _, _, _, u = _parts(x, gb, mean, rstd, gain, clamp)
    return u.clamp(-clamp, clamp).contiguous()


def _stub_backward(dy, x, gb, mean, rstd, gain, clamp):
    xh, g1, z, u = _parts(x, gb, mean, rstd, gain, clamp)
    live = (z > 0) & (u >= -clamp) & (u <= clamp)
    dz = torch.where(live, dy * gain, torch.zeros_like(dy))
    dxh = dz * g1
    s1 = dxh.mean(dim=(1, 2), keepdim=True)
    s2 = (dxh * xh).mean(dim=(1, 2), keepdim=True)
    dx = rstd[:, None, None] * (dxh - s1 - xh * s2)
    return dx.contiguous(), torch.cat([dz * xh, dz], dim=-1)


@pytest.fixture
def stub(monkeypatch):
    """The kernel route on the CPU: CPU tensors no longer take the plain
    route, and the three launchers compute the kernels' arithmetic."""
    monkeypatch.setattr(sn, "_plain_route", lambda x: False)
    monkeypatch.setattr(sn, "_stats", _stub_stats)
    monkeypatch.setattr(sn, "_apply", _stub_apply)
    monkeypatch.setattr(sn, "_backward", _stub_backward)


def test_kernel_route_gradients_float64(stub, monkeypatch):
    """The backward's formula (dx through the moments, dgb) against the
    finite differences of the whole op, moments included."""
    x, gb = _inputs(2, 3, 4, 8, "nchw", torch.float64, seed=3)
    assert sn.in_scope(x.float(), gb.float())
    x.requires_grad_()
    gb.requires_grad_()
    # the stub's float64 stands in for the kernels' fp32 here
    fp32_scope = sn.x_in_scope
    monkeypatch.setattr(sn, "x_in_scope", lambda t: fp32_scope(t.float()))
    before = _counts()
    assert gradcheck(lambda a, b: sn.spade_norm_act(a, b, 1.3, 2.5),
                     (x, gb))
    assert _delta(before)[1] > 0


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_kernel_route_matches_plain(stub, layout):
    x, gb = _inputs(2, 6, 5, 16, layout, seed=4)
    before = _counts()
    xa, gba = x.clone().requires_grad_(), gb.clone().requires_grad_()
    y = sn.spade_norm_act(xa, gba, 1.7, 2.0)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    y.backward(dy)
    assert _delta(before) == (3, 3, 0)
    xb, gbb = x.clone().requires_grad_(), gb.clone().requires_grad_()
    want = sn.spade_norm_act_plain(xb, gbb, 1.7, 2.0)
    want.backward(dy)
    for got, ref in ((y, want), (xa.grad, xb.grad), (gba.grad, gbb.grad)):
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_second_backward_raises(stub):
    """No path differentiates the SPADE blocks twice; the Function says so
    instead of giving a wrong second derivative."""
    x, gb = _inputs(1, 4, 4, 8, "nhwc", seed=6)
    x.requires_grad_()
    gb.requires_grad_()
    y = sn.spade_norm_act(x, gb, 1.0, None)
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


# (dtype, channels, gb channels, moments on the kernel, route): the
# generator's widths, bf16, a C / 4 that is no power of two, more than 256
# vectors, a gb that is not [N, H, W, 2C], float64
ROUTES = [
    (torch.float32, 64, 128, True, "kernel"),
    (torch.float32, 128, 256, True, "kernel"),
    (torch.float32, 4, 8, True, "kernel"),
    (torch.bfloat16, 64, 128, False, "plain"),
    (torch.float32, 12, 24, False, "plain"),
    (torch.float32, 2048, 4096, False, "plain"),
    (torch.float32, 64, 64, True, "plain"),
    (torch.float64, 64, 128, False, "plain"),
]


@pytest.mark.parametrize("case", range(len(ROUTES)))
def test_routing(stub, case):
    """Which route a call on a card takes, from what the input shows; the
    counters say which ran."""
    dtype, c, cgb, moments, route = ROUTES[case]
    x = torch.randn(1, 2, 3, c).to(dtype)
    gb = torch.randn(1, 2, 3, cgb).to(dtype)
    before = _counts()
    stats = sn.spade_norm_stats(x)
    assert (stats is not None) == moments
    if cgb == 2 * c:
        y = sn.spade_norm_act(x, gb, 1.0, 4.0, stats=stats)
        assert y.dtype == dtype and y.shape == x.shape
    else:               # the chain cannot take it either
        with pytest.raises(RuntimeError):
            sn.spade_norm_act(x, gb, 1.0, 4.0, stats=stats)
    want = (3, 0, 0) if route == "kernel" else (2 * moments, 0, 1)
    assert _delta(before) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_bf16_take_the_plain_route(dtype):
    """Without the stub: a CPU tensor takes the chain (uncounted in the
    kernels' scope), and so does bf16, counted as outside it."""
    x, gb = _inputs(2, 4, 4, 64, "nchw", dtype, seed=7)
    before = _counts()
    assert sn.spade_norm_stats(x) is None
    got = sn.spade_norm_act(x, gb, math.sqrt(2.0), 256.0)
    assert torch.equal(got, _chain(x, gb, 1.0, None))
    assert _delta(before) == (0, 0, int(dtype == torch.bfloat16))


def test_layouts_read_in_place():
    """gb as K1 writes it and as a permuted NCHW conv output, and dy as a
    pad's gradient slices it, are read where they lie; a layout of
    neither kind is copied, and so is an NCHW-backed dy (only gb is read
    along W)."""
    x, nhwc = _inputs(2, 4, 6, 8, "nhwc")
    _, nchw = _inputs(2, 4, 6, 8, "nchw")
    padded = torch.randn(2, 6, 8, 8)[:, 1:-1, 1:-1]
    assert sn._readable(nhwc) is nhwc and sn._readable(nchw) is nchw
    assert sn._readable(padded) is padded
    assert sn._vectors(padded) and sn._vectors(nhwc)
    assert not sn._vectors(nchw)
    odd = torch.randn(2, 4, 6, 17)[..., 1:]       # 4-byte offset
    assert sn._readable(odd).is_contiguous()
    expanded = torch.ones(1).expand(2, 4, 6, 8)
    assert sn._readable(expanded).is_contiguous()


@pytest.mark.parametrize("layout", ["padded", "nchw"])
def test_backward_reads_dy_as_vectors(stub, monkeypatch, layout):
    """The backward takes dy where it lies when its channels are vectors
    (a pad's gradient, as G's backward hands it) and copies an NCHW-backed
    dy; the gradients are the plain chain's either way."""
    x, gb = _inputs(2, 4, 6, 8, "nhwc", seed=9)
    dy = torch.randn(2, 6, 8, 8, generator=torch.Generator().manual_seed(10))
    dy = (dy[:, 1:-1, 1:-1] if layout == "padded"
          else dy[:, 1:-1, 1:-1].permute(0, 3, 1, 2).contiguous()
          .permute(0, 2, 3, 1))
    seen = []

    def record(d, *args):
        seen.append((d.stride(), d.is_contiguous()))
        return _stub_backward(d, *args)

    monkeypatch.setattr(sn, "_backward", record)
    xa, gba = x.clone().requires_grad_(), gb.clone().requires_grad_()
    sn.spade_norm_act(xa, gba, 1.3, 2.5).backward(dy)
    want = ([(dy.stride(), False)] if layout == "padded"
            else [((4 * 6 * 8, 6 * 8, 8, 1), True)])
    assert seen == want
    xb, gbb = x.clone().requires_grad_(), gb.clone().requires_grad_()
    sn.spade_norm_act_plain(xb, gbb, 1.3, 2.5).backward(dy)
    for got, ref in ((xa.grad, xb.grad), (gba.grad, gbb.grad)):
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max()


def test_reduction_partition():
    """About 528 blocks over the batch, whole rows each, from the shape
    alone: the serving shapes' and one request's."""
    for n, h, rows in ((8, 512, 8), (8, 256, 4), (1, 256, 1), (4, 512, 4),
                       (3, 7, 1)):
        assert sn._rows(n, h) == rows


def test_resblock_shares_moments_and_matches_plain(stub, monkeypatch):
    """SpadeResBlock on the kernel route: the moments of x taken once for
    spade_skip and spade0 (2 + 2 launches), three applies, three
    backwards; output and gradients as the plain chain's."""
    from pasta_tpu_torch.nn.synthesis import SpadeResBlock

    torch.manual_seed(8)
    block = SpadeResBlock(16, 16, spade_channels=3, conv_clamp=0.5)
    for p in block.parameters():
        p.data.normal_()
    x = torch.randn(2, 8, 8, 16)
    feat = torch.randn(2, 8, 8, 3)
    before = _counts()
    xa = x.clone().requires_grad_()
    y = block(xa, feat)
    assert _delta(before) == (7, 0, 0)
    dy = torch.randn(y.shape)
    y.backward(dy)
    assert _delta(before) == (7, 9, 0)
    grads = [p.grad.clone() for p in block.parameters()]
    block.zero_grad()
    xb = x.clone().requires_grad_()
    monkeypatch.setattr(sn, "_plain_route", lambda t: True)
    want = block(xb, feat)
    want.backward(dy)
    assert _delta(before) == (7, 9, 0)
    pairs = [(y, want), (xa.grad, xb.grad)] + [
        (g, p.grad) for g, p in zip(grads, block.parameters())]
    for got, ref in pairs:
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-4 * scale


# -- the benchmark's reader ------------------------------------------------

class _Trace:
    def __init__(self, segs):
        self._segs = segs

    def segments(self):
        return self._segs


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_elementwise_ms_reads_aten_and_the_fused_kernels():
    """elementwise_ms.serve: the median over batches of the device ms in
    ATen's elementwise and reduction kernels and the fused pair; None
    without such kernels or a trace (times in microseconds)."""
    from benchmark.harness import reader

    read = reader("elementwise_ms.serve")
    ew = "void at::native::elementwise_kernel<128, 2, ...>"
    vec = "void at::native::vectorized_elementwise_kernel<4, ...>"
    red = "void at::native::reduce_kernel<128, 4, ...>"
    ours = "void (anonymous namespace)::spade_norm_apply_kernel<true>"
    other = "conv3x3_f32_kernel<128, 128>"
    parent = [[(ew, 0, 50000), (vec, 50000, 60000), (other, 0, 9e5)],
              [(ew, 0, 55000), (red, 60000, 70000)],
              [(ew, 0, 60000), (vec, 60000, 80000)]]
    assert read(_Run(_Trace(parent))) == pytest.approx(65.0)
    change = [[(ours, 10, 1010), (ew, 2000, 2500)], [(ours, 0, 2000)]]
    assert read(_Run(_Trace(change))) == pytest.approx(1.75)
    assert read(_Run(_Trace([[(other, 0, 10)]]))) is None
    assert read(_Run(None)) is None
