"""upfirdn2d (`ops/upfirdn2d.py`) as one torch.autograd.Function.

On the CPU the Function's forward runs `upfirdn2d_plain`, and its input
gradient is the same Function with transposed parameters; these tests hold
that gradient, and the gradient of that gradient (R1's double backward),
to what autograd gives through the plain path, for every class of call the
serving forward and the discriminators make. A stub launcher (a CPU
stand-in for the ctypes launch) drives the kernel route for the counters.
Tolerances: fp32 sums of at most 16 products in another order, 1e-5 of the
scale; bf16 one rounding of an fp32 sum on either side, 2^-7 of the scale.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from pasta_tpu_torch.ops import setup_filter

# the module (the package's attribute of that name is the function)
fir = importlib.import_module("pasta_tpu_torch.ops.upfirdn2d")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (up, down, padding, gain, channels) of each class of call: the synthesis
# blocks' conv0 (up 2 ahead of the 3x3 conv), the image upsamples of
# torgb (3 channels), the filter pass ahead of every stride-2 conv (the
# encoders', the SPADE encoder's and D's conv1), and the 1x1 skips' down 2
# (the SPADE encoder's and D's).
CLASSES = {
    "conv0_up2": (2, 1, (3, 2, 3, 2), 4.0, 8),
    "torgb_up2": (2, 1, (2, 1, 2, 1), 4.0, 3),
    "filter_pad2": (1, 1, (2, 2, 2, 2), 1.0, 8),
    "skip_down2": (1, 2, (1, 1, 1, 1), 1.0, 8),
}
SIZES = [(7, 6), (8, 9)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _call(cls, x, f, fn=None):
    up, down, pad, gain, _ = CLASSES[cls]
    return (fn or fir.upfirdn2d)(x, f, up=up, down=down, padding=pad,
                                 gain=gain)


def _close(got, want, dtype):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_transposed_gradients_equal_autograd_of_plain(cls, hw, dtype):
    """dX and the gradient of dX (with respect to dY) through the Function
    equal autograd's through the plain path."""
    rng = np.random.RandomState(0)
    c = CLASSES[cls][4]
    f = setup_filter([1, 3, 3, 1])
    x0 = torch.from_numpy(rng.randn(2, *hw, c).astype(np.float32)).to(dtype)
    out = {}
    for name, fn in (("function", None), ("plain", fir.upfirdn2d_plain)):
        x = x0.clone().requires_grad_(True)
        y = _call(cls, x, f, fn)
        if not out:
            dy0 = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
            v0 = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
        dy = dy0.to(dtype).requires_grad_(True)
        (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
        (ddy,) = torch.autograd.grad(dx, dy, v0.to(dtype))
        out[name] = (y, dx, ddy)
    for got, want in zip(out["function"], out["plain"]):
        assert got.shape == want.shape and got.dtype == want.dtype
        _close(got, want, dtype)


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_function_gradgradcheck_fp64(cls):
    """The Function itself (plain forward, transposed backward) passes
    gradcheck and gradgradcheck in fp64 (a dtype the kernel does not take,
    so the Function is applied directly)."""
    up, down, pad, gain, c = CLASSES[cls]
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 5, 6, c))
    f = setup_filter([1, 3, 3, 1])
    p = (up, up, down, down, *pad, False, gain)
    fn = lambda a: fir._Upfirdn2d.apply(a, f, p, False)  # noqa: E731
    x.requires_grad_(True)
    assert gradcheck(fn, (x,))
    assert gradgradcheck(fn, (x,))


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_transposed_twice_is_the_call(cls):
    """Transposing the parameters twice gives back the call's output
    shape and values (the double backward runs the forward's op)."""
    up, down, pad, gain, c = CLASSES[cls]
    f = setup_filter([1, 3, 3, 1])
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 9, 7, c)
                         .astype(np.float32))
    p = (up, up, down, down, *pad, False, gain)
    y = fir._plain(x, f, p)
    t = fir._transposed(p, f, (9, 7), tuple(y.shape[1:3]))
    dx = fir._plain(y, f, t)
    assert dx.shape == x.shape
    tt = fir._transposed(t, f, tuple(y.shape[1:3]), (9, 7))
    assert torch.equal(fir._plain(x, f, tt), y)


@pytest.fixture
def counters(monkeypatch):
    for name in ("launches", "launches_bwd", "launches_plain"):
        monkeypatch.setattr(fir.upfirdn2d, name, 0)
    return lambda: (fir.upfirdn2d.launches, fir.upfirdn2d.launches_bwd,
                    fir.upfirdn2d.launches_plain)


def test_cpu_tensors_take_the_plain_version(monkeypatch, counters):
    """A CPU tensor in the kernel's scope computes the plain version and
    never reaches the launch; nothing is counted."""
    def refuse(*a):
        raise AssertionError("the kernel was reached from a CPU tensor")

    monkeypatch.setattr(fir, "_kernel", refuse)
    x = torch.randn(2, 8, 8, 4, requires_grad=True)
    f = setup_filter([1, 3, 3, 1])
    y = fir.upfirdn2d(x, f, up=2, padding=(3, 2, 3, 2), gain=4)
    y.sum().backward()
    assert torch.equal(y, fir.upfirdn2d_plain(x, f, up=2,
                                              padding=(3, 2, 3, 2), gain=4))
    assert counters() == (0, 0, 0)


OUT_OF_SCOPE = [
    ([1, 3, 3, 1, 2, 2, 1, 1, 3, 3, 1, 1], dict(padding=2)),
    ([1, 3, 3, 1], dict(up=4, padding=2)),
    ([1, 3, 3, 1], dict(down=(1, 3), padding=1)),
    ([1, 2, 3, 4, 3, 2, 1], dict(padding=3)),
]


@pytest.fixture
def kernel_refused(monkeypatch):
    """The kernel route forced on CPU tensors; reaching the launch fails."""
    monkeypatch.setattr(fir, "_plain_route", lambda x: False)

    def refuse(*a):
        raise AssertionError("the kernel was reached outside its scope")

    monkeypatch.setattr(fir, "_kernel", refuse)


@pytest.mark.parametrize("taps,kw", OUT_OF_SCOPE)
def test_out_of_scope_takes_the_plain_route(kernel_refused, counters, taps,
                                            kw):
    """A 1-D 12-tap filter, up 4, down 3 and a 7 x 7 filter fall outside
    the kernel's scope by the shape test: the plain route, counted, on any
    device (here the kernel route is forced and must not be taken)."""
    x = torch.randn(1, 9, 10, 4)
    f = setup_filter(taps)
    y = fir.upfirdn2d(x, f, **kw)
    assert torch.equal(y, fir.upfirdn2d_plain(x, f, **kw))
    assert counters() == (0, 0, 1)


@pytest.mark.parametrize("taps,kw", OUT_OF_SCOPE)
def test_out_of_scope_gradients_stay_in_the_function(kernel_refused,
                                                     counters, taps, kw):
    """Outside the scope a call is still the one Function: its input
    gradient and the gradient of that gradient equal autograd's through
    the plain path, and each takes the plain route again, counted, so no
    route differentiates a grouped conv."""
    rng = np.random.RandomState(3)
    f = setup_filter(taps)
    x0 = torch.from_numpy(rng.randn(1, 9, 10, 4).astype(np.float32))
    out = {}
    for name, fn in (("function", fir.upfirdn2d),
                     ("plain", fir.upfirdn2d_plain)):
        x = x0.clone().requires_grad_(True)
        y = fn(x, f, **kw)
        if not out:
            dy0 = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
            v0 = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
        dy = dy0.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
        (ddy,) = torch.autograd.grad(dx, dy, v0)
        out[name] = (y, dx, ddy)
        if name == "function":
            assert counters() == (0, 0, 3)
    for got, want in zip(out["function"], out["plain"]):
        assert got.shape == want.shape
        _close(got, want, torch.float32)


def test_fp16_and_empty_batches_are_out_of_scope():
    f = setup_filter([1, 3, 3, 1])
    p = (2, 2, 1, 1, 3, 2, 3, 2, False, 4.0)
    assert fir.in_scope(torch.zeros(1, 4, 4, 8), f, p)
    assert fir.in_scope(torch.zeros(1, 4, 4, 3, dtype=torch.bfloat16), None,
                        (1, 1, 2, 2, 0, 0, 0, 0, False, 1.0))
    assert not fir.in_scope(torch.zeros(1, 4, 4, 8, dtype=torch.float16), f, p)
    assert not fir.in_scope(torch.zeros(0, 4, 4, 8), f, p)
    assert not fir.in_scope(torch.zeros(1, 4, 4, 8), f,
                            (1, 1, 1, 1, -3, -3, 0, 0, False, 1.0))


@pytest.fixture
def kernel_route(monkeypatch, counters):
    """The CUDA route on CPU tensors: `_kernel` replaced by the plain
    version without autograd history, as the launch returns."""
    calls = []

    def stub(x, f, p):
        assert x.is_contiguous()
        calls.append(p)
        with torch.no_grad():
            return fir._plain(x, f, p).contiguous()

    monkeypatch.setattr(fir, "_plain_route", lambda x: False)
    monkeypatch.setattr(fir, "_kernel", stub)
    return calls


def test_kernel_route_counts_forward_and_gradient_launches(kernel_route,
                                                           counters):
    """One launch forward; the gradient one launch with the transposed
    parameters, its own gradient one more with the call's again."""
    f = setup_filter([1, 3, 3, 1])
    x = torch.randn(2, 6, 5, 8, requires_grad=True)
    y = fir.upfirdn2d(x, f, up=2, padding=(3, 2, 3, 2), gain=4)
    assert counters() == (1, 0, 0)
    dy = torch.randn(y.shape, requires_grad=True)
    (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
    assert counters() == (1, 1, 0)
    (ddy,) = torch.autograd.grad(dx, dy, torch.randn(x.shape))
    assert counters() == (1, 2, 0)
    assert kernel_route[1][:4] == (1, 1, 2, 2) and kernel_route[1][8]
    assert kernel_route[2] == kernel_route[0]
    assert ddy.shape == y.shape


def test_serving_forward_is_28_launches(kernel_route, counters):
    """One forward of the serving path (a narrow 512 px generator: the
    published one's resolutions and resampling layers) makes 28 FIR calls,
    every one in the kernel's scope."""
    from pasta_tpu_torch.data.synthetic import make_garment, make_person
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval()
    pipe = TryonPipeline(model, mode="upper")
    items = [pipe.prepare(make_person(0, jitter=3.0),
                          make_garment(1000, jitter=3.0))]
    with torch.no_grad():
        pipe.run_batch(items)
    assert counters() == (28, 0, 0)
    ups = sorted((p[0], p[2], p[4:8]) for p in kernel_route)
    assert ups.count((2, 1, (3, 2, 3, 2))) == 7
    assert ups.count((2, 1, (2, 1, 2, 1))) == 7
    assert ups.count((1, 1, (2, 2, 2, 2))) == 13
    assert ups.count((1, 2, (1, 1, 1, 1))) == 1


class _Trace:
    def __init__(self, segs):
        self._segs = segs

    def segments(self):
        return self._segs


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_fir_ms_reads_the_kernel_and_the_grouped_convs_it_replaced():
    """The benchmark's fir_ms.serve: the median over batches of the device
    ms in the FIR kernels, whichever of the port's kernel or cuDNN's and
    ATen's depthwise convs ran them; None without such kernels or a
    trace (times in microseconds, as the trace holds them)."""
    from benchmark.harness import reader

    read = reader("fir_ms.serve")
    grouped = "void cudnn::cnn::conv2d_grouped_direct_kernel<false, true>"
    aten = "void at::native::conv_depthwise2d_forward_kernel<float>"
    ours = "void (anonymous namespace)::upfirdn2d_kernel<float, 4, 1>"
    other = "conv3x3_f32_kernel<128, 128>"
    parent = [[(grouped, 0, 70000), (aten, 70000, 82000), (other, 0, 9e5)],
              [(grouped, 0, 75000), (aten, 80000, 92500)],
              [(grouped, 0, 80000), (aten, 80000, 93000)]]
    assert read(_Run(_Trace(parent))) == pytest.approx(87.5)
    change = [[(ours, 10, 1010), (ours, 2000, 2500)], [(ours, 0, 2000)]]
    assert read(_Run(_Trace(change))) == pytest.approx(1.75)
    assert read(_Run(_Trace([[(other, 0, 10)]]))) is None
    assert read(_Run(None)) is None
