"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Needs an NVIDIA GPU with nvcc; skips otherwise. The repo's conftest sets
up jax for the JAX package's tests, which this file does not need, so run
it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from pasta_tpu_torch.ops import conv3x3 as k1
from pasta_tpu_torch.ops._build import pin_fp32_numerics


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_fp32_numerics()
    return torch.device("cuda")


# (N, H, W', C_in, C_out, out_w): ragged W edges (out_w not a multiple of
# the bf16 kernel's 64-pixel tile), odd H, C_out below / equal to / not a
# multiple of the 64- or 128-channel tile (and, for the kernels' 16-byte
# stores, not a multiple of 8 or 4), and alignment columns past out_w + 2.
SHAPES = [
    (2, 5, 20, 64, 64, 18),
    (1, 3, 131, 128, 128, 129),
    (2, 4, 70, 64, 3, 60),
    (1, 6, 67, 128, 100, 65),
    (3, 2, 9, 64, 128, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_matches_plain(cuda, dtype, shape):
    n, h, wp, ci, co, out_w = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, h + 2, wp, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                         .astype(np.float32))
    xd, wd = x.to(cuda, dtype), w.to(cuda, dtype)
    before = k1.conv3x3_valid.launches
    got = k1.conv3x3_valid(xd, wd, out_w=out_w)
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches == before + 1
    assert got.shape == (n, h, out_w, co) and got.dtype == dtype
    # reference: the plain version in fp32 on the same (rounded) inputs
    ref = k1.conv3x3_valid_plain(xd.float(), wd.float(), out_w=out_w)
    err = (got.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    # bf16: the kernel's one rounding of an fp32 sum, 2^-8 relative, plus
    # fp32 summation order; fp32: summation order over 9*C_in terms only.
    bound = 2.0 ** -7 * scale if dtype == torch.bfloat16 else 1e-5 * scale
    assert err <= bound, (err, bound)


@pytest.mark.cuda
def test_k1_raises_out_of_scope(cuda):
    x = torch.zeros(1, 6, 6, 32, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w)
    x = torch.zeros(1, 6, 6, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w.new_zeros(3, 3, 64, 64))
    x = torch.zeros(1, 6, 6, 128, device=cuda,
                    dtype=torch.bfloat16)[:, :, :, :64]
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w.new_zeros(3, 3, 64, 64))


# K2 / K3 (csrc/shift.cu) from q against their plain versions: row counts
# that are a multiple of the 8-row block and of nothing larger, widths that
# are and are not whole 16-byte chunks (the vector and the scalar kernel),
# positions past both clamp limits of _shift_prep and offsets past the
# per-block clamp (38).
SHIFT_SHAPES = [(1000, 640, 131), (40, 384, 128), (8, 3200, 1048),
                (1000, 640, 132)]


def _shift_inputs(rows, v_dim, out_w, dtype, cuda):
    rng = np.random.RandomState(rows)
    hi = v_dim - out_w - 42
    q = rng.rand(rows) * hi
    q[::5] = hi + 10.0             # past the upper clamp
    q[1::7] = -3.0                 # below 0
    q[2::3] += rng.rand(len(q[2::3])) * 60   # spreads past 38 taps
    q = torch.from_numpy(q.astype(np.float32)).to(cuda)
    a = torch.from_numpy(rng.randn(rows, v_dim).astype(np.float32))
    d = torch.from_numpy(rng.randn(rows, out_w).astype(np.float32))
    return q, a.to(cuda, dtype), d.to(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHIFT_SHAPES)
def test_k2_k3_match_plain(cuda, dtype, shape):
    from pasta_tpu_torch.ops import affine_warp as aw

    rows, v_dim, out_w = shape
    q, wide, dout = _shift_inputs(rows, v_dim, out_w, dtype, cuda)
    n2, n3 = aw.shift_fwd.launches, aw.shift_bwd.launches
    got2 = aw.shift_fwd(wide, q, out_w)
    got3 = aw.shift_bwd(dout, q, v_dim)
    torch.cuda.synchronize()
    assert (aw.shift_fwd.launches, aw.shift_bwd.launches) == (n2 + 1, n3 + 1)
    ref2 = aw.shift_fwd_plain(wide, q, out_w)
    ref3 = aw.shift_bwd_plain(dout, q, v_dim)
    assert got2.shape == ref2.shape and got3.shape == ref3.shape
    # both sides round the same two products, add them in fp32 and round
    # once more (plain's other 38 terms are exact zeros)
    for got, ref in ((got2, ref2), (got3, ref3)):
        scale = ref.float().abs().max().item()
        bound = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6) * scale
        assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHIFT_SHAPES)
def test_k2_row_params_equal_shift_prep(cuda, shape):
    """The (s, f) the kernel derives from q, bit for bit `_shift_prep`'s,
    with rows at both clamps of q and at the offset clamp."""
    from pasta_tpu_torch.ops import affine_warp as aw

    rows, v_dim, out_w = shape
    q, wide, _ = _shift_inputs(rows, v_dim, out_w, torch.float32, cuda)
    _, s, f = aw._kernel("shift_fwd", wide, q, None, None, v_dim, out_w,
                         return_rows=True)
    s_ref, f_ref = aw._row_params_plain(q, out_w, v_dim)
    assert s.dtype == s_ref.dtype and torch.equal(s, s_ref)
    assert torch.equal(f, f_ref)
    assert s.min().item() == 0 and s.max().item() <= v_dim - out_w - 42
    if rows > 8:
        blocks = s.view(-1, 8)
        assert (blocks - blocks.amin(1, keepdim=True)).max().item() == 38


@pytest.mark.cuda
def test_k2_k3_raise_out_of_scope(cuda):
    from pasta_tpu_torch.ops import affine_warp as aw

    wide = torch.zeros(16, 256, device=cuda)
    q = torch.zeros(16, device=cuda)
    for bad in (lambda: aw.shift_fwd(wide[:12], q[:12], 64),    # R % 8
                lambda: aw.shift_fwd(wide, q, 220),             # no window
                lambda: aw.shift_fwd(wide.half(), q, 64),
                lambda: aw.shift_fwd(wide, q.double(), 64),
                lambda: aw.shift_fwd(wide[:, ::2], q, 64),
                lambda: aw.shift_bwd(wide, q.cpu(), 512),
                lambda: aw.shift_fwd_rows(wide, q, q, 64)):     # start fp32
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width", [(torch.float32, 333),
                                         (torch.float32, 336),
                                         (torch.bfloat16, 336)])
def test_k2_probe_two_taps(cuda, dtype, width):
    """The probes' form: (start, f) per row as given, any row count, a start
    anywhere in the row (columns past the end read as 0)."""
    from pasta_tpu_torch.ops import affine_warp as aw

    rng = np.random.RandomState(7)
    rows, length = 37, 520
    src = torch.from_numpy(rng.rand(rows, length).astype(np.float32)).to(
        cuda, dtype)
    d = torch.from_numpy(rng.rand(rows, width).astype(np.float32)).to(
        cuda, dtype)
    k = torch.from_numpy(rng.randint(0, length, rows).astype(np.int32)).to(
        cuda)
    f = torch.from_numpy(rng.rand(rows).astype(np.float32)).to(cuda)
    n2, n3 = aw.shift_fwd.launches, aw.shift_bwd.launches
    got = aw.shift_fwd_rows(src, k, f, width)
    got3 = aw.shift_bwd_rows(d, k, f, length)
    assert (aw.shift_fwd.launches, aw.shift_bwd.launches) == (n2 + 1, n3 + 1)
    idx = k.long()[:, None] + torch.arange(width, device=cuda)[None]
    padded = torch.nn.functional.pad(src.float(), (0, width + 1))
    want = (torch.gather(padded, 1, idx) * (1 - f)[:, None]
            + torch.gather(padded, 1, idx + 1) * f[:, None])
    bound = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert (got.float() - want).abs().max().item() <= bound
    ref3 = aw._shift_rows_adjoint_plain(d, k, aw._two_taps(f), length)
    assert (got3.float() - ref3.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_k3_double_backward(cuda, dtype):
    """R1's pattern through the pair on the card: the gradient of a function
    of the input gradient, against the same through the plain versions on
    the CPU. The launches alternate K2, K3, K2, K3 and no prep op runs."""
    from pasta_tpu_torch.ops import affine_warp as aw

    q, wide, _ = _shift_inputs(40, 384, 128, dtype, cuda)

    def second_order(x, qq):
        x = x.clone().requires_grad_(True)
        y = aw._row_shift(x, qq, 128)
        gx, = torch.autograd.grad(y.float().tanh().sum(), x,
                                  create_graph=True)
        g2, = torch.autograd.grad(gx.float().square().sum(), x)
        return y.detach(), gx.detach(), g2

    n2, n3 = aw.shift_fwd.launches, aw.shift_bwd.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = second_order(wide, q)
    torch.cuda.synchronize()
    assert (aw.shift_fwd.launches, aw.shift_bwd.launches) == (n2 + 2, n3 + 2)
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::one_hot", "aten::repeat_interleave",
                      "aten::floor", "aten::clamp", "aten::amin",
                      "aten::gather", "aten::scatter"}, ops
    ref = second_order(wide.cpu(), q.cpu())
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        # bf16: each of up to three chained results is rounded to 2^-9
        # relative on both sides, in the same order: 2^-6 of the scale
        bound = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * \
            r.float().abs().max().item()
        assert (g.cpu().float() - r.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_input_grad_matches_plain(cuda, dtype, shape):
    """dX and dW of the K1 Function against F.conv2d's autograd; dX runs
    K1 when C_out is in {64, 128}, the plain conv otherwise."""
    n, h, wp, ci, co, out_w = shape
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, h + 2, wp, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, h, out_w, co).astype(np.float32))
    xd = x.to(cuda, dtype).requires_grad_(True)
    wd = w.to(cuda, dtype).requires_grad_(True)
    before = k1.conv3x3_valid.launches_bwd
    dx, dw = torch.autograd.grad(k1.conv3x3_valid(xd, wd, out_w=out_w),
                                 (xd, wd), dy.to(cuda, dtype))
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches_bwd == before + int(co in (64, 128))
    xr = xd.detach().float().requires_grad_(True)
    wr = wd.detach().float().requires_grad_(True)
    dxr, dwr = torch.autograd.grad(
        k1.conv3x3_valid_plain(xr, wr, out_w=out_w), (xr, wr),
        dy.to(cuda).to(dtype).float())
    for got, ref in ((dx, dxr), (dw, dwr)):
        scale = ref.abs().max().item()
        bound = 2.0 ** -7 * scale if dtype == torch.bfloat16 else 1e-5 * scale
        assert (got.float() - ref).abs().max().item() <= bound


# The fp32 kernel (register-tiled FFMA, flat position tiles of 256 or 128)
# at the training path's four channel pairs, at a size where an image spans
# several tiles and rows wrap inside a tile.
FP32_PAIRS = [(128, 64), (64, 64), (64, 128), (128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", FP32_PAIRS)
def test_k1_fp32_training_pairs(cuda, ci, co):
    n, h, wd = 2, 37, 70
    rng = np.random.RandomState(ci + co)
    x = torch.from_numpy(rng.randn(n, h + 2, wd + 2, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, h, wd, co).astype(np.float32)).to(cuda)
    xd = x.to(cuda).requires_grad_(True)
    wk = w.to(cuda)
    fwd, bwd, f32 = (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_bwd,
                     k1.conv3x3_valid.launches_fp32)
    y = k1.conv3x3_valid(xd, wk)
    dx, = torch.autograd.grad(y, xd, dy)
    torch.cuda.synchronize()
    assert (k1.conv3x3_valid.launches, k1.conv3x3_valid.launches_bwd,
            k1.conv3x3_valid.launches_fp32) == (fwd + 1, bwd + 1, f32 + 2)
    xr = xd.detach().clone().requires_grad_(True)
    yr = k1.conv3x3_valid_plain(xr, wk)
    dxr, = torch.autograd.grad(yr, xr, dy)
    # fp32 sums of 9 * C_in (forward) or 9 * C_out (dX) products in another
    # order than cuDNN's: 1e-5 of the output scale
    for got, ref in ((y, yr), (dx, dxr)):
        assert got.shape == ref.shape
        bound = 1e-5 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= bound


@pytest.mark.cuda
def test_k1_fp32_double_backward(cuda):
    """R1's pattern through the fp32 kernel: the gradient of a function of
    dX with respect to x and w, against the same through F.conv2d. Every
    conv in it (forward, dX, and their gradients) runs the kernel."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 9, 13, 64).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(3, 3, 64, 64) / 24).astype(np.float32)
                         ).to(cuda)

    def second_order(conv):
        xa = x.clone().requires_grad_(True)
        wa = w.clone().requires_grad_(True)
        y = conv(xa, wa)
        gx, = torch.autograd.grad(y.tanh().sum(), xa, create_graph=True)
        return torch.autograd.grad(gx.square().sum(), (xa, wa))

    before = k1.conv3x3_valid.launches_bwd
    got = second_order(k1.conv3x3_valid)
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches_bwd >= before + 2
    ref = second_order(k1.conv3x3_valid_plain)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        # two chained fp32 convs and their products: 1e-4 of the scale
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


# The bf16 kernel (wgmma on TMA-loaded, swizzled rows) with pad 0 and with
# its implicit 2-px halo. (N, H_in, W_in, C_in, C_out, extra columns): the
# output is out_w = W_in + 2 pad - 2 + extra wide (extra < 0 leaves input
# columns unused, > 0 asks for columns no input reaches: zeros).
BF16_PAD_SHAPES = [(n, h + 2, wp, ci, co, out_w - (wp - 2))
                   for n, h, wp, ci, co, out_w in SHAPES] + [
    (1, 11, 23, 128, 7, -6),         # out_w 15 at pad 0
    (1, 3, 3, 64, 64, 0),            # the smallest pad-0 input: one output
    (1, 1, 3, 128, 64, 3),           # one row, a box far wider than W
    (2, 140, 70, 64, 64, -2),        # out_w 66: two columns left over by the
                                     # tiles, taken with the axes swapped
    (1, 200, 10, 128, 100, -5),      # out_w 3: only the swapped part runs
    (3, 150, 140, 128, 128, 0),      # C_out split over two blocks, 10 left
    (40, 40, 70, 128, 64, 0),        # more work items than blocks
    (150, 9, 70, 64, 128, 1),        # the same with three consumer groups
]


def _arange_inputs(n, h, w, ci, co, cuda):
    """Every input value distinct along a row's pixels and channels (and
    exactly representable in bf16), so that an operand read through a wrong
    swizzle or at a wrong pixel offset cannot give the right sums."""
    i = torch.arange(n * h * w * ci, device=cuda)
    x = ((i % 509) - 254).float().view(n, h, w, ci) / 64
    j = torch.arange(9 * ci * co, device=cuda)
    wt = ((j % 127) - 63).float().view(3, 3, ci, co) / 1024
    return x.to(torch.bfloat16), wt.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["randn", "arange"])
@pytest.mark.parametrize("shape,pad", [
    (s, p) for s in BF16_PAD_SHAPES for p in (0, 2) if s[1] + 2 * p >= 3])
def test_k1_bf16_pad_matches_plain(cuda, shape, pad, values):
    n, h, w, ci, co, extra = shape
    out_w = max(1, w + 2 * pad - 2 + extra)
    if values == "arange":
        xd, wd = _arange_inputs(n, h, w, ci, co, cuda)
    else:
        rng = np.random.RandomState(7)
        xd = torch.from_numpy(rng.randn(n, h, w, ci).astype(np.float32)).to(
            cuda, torch.bfloat16)
        wd = torch.from_numpy((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                              .astype(np.float32)).to(cuda, torch.bfloat16)
    got = k1._kernel(xd, wd, out_w, pad)
    torch.cuda.synchronize()
    ref = k1.conv3x3_valid_plain(xd.float(), wd.float(), out_w, pad)
    assert got.shape == ref.shape == (n, h + 2 * pad - 2, out_w, co)
    # one bf16 rounding of an fp32 sum against the fp32 sum
    bound = 2.0 ** -7 * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= bound


@pytest.mark.cuda
def test_k1_bf16_input_grad_is_one_launch_without_pad(cuda):
    """dX in bf16 launches K1 once on dY as it lies: no pad op runs."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 9, 20, 64).astype(np.float32)).to(
        cuda, torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy((rng.randn(3, 3, 64, 128) / 24).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    before = k1.conv3x3_valid.launches_bwd
    for strided in (False, True):
        y = k1.conv3x3_valid(x, w, out_w=15)
        # the gradient of a sum reaches the Function expanded (stride 0)
        loss = y.sum() if strided else (y * torch.ones_like(y)).sum()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            dx, = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        assert "aten::constant_pad_nd" not in {
            e.key for e in prof.key_averages()}
        assert dx.shape == x.shape and torch.all(dx[:, :, 17:] == 0)
        ref = k1.conv3x3_valid_plain(
            torch.ones_like(y).float(), w.float().flip(0, 1).transpose(2, 3),
            20, pad=2)
        assert ((dx.float() - ref).abs().max().item()
                <= 2.0 ** -7 * ref.abs().max().item())
    assert k1.conv3x3_valid.launches_bwd == before + 2


@pytest.mark.cuda
def test_k1_bf16_double_backward(cuda):
    """R1's pattern through the bf16 kernel: the input gradient (pad 2)
    with a graph, then the gradient of its square with respect to x and w
    (launches with pad 0 and 2), against the same through F.conv2d in
    fp32 on the same bf16 inputs."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 9, 13, 64).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 64, 64) / 24).astype(np.float32)
                         ).to(cuda, torch.bfloat16)

    def second_order(conv, dtype):
        xa = x.to(dtype).requires_grad_(True)
        wa = w.to(dtype).requires_grad_(True)
        y = conv(xa, wa)
        gx, = torch.autograd.grad(y.float().tanh().sum(), xa,
                                  create_graph=True)
        return torch.autograd.grad(gx.float().square().sum(), (xa, wa))

    before = k1.conv3x3_valid.launches_bwd
    got = second_order(k1.conv3x3_valid, torch.bfloat16)
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches_bwd >= before + 3
    ref = second_order(k1.conv3x3_valid_plain, torch.float32)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        # three chained bf16 results, each rounded to 2^-9 relative, and
        # their products: 2^-5 of the scale
        assert ((g.float() - r).abs().max().item()
                <= 2.0 ** -5 * r.abs().max().item())


@pytest.mark.cuda
def test_training_options_a_step_matches_cpu(cuda):
    """One step of the training options A (grad_accum 2, Gpl, the
    contextual loss, the doubled parsing-D phase, freeze-D) with Gpl and
    both R1 phases, at the narrow 64 px config (fp32, no noise, ADA p = 0),
    on the card against the CPU on the same directions: metrics 1e-2
    relative or 2e-3 absolute, each module's parameters 1e-4 of its norm
    (the CPU parity tests' whole-step budget)."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.state import batch_to, example_batch, init_state
    from pasta_tpu_torch.train.steps import fetch_metrics, make_train_step

    cfg = smoke_config(1, batch_size=4, use_noise=False, vgg_weight=20.0,
                       vgg_bf16=False, grad_accum=2, pl_weight=2.0,
                       contextual_weight=1.0, double_d_parsing=True,
                       freeze_d_layers=5)
    noise = torch.from_numpy(np.random.RandomState(1).randn(
        2, 64, 64, 3).astype(np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = init_state(cfg, seed=0, device=dev)
        vgg = VGG19Features(seed=3).to(dev).requires_grad_(False)
        batch = batch_to(example_batch(cfg, np.random.RandomState(0)), dev)
        _, m = make_train_step(cfg, vgg)(
            state, batch, torch.Generator(device=dev).manual_seed(0),
            do_r1_d=True, do_r1_dp=True, do_pl=True, pl_noise=noise.to(dev))
        out[dev.type] = (fetch_metrics([m])[0], {
            k: {n: p.detach().cpu() for n, p in
                getattr(state, k).named_parameters()}
            for k in ("g", "d", "dp")}, float(state.pl_mean))
    (mg, pg, lg), (mc, pc, lc) = out["cuda"], out["cpu"]
    for k, v in mc.items():
        assert abs(mg[k] - v) <= max(2e-3, 1e-2 * abs(v)), k
    for k in pc:
        num = sum((pg[k][n] - t).square().sum() for n, t in pc[k].items())
        den = sum(t.square().sum() for t in pc[k].values())
        assert (num / den).sqrt().item() <= 1e-4, k
    assert lc != 0 and abs(lg - lc) <= 1e-3 * abs(lc)


# K1's fp32 serving shapes (the fashion generator under cli.test's default
# --g-bf16-res 0): the VALID conv on the upsampled 514 input, the SAME
# 64-channel convs at 512^2 and the 128-channel one at 256^2, at the batch
# of cli.test's default (1) and of the smoke's inference runs (8).
FP32_SERVING = [(514, 128, 64), (514, 64, 64), (514, 64, 128),
                (258, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("hw,ci,co", FP32_SERVING)
def test_k1_fp32_serving_shapes(cuda, n, hw, ci, co):
    g = torch.Generator(device=cuda).manual_seed(hw + ci + co + n)
    x = torch.randn(n, hw, hw, ci, device=cuda, generator=g)
    w = torch.randn(3, 3, ci, co, device=cuda, generator=g) / (9 * ci) ** 0.5
    before = k1.conv3x3_valid.launches_fp32
    got = k1.conv3x3_valid(x, w)
    ref = k1.conv3x3_valid_plain(x, w)
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches_fp32 == before + 1
    assert got.shape == ref.shape == (n, hw - 2, hw - 2, co)
    assert ((got - ref).abs().max().item()
            <= 1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_k1_fp32_on_a_second_card(cuda):
    """The fp32 kernel's shared-memory attributes belong to the card that
    is current when they are set: one process launches it on cuda:0, then
    on cuda:1, at a serving shape, each against its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for index in (0, 1):
        dev = torch.device("cuda", index)
        g = torch.Generator(device=dev).manual_seed(index)
        x = torch.randn(8, 258, 258, 128, device=dev, generator=g)
        w = torch.randn(3, 3, 128, 128, device=dev, generator=g) / 34.0
        before = k1.conv3x3_valid.launches_fp32
        got = k1.conv3x3_valid(x, w)
        ref = k1.conv3x3_valid_plain(x, w)
        torch.cuda.synchronize(dev)
        assert k1.conv3x3_valid.launches_fp32 == before + 1
        assert got.device == dev and got.shape == ref.shape
        assert ((got - ref).abs().max().item()
                <= 1e-5 * ref.abs().max().item()), dev


@pytest.mark.cuda
def test_mesh_on_the_card(cuda):
    """TryonPipeline(mesh=...) on CUDA tensors: two shards on one card, and
    with two cards or more one shard a card, against the pipeline without
    a mesh at batch 4, within the JAX package's budget for its split;
    narrow 512 px generator, fp32, "random" noise of strength 0.05."""
    from pasta_tpu_torch.data.synthetic import make_garment, make_person
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval().to(cuda)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.05)
    kw = dict(mode="upper", noise_mode="random", seed=3)
    single = TryonPipeline(model, **kw)
    items = [single.prepare(make_person(s, jitter=3.0),
                            make_garment(1000 + s, jitter=3.0))
             for s in range(4)]
    ref = single.run_batch(items)
    meshes = [[cuda, cuda]]
    if torch.cuda.device_count() >= 2:
        meshes.append(["cuda:0", "cuda:1"])
    for mesh in meshes:
        with TryonPipeline(model, mesh=mesh, **kw) as pipe:
            got = pipe.run_batch(items)
        diff = (got - ref).abs()
        span = (ref.max() - ref.min()).item()
        assert got.device == ref.device, mesh
        assert diff.mean().item() / span < 1e-4, mesh
        assert (diff > 0.01 * span).float().mean().item() < 1e-3, mesh


@pytest.mark.cuda
def test_run_stream_on_the_card(cuda, tmp_path):
    """run_stream on CUDA tensors (pinned staging, copies that do not block
    the host, each output fetched one batch late) yields run_batch's
    outputs bit for bit, in order, the tail batch padded; narrow 512 px
    generator, fp32."""
    from pasta_tpu_torch.data.synthetic import write_tryon_root
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    root = str(tmp_path / "root")
    pairs = write_tryon_root(root, 5)
    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval().to(cuda)
    for noise_mode in ("const", "random"):
        pipe = TryonPipeline(model, mode="upper", noise_mode=noise_mode,
                             seed=3)
        streamed = list(pipe.run_stream(root, pairs, batch_size=2,
                                        num_workers=2))
        assert [c for c, _ in streamed] == [pairs[0:2], pairs[2:4],
                                            pairs[4:5]]
        ref = TryonPipeline(model, mode="upper", noise_mode=noise_mode,
                            seed=3)
        for i, (chunk, out) in enumerate(streamed):
            items = [ref.prepare_pair(root, p) for p in chunk]
            items += [items[-1]] * (2 - len(items))
            want = ref.run_batch(items).float().cpu().numpy()[:len(chunk)]
            assert out.dtype == np.float32 and np.array_equal(out, want)


def _graph_items(pipe, batch, tiled):
    """`batch` synthetic items whose paste tiles all fit (`tiled`), or of
    which at least the first does not."""
    from pasta_tpu_torch.data.synthetic import make_garment, make_person

    def item(s, jitter):
        return pipe.prepare(make_person(s, jitter=jitter),
                            make_garment(1000 + s, jitter=jitter))

    if tiled:
        items = [item(s, 3.0) for s in range(batch)]
        assert all(bool(it["tiles_fit"]) for it in items)
        return items
    seeds = iter(range(100, 200))
    first = next(it for it in map(lambda s: item(s, 40.0), seeds)
                 if not bool(it["tiles_fit"]))
    return [first] + [item(next(seeds), 40.0) for _ in range(batch - 1)]


def _k1_kernels(prof):
    """K1's kernels in a finished torch.profiler trace."""
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               and ("conv3x3_f32_kernel" in e.name
                    or "conv3x3_bf16_kernel" in e.name)
               for e in prof.events())


@pytest.fixture(scope="module")
def fashion_g():
    """The fashion generator at its published widths, fp32 and with its
    top three resolutions in bf16, built once for the graph tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pasta_tpu_torch.models import Generator

    pin_fp32_numerics()
    return {res: Generator(seed=0, num_bf16_res=res).eval().to("cuda")
            for res in (0, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_res", [0, 3])
@pytest.mark.parametrize("batch", [1, 8])
def test_run_batch_syncs_nothing_after_warm_up(cuda, fashion_g, batch,
                                               bf16_res):
    """A warmed-up run_batch (a replay) makes no call that waits for the
    card: torch.cuda.set_sync_debug_mode("error") raises nothing."""
    from pasta_tpu_torch.serving import TryonPipeline

    pipe = TryonPipeline(fashion_g[bf16_res], mode="upper")
    items = _graph_items(pipe, batch, tiled=True)
    pipe.run_batch(items)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe.run_batch(items)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert pipe.graph_counts == {"replay": 1, "capture": 1, "eager": 0}
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_res", [0, 3])
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("batch", [1, 8])
def test_graph_replay_equals_eager(cuda, fashion_g, batch, tiled, bf16_res):
    """The capture batch's output (its eager run) and a replay's are the
    eager pipeline's bit for bit (a one-card mesh runs eagerly), on the
    tiled and the full path, in fp32 and with the top three resolutions
    in bf16. A CUDA trace holds K1's kernels 26 times a batch, the
    replay's among them; K1's counters see the eager run's 26 alone (the
    capture runs nothing, the replay is the graph's launch)."""
    from pasta_tpu_torch.serving import TryonPipeline

    model = fashion_g[bf16_res]
    pipe = TryonPipeline(model, mode="upper")
    items = _graph_items(pipe, batch, tiled)
    with TryonPipeline(model, mode="upper", mesh=[cuda]) as eager:
        want = eager.run_batch(items)
    assert eager.graph_counts["eager"] == 1 and eager.graph_keys == 0
    before = k1.conv3x3_valid.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        captured = pipe.run_batch(items)
        replayed = pipe.run_batch(items)
        torch.cuda.synchronize()
    assert pipe.last_tiled == tiled
    assert pipe.graph_counts == {"replay": 1, "capture": 1, "eager": 0}
    assert k1.conv3x3_valid.launches - before == 26
    assert _k1_kernels(prof) == 2 * 26
    assert torch.equal(captured, want) and torch.equal(replayed, want)


@pytest.mark.cuda
def test_graph_counts_keys_and_kept_outputs(cuda):
    """One capture a batch key, replays after it; an image a caller holds
    is not changed by later batches of its key; narrow 512 px generator,
    fp32, batch keys 2 and 1."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval().to(cuda)
    pipe = TryonPipeline(model, mode="upper")
    items = _graph_items(pipe, 4, tiled=True)
    a, b = items[:2], items[2:]
    first = pipe.run_batch(a)
    held = pipe.run_batch(a)
    copy = held.clone()
    other = pipe.run_batch(b)
    pipe.run_batch(a[:1])
    pipe.run_batch(b[:1])
    torch.cuda.synchronize()
    assert pipe.graph_counts == {"replay": 3, "capture": 2, "eager": 0}
    assert pipe.graph_keys == 2
    assert torch.equal(held, copy) and torch.equal(first, held)
    assert not torch.equal(held, other)


@pytest.mark.cuda
def test_mesh_and_random_noise_stay_eager(cuda):
    """A mesh and noise_mode="random" run every batch eagerly, and their
    outputs agree with each other as before (one-card mesh against no
    mesh, the same seed); narrow 512 px generator, fp32, noise strengths
    0.05."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval().to(cuda)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.05)
    random = TryonPipeline(model, mode="upper", noise_mode="random", seed=3)
    items = _graph_items(random, 2, tiled=True)
    outs = [random.run_batch(items) for _ in range(2)]
    with TryonPipeline(model, mode="upper", noise_mode="random", seed=3,
                       mesh=[cuda]) as split:
        split_outs = [split.run_batch(items) for _ in range(2)]
    for pipe in (random, split):
        assert pipe.graph_counts == {"replay": 0, "capture": 0, "eager": 2}
        assert pipe.graph_keys == 0
    assert not torch.equal(outs[0], outs[1])
    assert all(torch.equal(o, s) for o, s in zip(outs, split_outs))


@pytest.mark.cuda
def test_run_batch_from_two_threads(cuda):
    """Two threads that call run_batch at once on batches of one key each
    get their own batch's image every time (one copies into the graph's
    inputs, replays and copies out before the other may), the first of
    them on a stream of its own; narrow 512 px generator, fp32, batch 2."""
    import sys
    import threading

    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    model = Generator(seed=0, img_resolution=512, channel_base=2048,
                      channel_max=128).eval().to(cuda)
    pipe = TryonPipeline(model, mode="upper")
    items = _graph_items(pipe, 4, tiled=True)
    batches = [items[:2], items[2:]]
    want = [pipe.run_batch(b) for b in batches]
    assert not torch.equal(want[0], want[1])
    got, start = [[], []], threading.Barrier(2)

    def serve(i):
        stream = torch.cuda.Stream() if i == 0 else None
        with torch.cuda.stream(stream):
            start.wait(timeout=60)
            for _ in range(8):
                got[i].append(pipe.run_batch(batches[i]))
            torch.cuda.current_stream().synchronize()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert pipe.graph_counts == {"replay": 17, "capture": 1, "eager": 0}
    for i in range(2):
        assert len(got[i]) == 8
        assert all(torch.equal(o, want[i]) for o in got[i])


# --------------------------------------------------------------------------
# upfirdn2d: the FIR resampling kernel (csrc/upfirdn2d.cu) against its plain
# version. Tolerances: fp32, summation order over at most 16 products,
# 1e-5 of the output's scale; bf16, the kernel's one rounding of an fp32
# sum against the plain version in fp32 on the same rounded inputs and
# taps, 2^-7 of the scale.

_FIR_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _fir():
    import importlib

    return importlib.import_module("pasta_tpu_torch.ops.upfirdn2d")


def _fir_close(got, want, dtype):
    scale = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert err <= _FIR_TOL[dtype] * scale, (err, scale)


def _fir_three_ways(cuda, shape, f, p, dtype, seed=0):
    """Forward, input gradient and the gradient of that gradient of the
    call with parameters `p`: the kernel's (through the Function) and the
    plain version's in fp32 on the same rounded inputs, compared; returns
    the kernel's launches (forward, for gradients) they took."""
    fir = _fir()
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x0 = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    fd = None if f is None else f.to(cuda)
    fr = None if fd is None else fd.to(dtype).float()
    counts = (fir.upfirdn2d.launches, fir.upfirdn2d.launches_bwd,
              fir.upfirdn2d.launches_plain)
    x = x0.clone().requires_grad_(True)
    y = fir._Upfirdn2d.apply(x, fd, p, False)
    assert y.is_contiguous() and y.dtype == dtype
    dy0 = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
    v0 = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    dy = dy0.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
    (ddy,) = torch.autograd.grad(dx, dy, v0)
    torch.cuda.synchronize()
    xr = x0.float().requires_grad_(True)
    yr = fir._plain(xr, fr, p)
    dyr = dy0.float().requires_grad_(True)
    (dxr,) = torch.autograd.grad(yr, xr, dyr, create_graph=True)
    (ddyr,) = torch.autograd.grad(dxr, dyr, v0.float())
    for got, want in ((y, yr), (dx, dxr), (ddy, ddyr)):
        assert got.shape == want.shape
        _fir_close(got, want.detach(), dtype)
    return (fir.upfirdn2d.launches - counts[0],
            fir.upfirdn2d.launches_bwd - counts[1],
            fir.upfirdn2d.launches_plain - counts[2])


def _fir_p(up, down, pad, flip=False, gain=1.0):
    up = (up, up) if isinstance(up, int) else up
    down = (down, down) if isinstance(down, int) else down
    return (*up, *down, *pad, flip, float(gain))


# Unusual calls: a random (non-symmetric) filter both ways round, 3 x 3,
# 1 x 4 and no filter; asymmetric up / down; crops; channel counts that
# take the one-channel path (3, 6 fp32), a 16-byte path with 1 or 2
# vectors a pixel (4, 8, 12 fp32; 8, 24 bf16); ragged tile edges.
_FIR_ODD = [
    ((2, 9, 11, 4), (4, 4), _fir_p(2, 1, (3, 2, 3, 2), gain=4)),
    ((1, 7, 5, 12), (4, 4), _fir_p(2, 1, (2, 1, 2, 1), flip=True, gain=4)),
    ((2, 13, 10, 8), (3, 3), _fir_p(1, 2, (1, 0, 2, 1), flip=True)),
    ((1, 10, 9, 3), (4, 4), _fir_p(2, 1, (2, 1, 2, 1), gain=4)),
    ((3, 6, 17, 6), (1, 4), _fir_p((2, 1), (1, 2), (2, 1, 0, 0))),
    ((1, 12, 12, 8), (4, 4), _fir_p(2, 2, (1, 1, 2, 2), gain=4)),
    ((2, 11, 8, 24), (4, 4), _fir_p(1, 1, (-1, 2, 3, -2))),
    ((1, 8, 7, 4), None, _fir_p(1, 1, (-1, -2, 1, 0))),
    ((1, 20, 70, 8), (4, 4), _fir_p(1, 2, (1, 1, 1, 1))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(_FIR_ODD)))
def test_upfirdn2d_odd_calls_match_plain(cuda, dtype, case):
    shape, fshape, p = _FIR_ODD[case]
    f = None
    if fshape is not None:
        rng = np.random.RandomState(case)
        f = torch.from_numpy(rng.rand(*fshape).astype(np.float32) + 0.1)
    n = _fir_three_ways(cuda, shape, f, p, dtype, seed=case)
    assert n == (1, 2, 0)


# The discriminators' resampling at batch 4 and their top three
# resolutions (bf16 in training, fp32 below): the filter pass ahead of
# conv1's stride-2 conv, and the skip's down 2.
_D_SHAPES = [(4, 512, 512, 64), (4, 256, 256, 128), (4, 128, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _D_SHAPES)
@pytest.mark.parametrize("down,pad", [(1, (2, 2, 2, 2)), (2, (1, 1, 1, 1))])
def test_upfirdn2d_discriminator_shapes(cuda, dtype, shape, down, pad):
    from pasta_tpu_torch.ops import setup_filter

    n = _fir_three_ways(cuda, shape, setup_filter([1, 3, 3, 1]),
                        _fir_p(1, down, pad), dtype)
    assert n == (1, 2, 0)


@pytest.mark.cuda
def test_upfirdn2d_serving_forward(cuda, fashion_g):
    """One serving forward at batch 8 (the fashion generator, fp32, run
    eagerly as a one-card mesh runs it) launches the kernel 28 times and
    takes the plain route never; then every FIR call it made, at its own
    shape and parameters, matches the plain version forward, backward and
    double backward."""
    from pasta_tpu_torch.serving import TryonPipeline

    fir = _fir()
    seen = []
    launch = fir._launch

    def record(x, f, p, bwd):
        seen.append((tuple(x.shape), f, p))
        return launch(x, f, p, bwd)

    model = fashion_g[0]
    pipe = TryonPipeline(model, mode="upper", mesh=[cuda])
    items = _graph_items(pipe, 8, tiled=True)
    before = (fir.upfirdn2d.launches, fir.upfirdn2d.launches_plain)
    fir._launch = record
    try:
        with pipe:
            pipe.run_batch(items)
        torch.cuda.synchronize()
    finally:
        fir._launch = launch
    assert (fir.upfirdn2d.launches - before[0],
            fir.upfirdn2d.launches_plain - before[1]) == (28, 0)
    assert len(seen) == 28
    calls = {(shape, p): f for shape, f, p in seen}
    for (shape, p), f in sorted(calls.items(), key=lambda c: c[0][0]):
        # (the SPADE encoder runs its two inputs as one batch of 16)
        assert shape[0] in (8, 16)
        n = _fir_three_ways(cuda, shape, f, p, torch.float32)
        assert n == (1, 2, 0)


# --------------------------------------------------------------------------
# spade_norm: SPADE's normalisation with the next conv's pre-activation
# (csrc/spade_norm.cu) against its plain chain on the card, fp32. Forward
# and dgb: 1e-5 of the scale (the moments summed in another order). The
# gradients are compared away from the relu and clamp kinks, where the two
# routes may round z or u to either side and an element's gradient is
# O(|dy|) on one route and 0 on the other (under 1e-3 of the values lie
# there); dx to 1e-4 of its scale, since every such element also moves
# its (n, c)'s two sums over H x W by O(|dy|) / (H W).


def _sn():
    import importlib

    return importlib.import_module("pasta_tpu_torch.ops.spade_norm")


def _sn_inputs(cuda, shape, layout, seed=0):
    """x [n, h, w, c], gb [n, h, w, 2c] (NHWC-contiguous as K1 writes it,
    or the permuted view of an NCHW tensor as F.conv2d leaves it) and dy,
    drawn on the card."""
    n, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=cuda) * 3 + 1
    if layout == "nhwc":
        gb = torch.randn((n, h, w, 2 * c), generator=gen, device=cuda)
    else:
        gb = torch.randn((n, 2 * c, h, w), generator=gen,
                         device=cuda).permute(0, 2, 3, 1)
    dy = torch.randn(shape, generator=gen, device=cuda)
    return x, gb * 0.5, dy


def _sn_run(x, gb, dy, gain, clamp, fn=None):
    sn = _sn()
    # (detach keeps gb's strides, where clone would make a sliced gb dense)
    xa, gba = x.detach().requires_grad_(), gb.detach().requires_grad_()
    y = (fn or sn.spade_norm_act)(xa, gba, gain, clamp)
    y.backward(dy)
    return y.detach(), xa.grad, gba.grad


def _sn_kinks(x, gb, gain, clamp):
    """Where z (the affine's output) or u (after relu and gain) lies within
    1e-4 of a kink, from float64 moments."""
    x64, gb64 = x.double(), gb.double()
    c = x.shape[-1]
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = (x64 - mean).square().mean(dim=(1, 2), keepdim=True)
    z = (x64 - mean) / torch.sqrt(var + 1e-5) * (1 + gb64[..., :c]) \
        + gb64[..., c:]
    u = z.clamp_min(0) * gain
    return (z.abs() < 1e-4) | ((u - clamp).abs() < 1e-4 * clamp)


def _sn_close(got, want, tol, keep=None):
    scale = want.abs().max().item()
    diff = (got - want).abs()
    if keep is not None:
        diff = diff[keep]
    assert diff.max().item() <= tol * scale, (diff.max().item(), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [((8, 512, 512, 64), "nhwc"),
                                          ((8, 256, 256, 128), "nhwc"),
                                          ((8, 256, 256, 128), "nchw")])
def test_spade_norm_matches_plain(cuda, shape, layout):
    """At the serving shapes (texture_b512's 64 channels, spade_b256's
    128; a serving batch and G's backward hand both an NHWC gb) and with
    an NCHW-backed gb (a permuted F.conv2d output, read along W): forward,
    dx and dgb against autograd through the plain chain; one kernel launch
    a forward apply, three a backward, none plain."""
    sn = _sn()
    x, gb, dy = _sn_inputs(cuda, shape, layout)
    gain, clamp = math.sqrt(2.0), 256.0 * math.sqrt(0.5)
    before = (sn.spade_norm_act.launches, sn.spade_norm_act.launches_bwd,
              sn.spade_norm_act.launches_plain)
    y, dx, dgb = _sn_run(x, gb, dy, gain, clamp)
    torch.cuda.synchronize()
    assert (sn.spade_norm_act.launches - before[0],
            sn.spade_norm_act.launches_bwd - before[1],
            sn.spade_norm_act.launches_plain - before[2]) == (3, 3, 0)
    assert y.is_contiguous() and dx.is_contiguous()
    yr, dxr, dgbr = _sn_run(x, gb, dy, gain, clamp,
                            fn=sn.spade_norm_act_plain)
    _sn_close(y, yr, 1e-5)
    kinks = _sn_kinks(x, gb, gain, clamp)
    assert kinks.float().mean().item() < 1e-3
    _sn_close(dgb, dgbr, 1e-5, ~torch.cat([kinks, kinks], dim=-1))
    _sn_close(dx, dxr, 1e-4, ~kinks)
    del x, gb, dy


# Odd calls: ragged tiles along W, one row, one image, C of 4 and 8 (one
# or two vectors a pixel) and 256, no clamp, a gb that needs a copy, and a
# dy that is a pad's gradient (strided NHWC, read in place) or an NCHW
# view (copied).
_SN_ODD = [
    ((1, 1, 37, 4), "nhwc", "contiguous", None),
    ((2, 5, 70, 8), "nchw", "nchw", 1.5),
    ((3, 9, 33, 256), "nchw", "padded", 20.0),
    ((2, 3, 130, 64), "sliced", "padded", 2.0),
    ((1, 17, 16, 128), "nhwc", "nchw", 3.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_SN_ODD)))
def test_spade_norm_odd_calls_match_plain(cuda, case):
    sn = _sn()
    shape, layout, dy_layout, clamp = _SN_ODD[case]
    n, h, w, c = shape
    x, gb, dy = _sn_inputs(cuda, shape, "nchw" if layout == "nchw"
                           else "nhwc", seed=case)
    if layout == "sliced":      # channel offset 1: neither layout
        wide = torch.randn((n, h, w, 2 * c + 1), device=cuda)
        wide[..., 1:] = gb
        gb = wide[..., 1:]
    if dy_layout == "padded":
        dy = torch.nn.functional.pad(dy, (0, 0, 1, 1, 1, 1))[:, 1:-1, 1:-1]
    elif dy_layout == "nchw":
        dy = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    y, dx, dgb = _sn_run(x, gb, dy, 1.3, clamp)
    yr, dxr, dgbr = _sn_run(x, gb, dy, 1.3, clamp,
                            fn=sn.spade_norm_act_plain)
    _sn_close(y, yr, 1e-5)
    kinks = _sn_kinks(x, gb, 1.3, float("inf") if clamp is None else clamp)
    _sn_close(dgb, dgbr, 1e-5, ~torch.cat([kinks, kinks], dim=-1))
    _sn_close(dx, dxr, 1e-4, ~kinks)


@pytest.mark.cuda
def test_spade_norm_repeats_bit_for_bit(cuda):
    """No atomics, fixed merge orders: two runs give the same bits, forward
    and backward, in both gb layouts."""
    for shape, layout in (((8, 256, 256, 128), "nchw"),
                          ((4, 512, 512, 64), "nhwc")):
        x, gb, dy = _sn_inputs(cuda, shape, layout, seed=11)
        first = _sn_run(x, gb, dy, 1.0, 181.0)
        second = _sn_run(x, gb, dy, 1.0, 181.0)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_spade_norm_in_a_cuda_graph(cuda):
    """The moments shared by two applies, captured into a CUDA graph with
    no call that waits for the card (set_sync_debug_mode("error")), then
    replayed on new inputs: the eager result bit for bit; a captured
    launch is not counted."""
    sn = _sn()
    x, gb, _ = _sn_inputs(cuda, (8, 256, 256, 128), "nchw", seed=12)
    x2, gb2, _ = _sn_inputs(cuda, (8, 256, 256, 128), "nchw", seed=13)
    sx, sgb = x.clone(), gb.clone()

    def step():
        stats = sn.spade_norm_stats(sx)
        return (sn.spade_norm_act(sx, sgb, 1.0, 181.0, stats=stats),
                sn.spade_norm_act(sx, sgb, 1.4, None, stats=stats))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = sn.spade_norm_act.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad(), torch.cuda.graph(graph):
            outs = step()
        sx.copy_(x2)
        sgb.copy_(gb2)
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sn.spade_norm_act.launches == before
    with torch.no_grad():
        stats = sn.spade_norm_stats(x2)
        want = (sn.spade_norm_act(x2, gb2, 1.0, 181.0, stats=stats),
                sn.spade_norm_act(x2, gb2, 1.4, None, stats=stats))
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_res", [0, 3])
def test_spade_norm_generator_forward(cuda, fashion_g, bf16_res):
    """One serving forward at batch 8, run eagerly as a one-card mesh runs
    it: in fp32 the three SPADE res-blocks launch 2 + 2 moments kernels and
    three applies each (21) and take the plain chain never; with the top
    three resolutions in bf16 all nine calls take the chain."""
    from pasta_tpu_torch.serving import TryonPipeline

    sn = _sn()
    pipe = TryonPipeline(fashion_g[bf16_res], mode="upper", mesh=[cuda])
    items = _graph_items(pipe, 8, tiled=True)
    before = (sn.spade_norm_act.launches, sn.spade_norm_act.launches_plain)
    with pipe:
        out = pipe.run_batch(items)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    want = (21, 0) if bf16_res == 0 else (0, 9)
    assert (sn.spade_norm_act.launches - before[0],
            sn.spade_norm_act.launches_plain - before[1]) == want


@pytest.mark.cuda
def test_spade_norm_second_backward_raises(cuda):
    sn = _sn()
    x, gb, _ = _sn_inputs(cuda, (2, 8, 8, 64), "nhwc", seed=14)
    x.requires_grad_()
    gb.requires_grad_()
    y = sn.spade_norm_act(x, gb, 1.0, None)
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()
