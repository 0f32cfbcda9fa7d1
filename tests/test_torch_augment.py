"""The port's ADA pipeline (train/augment.py) against pasta_tpu's.

Random draws differ between a JAX key and a torch.Generator, so parity
runs in the modes that draw nothing: `debug_percentile` (the reference's
deterministic parameters) and p = 0 (every gate closed: the identity
matrix whatever is drawn). The JAX side runs its two-pass warp
(`impl="twopass"`), the port's only geometric path; both cast to bf16
before it. Tolerances: the bf16 two-pass stage rounds each matmul's output
in bf16, 2^-7 of the output scale; the fp32 color and filter stages 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.train import augment as JA
from pasta_tpu_torch.train import augment as PA


KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed=0, n=2, res=64):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, res, res, 3) * 2 - 1).astype(np.float32)


def _both(x, p, dp, **cfg):
    jc = JA.AugmentConfig(**cfg) if cfg else JA.AugmentConfig.bgc()
    pc = PA.AugmentConfig(**cfg) if cfg else PA.AugmentConfig.bgc()
    ref = JA.augment_pipe(jnp.asarray(x), p, KEY, jc, debug_percentile=dp,
                          impl="twopass")
    got = PA.augment_pipe(torch.from_numpy(x), p,
                          torch.Generator().manual_seed(0), pc,
                          debug_percentile=dp)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("dp", [0.1, 0.35, 0.72])
def test_bgc_debug_percentile(dp):
    got, ref = _both(_x(), 1.0, dp)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("dp", [0.2, 0.8])
def test_color_stage(dp):
    got, ref = _both(_x(1), 1.0, dp, brightness=1, contrast=1, lumaflip=1,
                     hue=1, saturation=1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [dict(imgfilter=1), dict(cutout=1)])
def test_filter_and_cutout(cfg):
    got, ref = _both(_x(2), 1.0, 0.7, **cfg)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_p_zero_is_the_identity_warp():
    x = _x(3)
    got, ref = _both(x, 0.0, None)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the geometric stage still resamples (bf16, up- and down-FIR):
    # near the input away from the borders
    np.testing.assert_allclose(got[:, 4:-4, 4:-4], x[:, 4:-4, 4:-4],
                               atol=2e-2)


def test_fbank_equals_jax():
    np.testing.assert_array_equal(PA._make_fbank(), JA._make_fbank())


def test_grad_through_augment_vs_jax_vjp():
    x = _x(4)
    y = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    cfg = JA.AugmentConfig.bgc()
    _, vjp = jax.vjp(lambda a: JA.augment_pipe(
        a, 1.0, KEY, cfg, debug_percentile=0.35, impl="twopass"),
        jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(y))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = PA.augment_pipe(xt, 1.0, torch.Generator().manual_seed(0),
                          PA.AugmentConfig.bgc(), debug_percentile=0.35)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


def test_draws_change_images():
    """With p = 1 the generator's draws move the images, reproducibly."""
    x = torch.from_numpy(_x(6, n=4, res=32))
    a = PA.augment_pipe(x, 1.0, torch.Generator().manual_seed(1),
                        PA.AugmentConfig.bgc())
    b = PA.augment_pipe(x, 1.0, torch.Generator().manual_seed(1),
                        PA.AugmentConfig.bgc())
    assert torch.equal(a, b)
    assert not torch.allclose(a, x, atol=1e-2)
