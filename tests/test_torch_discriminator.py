"""The port's Discriminator (image D, 3+3 channels; parsing D, 7+3) against
pasta_tpu's, with the JAX weights carried across by
`io/from_jax.discriminator_jax_to_state_dict` (the inverse of
`import_discriminator_state`, epilogue fc order included).

Small config (32px, channel_base 1024, channel_max 128, c_dim 16, mbstd
group 2, conv_clamp 256). Tolerances: fp32 blocks, sums in different
orders through ~10 convs, 1e-5 relative to the output scale for logits and
input gradients. With bf16 blocks (num_bf16_res 2) both frameworks round
every conv's output and every gradient to bf16 (2^-8 relative), at
different points: logits within 1e-2 of their scale, input gradients
within 1e-1 in relative L2 norm (measured: 4-5%).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.io.torch_import import (import_discriminator_state,
                                       state_dict_to_numpy)
from pasta_tpu.models.discriminator import Discriminator as JaxD
from pasta_tpu.nn.layers import MinibatchStdLayer as JaxMbstd
from pasta_tpu.train.loss_terms import _ilv as jax_ilv
from pasta_tpu_torch.io.from_jax import discriminator_jax_to_state_dict
from pasta_tpu_torch.models import Discriminator
from pasta_tpu_torch.nn.layers import MinibatchStdLayer
from pasta_tpu_torch.train.loss_terms import _dilv, _ilv


RES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(channels, bf16):
    return dict(c_dim=16, img_resolution=RES, img_channels=channels,
                channel_base=1024, channel_max=128, conv_clamp=256.0,
                mbstd_group_size=2, num_bf16_res=bf16)


def _live_biases(tree, rng):
    """Nonzero biases (they initialise to 0), so every term is live."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _live_biases(value, rng)
        elif key == "bias":
            tree[key] = (rng.randn(*value.shape) * 0.2).astype(np.float32)


def _pair(channels, bf16, seed=0):
    cfg = _cfg(channels, bf16)
    rng = np.random.RandomState(seed)
    x = rng.randn(4, RES, RES, channels).astype(np.float32)
    c = rng.randn(4, 16).astype(np.float32)
    jd = JaxD(**cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jd.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            jnp.asarray(c)))
    _live_biases(variables, rng)
    port = Discriminator(**cfg)
    port.load_state_dict(discriminator_jax_to_state_dict(variables),
                         strict=True)
    return jd, variables, port, x, c


@pytest.mark.parametrize("channels", [6, 10])
def test_weights_round_trip_exactly(channels):
    _, variables, port, _, _ = _pair(channels, 0)
    back = import_discriminator_state(state_dict_to_numpy(port))
    ref = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(ref)
    for path, value in ref:
        assert np.array_equal(got[path], value), path


@pytest.mark.parametrize("bf16", [0, 2])
@pytest.mark.parametrize("channels", [6, 10])
def test_forward_and_input_grad(channels, bf16):
    jd, variables, port, x, c = _pair(channels, bf16, seed=channels + bf16)
    ref = np.asarray(jd.apply(variables, jnp.asarray(x), jnp.asarray(c)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(jd.apply(
        variables, a, jnp.asarray(c)))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, torch.from_numpy(c))
    (grad,) = torch.autograd.grad(torch.sin(out).sum(), xt)
    assert out.shape == (4, 1)
    grad = grad.numpy()
    if bf16 == 0:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        np.testing.assert_allclose(grad, jgrad, rtol=0,
                                   atol=1e-5 * np.abs(jgrad).max())
    else:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())
        rel = np.linalg.norm(grad - jgrad) / np.linalg.norm(jgrad)
        assert rel <= 1e-1, rel


def test_minibatch_std_vs_jax():
    x = np.random.RandomState(1).randn(8, 4, 4, 6).astype(np.float32)
    ref = JaxMbstd(group_size=4).apply({}, jnp.asarray(x))
    got = MinibatchStdLayer(group_size=4)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_interleaved_call_equals_separate_calls():
    """One D call on _ilv-stacked sub-batches equals separate calls when
    the mbstd group divides the sub-batch (the port's _ilv is JAX's)."""
    _, _, port, x, c = _pair(6, 0, seed=3)
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(x)] + [torch.from_numpy(
        rng.randn(*x.shape).astype(np.float32)) for _ in range(2)]
    cs = [torch.from_numpy(c)] * 3
    np.testing.assert_array_equal(
        _ilv(*xs).numpy(), np.asarray(jax_ilv(*[jnp.asarray(a.numpy())
                                                 for a in xs])))
    with torch.no_grad():
        sep = [port(a, b) for a, b in zip(xs, cs)]
        fused = _dilv(port(_ilv(*xs), _ilv(*cs)), 3)
    for a, b in zip(sep, fused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
