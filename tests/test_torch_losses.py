"""The port's losses (losses/gan.py, parsing.py, vgg.py) against pasta_tpu's.

VGG19 runs with seeded random weights (the repository holds no VGG19
checkpoint), carried from the JAX initialisation into the port by
`io/from_jax.vgg19_jax_to_state_dict`. Tolerances: fp32 reductions in
different orders, 1e-5 relative; the VGG pyramid through 13 convs 1e-4
relative to each slice's scale (2^-7 with a bf16 input).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.losses import gan as jgan
from pasta_tpu.losses import parsing as jparsing
from pasta_tpu.losses import vgg as jvgg
from pasta_tpu_torch.io.from_jax import vgg19_jax_to_state_dict
from pasta_tpu_torch.losses import gan, parsing, vgg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_gan_losses():
    rng = np.random.RandomState(0)
    real, fake = rng.randn(2, 8, 1).astype(np.float32) * 3
    np.testing.assert_allclose(
        gan.g_nonsat_loss(_t(fake)).item(),
        float(jgan.g_nonsat_loss(jnp.asarray(fake))), rtol=1e-6)
    for kw in (dict(real_logits=real), dict(fake_logits=fake),
               dict(real_logits=real, fake_logits=fake)):
        np.testing.assert_allclose(
            float(gan.d_logistic_loss(**{k: _t(v) for k, v in kw.items()})),
            float(jgan.d_logistic_loss(
                **{k: jnp.asarray(v) for k, v in kw.items()})), rtol=1e-6)


def test_r1_penalty():
    """R1 of a smooth nonlinear function against the JAX penalty, and its
    parameter gradient (the double backward) against jax.grad."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 4, 2).astype(np.float32)
    w = rng.randn(2).astype(np.float32)

    def j_r1(wj):
        return jgan.r1_penalty(lambda im: jnp.tanh(im @ wj).sum((1, 2)), x)

    wt = _t(w).requires_grad_(True)
    r1 = gan.r1_penalty(lambda im: torch.tanh(im @ wt).sum((1, 2)), _t(x))
    (gw,) = torch.autograd.grad(r1, wt)
    np.testing.assert_allclose(r1.item(), float(j_r1(jnp.asarray(w))),
                               rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(),
                               np.asarray(jax.grad(j_r1)(jnp.asarray(w))),
                               rtol=1e-5)


@pytest.mark.parametrize("ignore", [False, True])
def test_weighted_parsing_ce(ignore):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 8, 8, 7).astype(np.float32) * 2
    targets = rng.randint(0, 7, (2, 8, 8)).astype(np.int32)
    if ignore:
        targets[:, :3] = 255
    ref = jparsing.weighted_parsing_ce(jnp.asarray(logits),
                                       jnp.asarray(targets))
    got = parsing.weighted_parsing_ce(_t(logits), _t(targets).long())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@pytest.fixture(scope="module")
def vgg_pair():
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jvgg.VGG19Features().init(jax.random.PRNGKey(1),
                                              jnp.asarray(x)))
    port = vgg.VGG19Features(seed=5)
    port.load_state_dict(vgg19_jax_to_state_dict(params), strict=True)
    return params, port


def test_vgg19_weights_round_trip(vgg_pair):
    params, port = vgg_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = jvgg.import_vgg19_torch_state(sd)["params"]
    assert sorted(back) == sorted(params["params"])
    for k, v in params["params"].items():
        assert np.array_equal(back[k], v), k


@pytest.mark.parametrize("bf16", [False, True])
def test_vgg19_features(vgg_pair, bf16):
    """With a bf16 input only the first conv is bf16 in both frameworks:
    its fp32 bias promotes the rest to fp32."""
    params, port = vgg_pair
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    ref = jvgg.vgg_features(params, jnp.asarray(x),
                            dtype=jnp.bfloat16 if bf16 else None)
    got = vgg.vgg_features(port, _t(x),
                           dtype=torch.bfloat16 if bf16 else None)
    assert len(got) == 5
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        # bf16: conv1_1's outputs are one bf16 rounding of an fp32 sum
        tol = 2.0 ** -7 if bf16 else 1e-4
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=tol * np.abs(b).max())


def test_vgg_loss_and_grad(vgg_pair):
    params, port = vgg_pair
    rng = np.random.RandomState(6)
    x, y = rng.rand(2, 2, 32, 32, 3).astype(np.float32)
    ref, jg = jax.value_and_grad(lambda a: jvgg.vgg_loss(
        params, a, jnp.asarray(y)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    loss = vgg.vgg_loss(port, xt, _t(y))
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(jg)).max())
