"""The port's layer zoo (pasta_tpu_torch/nn/legacy.py) and patch
co-occurrence discriminator (models/patch_discriminator.py) against the JAX
package's on the CPU, as tests/test_legacy_layers.py holds the JAX ones.

Each JAX module is initialized with its own key; its variables cross into
the port by name (`io/from_jax.py::legacy_jax_to_state_dict` for the zoo,
`jax_to_state_dict` for the patch D, strict loads) and both run on the
same seeded numpy inputs. The random helpers are fed the JAX draws' numbers
(their `_uniform` replaced by the JAX package's uniforms in draw order).

Tolerances: outputs, gradients and batch statistics within 1e-5 of their
largest magnitude for single layers, 1e-4 for the deep stacks (the
8-conv FeatureEncoder, the patch D's encoder); fp32 sums in other orders.
The patch D's input gradient crop by crop: all but one crop within 1e-4
(a leaky-ReLU input within rounding of 0 may take the other slope).
Shapes and index maps exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.models.patch_discriminator import (
    PatchCoOccurrenceDiscriminator as JaxPatchD)
from pasta_tpu.nn import legacy as jl
from pasta_tpu_torch.io.from_jax import (jax_to_state_dict,
                                         legacy_jax_to_state_dict)
from pasta_tpu_torch.models import PatchCoOccurrenceDiscriminator
from pasta_tpu_torch.nn import legacy as pl

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, (
        np.abs(got - ref).max(), scale)


def _crossed(jmod, pmod, *inputs, **kw):
    """Init the JAX module, load its variables into the port module, run
    both; returns (port output, JAX output, JAX variables)."""
    args = [jnp.asarray(a) for a in inputs]
    variables = jax.jit(lambda *a: jmod.init(KEY, *a, **kw))(*args)
    pmod.load_state_dict(legacy_jax_to_state_dict(variables), strict=True)
    got = pmod(*[torch.from_numpy(a) for a in inputs], **kw)
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(variables, *args)
    return got, ref, variables


def test_feature_encoder():
    x = _rand(0, 1, 128, 128, 5)
    got, ref, _ = _crossed(jl.FeatureEncoder(input_nc=5, ngf=8),
                           pl.FeatureEncoder(5, ngf=8), x)
    assert got.shape == (1, 1, 1, 64)
    _close(got, ref, 1e-4)


def test_partial_conv_and_resblock():
    x = _rand(1, 2, 16, 16, 4)
    mask = np.zeros((2, 16, 16, 1), np.float32)
    mask[:, 4:12, 3:13] = 1.0
    got, ref, _ = _crossed(jl.PartialConv2dLayer(4, 6, 3, activation="lrelu"),
                           pl.PartialConv2dLayer(4, 6, 3, activation="lrelu"),
                           x, mask)
    assert np.isfinite(got.detach().numpy()).all()
    _close(got, ref)
    got, ref, _ = _crossed(jl.PartialResBlock(4, 8, down=2),
                           pl.PartialResBlock(4, 8, down=2), x, mask)
    assert got.shape == (2, 8, 8, 8)
    _close(got, ref)


def test_space_to_depth_channel_normalize_apply_offset():
    x = _rand(2, 2, 4, 6, 3)
    np.testing.assert_array_equal(
        pl.space_to_depth(torch.from_numpy(x), 2).numpy(),
        np.asarray(jl.space_to_depth(jnp.asarray(x), 2)))
    _close(pl.channel_normalize(torch.from_numpy(x)),
           jl.channel_normalize(jnp.asarray(x)))
    off = _rand(3, 2, 5, 7, 2)
    _close(pl.apply_offset(torch.from_numpy(off)),
           jl.apply_offset(jnp.asarray(off)))


def test_self_attention():
    """gamma is drawn as 0 (the block starts as the identity); it is set
    to 0.7 on both sides so that the attention path shows."""
    x = _rand(4, 2, 8, 8, 16)
    jmod = jl.SelfAttention(channels=16)
    variables = jax.jit(jmod.init)(KEY, jnp.asarray(x))
    variables = jax.tree_util.tree_map(lambda v: v, variables)
    variables["params"]["gamma"] = jnp.asarray(0.7)
    pmod = pl.SelfAttention(16)
    pmod.load_state_dict(legacy_jax_to_state_dict(variables), strict=True)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    _close(pmod(torch.from_numpy(x)), ref)
    assert not np.allclose(np.asarray(ref), x)


def test_spade_modulated_conv():
    x, style = _rand(5, 2, 8, 8, 4), _rand(6, 2, 8, 8, 4)
    got, ref, _ = _crossed(jl.SpadeModulatedConv2d(4, 6),
                           pl.SpadeModulatedConv2d(4, 6), x, style)
    _close(got, ref)


@pytest.mark.parametrize("deep", [False, True])
def test_mask_torgb(deep):
    x, w = _rand(7, 2, 8, 8, 8), _rand(8, 2, 16)
    got, ref, _ = _crossed(
        jl.MaskPredictingToRGB(8, 3, w_dim=16, is_last=True, deep_heads=deep),
        pl.MaskPredictingToRGB(8, 3, w_dim=16, is_last=True,
                               deep_heads=deep), x, w)
    for g, r in zip(got, ref):
        _close(g, r)
    mask = got[1].detach()
    assert 0 <= float(mask.min()) <= float(mask.max()) <= 1


@pytest.mark.parametrize("with_r", [False, True])
def test_coord_conv(with_r):
    x = _rand(9, 2, 8, 8, 2)
    got, ref, _ = _crossed(jl.CoordConv(out_channels=4, with_r=with_r),
                           pl.CoordConv(2, 4, with_r=with_r), x)
    _close(got, ref)


def test_spectral_normalize():
    w, u = _rand(10, 8, 16), _rand(11, 8)
    tw, tu = torch.from_numpy(w), torch.from_numpy(u)
    jw, ju = jnp.asarray(w), jnp.asarray(u)
    for _ in range(30):
        tw_sn, tu = pl.spectral_normalize(tw, tu)
        jw_sn, ju = jl.spectral_normalize(jw, ju)
    _close(tw_sn, jw_sn)
    assert abs(np.linalg.svd(tw_sn.numpy(), compute_uv=False)[0] - 1) < 1e-3


def _jax_uniforms(monkeypatch, draws):
    """Replace the port's `_uniform` by the given JAX draws, in order."""
    queue = [np.asarray(d) for d in draws]

    def fed(generator, shape, low=0.0, high=1.0):
        d = queue.pop(0)
        assert d.shape == tuple(shape)
        return torch.from_numpy(np.array(d))

    monkeypatch.setattr(pl, "_uniform", fed)
    return queue


def test_random_affine_and_crops(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    m = pl.random_affine_matrix(gen, 4)           # the generator's own draws
    assert m.shape == (4, 3, 3) and torch.isfinite(m).all()
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    queue = _jax_uniforms(monkeypatch, [
        jax.random.uniform(k1, (4,), minval=-10.0, maxval=10.0),
        jax.random.uniform(k2, (4,), minval=-0.05, maxval=0.05),
        jax.random.uniform(k3, (4,), minval=-0.05, maxval=0.05),
        jax.random.uniform(k4, (4,), minval=-0.05, maxval=0.05)])
    _close(pl.random_affine_matrix(gen, 4), jl.random_affine_matrix(KEY, 4))
    assert not queue
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    k1, k2, k3 = jax.random.split(KEY, 3)
    _jax_uniforms(monkeypatch, [
        jax.random.uniform(k1, (2, 3), minval=0.25, maxval=0.5),
        jax.random.uniform(k2, (2, 3)), jax.random.uniform(k3, (2, 3))])
    crops = pl.apply_random_crop(torch.from_numpy(x), gen, 16, num_crops=3)
    assert crops.shape == (2, 3, 16, 16, 3)
    _close(crops, jax.jit(lambda v: jl.apply_random_crop(
        v, KEY, target_size=16, num_crops=3))(jnp.asarray(x)), 1e-4)


def _train_mode(jmod, pmod, x):
    """Both modules in training mode: outputs and the batch statistics
    each BatchNorm moved to."""
    variables = jax.jit(lambda a: jmod.init(KEY, a))(jnp.asarray(x))
    pmod.load_state_dict(legacy_jax_to_state_dict(variables), strict=True)
    ref, upd = jax.jit(lambda v, a: jmod.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    got = pmod(torch.from_numpy(x), train=True)
    _close(got, ref)
    moved = legacy_jax_to_state_dict(dict(upd))
    state = pmod.state_dict()
    assert moved and all(k in state for k in moved)
    for k, v in moved.items():
        _close(state[k], v.numpy())
    # eval mode on the moved statistics
    evaluated = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        {**variables, **upd}, jnp.asarray(x))
    _close(pmod(torch.from_numpy(x), train=False), evaluated)
    return got


@pytest.mark.parametrize("downsample,use_coord", [(True, False),
                                                  (False, True)])
def test_encoder_block(downsample, use_coord):
    x = _rand(12, 2, 16, 16, 8)
    got = _train_mode(
        jl.EncoderBlock(out_channels=12, downsample=downsample,
                        use_coord=use_coord),
        pl.EncoderBlock(8, 12, downsample=downsample, use_coord=use_coord),
        x)
    assert got.shape == ((2, 8, 8, 12) if downsample else (2, 16, 16, 12))


@pytest.mark.parametrize("upsample", [True, False])
def test_resblock_decoder(upsample):
    x = _rand(13, 2, 8, 8, 16)
    out = 8 if upsample else 16
    got = _train_mode(jl.ResBlockDecoder(out_channels=out, upsample=upsample),
                      pl.ResBlockDecoder(16, out, upsample=upsample), x)
    assert got.shape == ((2, 16, 16, 8) if upsample else (2, 8, 8, 16))


@pytest.mark.parametrize("use_coord", [False, True])
def test_jump(use_coord):
    x = _rand(14, 2, 8, 8, 16)
    got = _train_mode(jl.Jump(out_channels=3, use_coord=use_coord),
                      pl.Jump(16, 3, use_coord=use_coord), x)
    assert got.shape == (2, 8, 8, 3)


@pytest.mark.parametrize("use_ref", [True, False])
def test_patch_discriminator(use_ref):
    """Forward and the gradient with respect to the crops, on crossed
    weights; the port's crops come from an explicit torch.Generator."""
    t = _rand(15, 2, 4, 16, 16, 3)
    r = _rand(16, 2, 2, 16, 16, 3) if use_ref else None
    jmod = JaxPatchD(crop_size=16, num_crops=4, use_reference=use_ref,
                     channel_max=64)
    args = [jnp.asarray(t)] + ([jnp.asarray(r)] if use_ref else [])
    variables = jax.jit(lambda *a: jmod.init(KEY, *a))(*args)
    pmod = PatchCoOccurrenceDiscriminator(crop_size=16, num_crops=4,
                                          use_reference=use_ref,
                                          channel_max=64)
    pmod.load_state_dict(jax_to_state_dict(variables), strict=True)
    inputs = [torch.from_numpy(a).requires_grad_(True)
              for a in [t] + ([r] if use_ref else [])]
    got = pmod(*inputs)
    cot = _rand(17, 2, 4)

    def forward_and_grads(*a):
        out, vjp = jax.vjp(lambda *x: jmod.apply(variables, *x), *a)
        return out, vjp(jnp.asarray(cot))

    ref, ref_grads = jax.jit(forward_and_grads)(*args)
    assert got.shape == (2, 4)
    _close(got, ref, 1e-4)
    got.backward(torch.from_numpy(cot))
    for g, rg in zip(inputs, ref_grads):
        # per crop: a leaky-ReLU input within rounding of 0 takes the other
        # slope in one package and moves that crop's whole gradient (seen
        # at 32 px crops, one input at 2e-7); every other crop within 1e-4
        # of the gradient's scale
        g, rg = g.grad.numpy(), np.asarray(rg)
        err = np.abs(g - rg).reshape(g.shape[0] * g.shape[1], -1).max(1)
        assert np.sum(err > 1e-4 * np.abs(rg).max()) <= 1, err
    images = torch.from_numpy(_rand(18, 2, 48, 48, 3))
    crops = pmod.crops(images, torch.Generator().manual_seed(3))
    again = pmod.crops(images, torch.Generator().manual_seed(3))
    assert crops.shape == (2, 4, 16, 16, 3) and torch.equal(crops, again)
    assert pmod(crops, crops[:, :2] if use_ref else None).shape == (2, 4)
