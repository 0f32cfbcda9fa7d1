"""Port nn modules vs pasta_tpu.nn (flax) on the CPU, fp32.

Each test builds the port module (seeded init), fills its biases, noise
strengths and buffers with numpy noise from a seed so every term is live,
carries the weights into flax with the JAX package's own importer
(`import_generator_state(state_dict_to_numpy(module))`), and feeds the same
numpy inputs to both.

Tolerance: rtol 1e-4 / atol 1e-4 -- fp32 sums in different orders through
at most a few stacked convs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu.nn import encoders as jenc
from pasta_tpu.nn import layers as jl
from pasta_tpu.nn import mapping as jmap
from pasta_tpu.nn import synthesis as jsyn
from pasta_tpu_torch.nn import encoders as tenc
from pasta_tpu_torch.nn import layers as tl
from pasta_tpu_torch.nn import mapping as tmap
from pasta_tpu_torch.nn import synthesis as tsyn

TOL = dict(rtol=1e-4, atol=1e-4)


def _port(module, seed=0):
    """Seeded init, then numpy noise on every zero-initialized leaf."""
    tl.init_weights(module, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "m_bias1", "noise_strength", "w_avg"):
                t.copy_(torch.from_numpy(
                    np.asarray(rng.randn(*t.shape) * 0.3, np.float32)))
    return module.eval()


def _flax_vars(module):
    return import_generator_state(state_dict_to_numpy(module))


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _run(port, flax_mod, arrays, t_kw=None):
    """(port output, flax output) on the same arrays and keywords."""
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in arrays], **(t_kw or {}))
    ref = flax_mod.apply(_flax_vars(port), *[jnp.asarray(a) for a in arrays],
                         **(t_kw or {}))
    return got, ref


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def test_normalize_2nd_moment_and_instance_norm():
    (x,) = _arrays(0, (2, 6, 5, 8))
    _close(tl.normalize_2nd_moment(torch.from_numpy(x)),
           jl.normalize_2nd_moment(jnp.asarray(x)))
    _close(tl.instance_norm_2d(torch.from_numpy(x)),
           jl.instance_norm_2d(jnp.asarray(x)))


@pytest.mark.parametrize("act,lr", [("linear", 1.0), ("lrelu", 0.01)])
def test_fully_connected(act, lr):
    port = _port(tl.FullyConnectedLayer(12, 10, activation=act,
                                        lr_multiplier=lr, bias_init=1.0))
    flax = jl.FullyConnectedLayer(12, 10, activation=act, lr_multiplier=lr,
                                  bias_init=1.0)
    _close(*_run(port, flax, _arrays(1, (3, 12))))


@pytest.mark.parametrize("k,up,down,act", [
    (3, 1, 1, "lrelu"), (3, 1, 2, "linear"), (1, 2, 1, "relu"),
    (3, 2, 1, "lrelu"), (7, 1, 1, "relu"),
])
def test_conv2d_layer(k, up, down, act):
    kw = dict(kernel_size=k, activation=act, up=up, down=down, conv_clamp=2.0)
    port = _port(tl.Conv2dLayer(6, 8, **kw))
    flax = jl.Conv2dLayer(6, 8, **kw)
    _close(*_run(port, flax, _arrays(2, (2, 12, 12, 6)), t_kw={"gain": 0.7}))


def test_dense():
    port = _port(tl.Dense(8, 12))
    flax = jl.Dense(8, 12)
    _close(*_run(port, flax, _arrays(3, (2, 6, 6, 8))))


def test_resblock_ignores_kernel_size():
    port = _port(tl.ResBlock(6, 8, kernel_size=4, activation="relu", down=2))
    assert tuple(port.conv0.weight.shape[2:]) == (3, 3)
    flax = jl.ResBlock(6, 8, kernel_size=4, activation="relu", down=2)
    _close(*_run(port, flax, _arrays(4, (2, 12, 12, 6))))


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.5, None), (0.7, 2)])
def test_mapping(psi, cutoff):
    port = _port(tmap.MappingNetwork(z_dim=4, c_dim=16, w_dim=16, num_ws=5,
                                     num_layers=2))
    flax = jmap.MappingNetwork(z_dim=4, c_dim=16, w_dim=16, num_ws=5,
                               num_layers=2)
    kw = dict(truncation_psi=psi, truncation_cutoff=cutoff)
    _close(*_run(port, flax, _arrays(5, (3, 4), (3, 16)), t_kw=kw))


def test_const_encoder():
    port = _port(tenc.ConstEncoderNetwork(input_nc=5, output_nc=32, ngf=4,
                                          n_downsampling=3))
    flax = jenc.ConstEncoderNetwork(input_nc=5, output_nc=32, ngf=4,
                                    n_downsampling=3)
    _close(*_run(port, flax, _arrays(6, (2, 32, 32, 5))))


def test_style_encoder():
    port = _port(tenc.StyleEncoderNetwork(input_nc=45, output_nc=64, ngf=8))
    flax = jenc.StyleEncoderNetwork(input_nc=45, output_nc=64, ngf=8)
    (code, feats), (jcode, jfeats) = _run(
        port, flax, _arrays(7, (2, 32, 32, 45), (2, 32, 32, 6)))
    _close(code, jcode)
    assert len(feats) == len(jfeats) == 4
    for a, b in zip(feats, jfeats):
        _close(a, b)


@pytest.mark.parametrize("up,noise_mode", [(1, "const"), (2, "const"),
                                           (1, "none")])
def test_synthesis_layer(up, noise_mode):
    kw = dict(w_dim=16, resolution=16, up=up, conv_clamp=2.0)
    port = _port(tsyn.SynthesisLayer(8, 12, **kw))
    flax = jsyn.SynthesisLayer(8, 12, **kw)
    _close(*_run(port, flax, _arrays(8, (2, 16 // up, 16 // up, 8), (2, 16)),
                 t_kw={"noise_mode": noise_mode, "gain": 0.5}))


@pytest.mark.parametrize("parsing", [None, 7])
def test_torgb(parsing):
    port = _port(tsyn.ToRGBLayer(8, 3, w_dim=16, conv_clamp=2.0,
                                 parsing_channels=parsing))
    flax = jsyn.ToRGBLayer(8, 3, w_dim=16, conv_clamp=2.0,
                           parsing_channels=parsing)
    (img, pp), (jimg, jpp) = _run(port, flax,
                                  _arrays(9, (2, 8, 8, 8), (2, 16)))
    _close(img, jimg)
    if parsing is None:
        assert pp is None and jpp is None
    else:
        _close(pp, jpp)


def test_spade_conv_and_norm():
    # pre-activation bias: in == out channels, as wherever a bias is used
    port = _port(tsyn.SpadeConv2dLayer(8, 8, 3, conv_clamp=2.0))
    flax = jsyn.SpadeConv2dLayer(8, 8, 3, conv_clamp=2.0)
    x = _arrays(10, (2, 8, 8, 8))
    for no_act in (False, True):
        _close(*_run(port, flax, x, t_kw={"no_act": no_act, "gain": 0.5}))
    port = _port(tsyn.SpadeNormBlock(3, 8))
    flax = jsyn.SpadeNormBlock(3, 8)
    _close(*_run(port, flax, _arrays(11, (2, 8, 8, 8), (2, 8, 8, 3))))


def test_spade_resblock():
    port = _port(tsyn.SpadeResBlock(8, 8, spade_channels=3, conv_clamp=2.0))
    flax = jsyn.SpadeResBlock(8, 8, spade_channels=3, conv_clamp=2.0)
    _close(*_run(port, flax, _arrays(12, (2, 8, 8, 8), (2, 8, 8, 3))))
