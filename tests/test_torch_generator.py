"""The port's Generator vs pasta_tpu's on the CPU, fp32, noise_mode="const".

Small config of tests/test_models.py (img_resolution=64, channel_base=2048,
channel_max=128). The weights are made on the port side from a seed (with
numpy noise on the zero-initialized biases and noise strengths so every
term is live) and carried into JAX with `import_generator_state`; the
inputs are numpy arrays from a seed.

Tolerances (fp32, sums in different orders through ~20 stacked convs):
coarse image and parsing logits atol 1e-3 on outputs of magnitude ~10;
the finetune image with gt_parsing supplied, rtol/atol 1e-3. Without
gt_parsing the SPADE branch routes on the argmax of the parsing logits,
which may flip where two logits tie to within the conv noise: the budget
is 0.5% of pixels flipped, and 2% of finetune values off by more than
1e-2 of the image's range.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch.models import Generator

CFG = dict(img_resolution=64, channel_base=2048, channel_max=128,
           conv_clamp=256)


def _inputs(seed, n, res):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        c=rng.randn(n, res // 4, res // 4, 45).astype(f),
        retain=rng.randn(n, res, res, 6).astype(f),
        pose=rng.randn(n, res, res, 5).astype(f),
        denorm_upper_input=rng.randn(n, res, res, 3).astype(f),
        denorm_lower_input=rng.randn(n, res, res, 3).astype(f),
        denorm_upper_mask=(rng.rand(n, res, res, 1) > 0.5).astype(f),
        denorm_lower_mask=(rng.rand(n, res, res, 1) > 0.5).astype(f),
    )


@pytest.fixture(scope="module")
def pair():
    port = Generator(seed=0, **CFG).eval()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("bias", "m_bias1", "noise_strength")):
                p.copy_(torch.from_numpy(
                    np.asarray(rng.randn(*p.shape) * 0.2, np.float32)))
    variables = import_generator_state(state_dict_to_numpy(port))
    return port, JaxGenerator(**CFG), variables, _inputs(2, 2, 64)


def _both(pair, **extra):
    port, jax_model, variables, inputs = pair
    with torch.no_grad():
        got = port(torch.zeros(2, 0), noise_mode="const",
                   **{k: torch.from_numpy(v) for k, v in {**inputs,
                                                          **extra}.items()})
    ref = jax_model.apply(variables, z=jnp.zeros((2, 0)), noise_mode="const",
                          **{k: jnp.asarray(v) for k, v in {**inputs,
                                                            **extra}.items()})
    return [t.numpy() for t in got], [np.asarray(t) for t in ref]


def test_coarse_parsing_and_flip_budget(pair):
    (img, fin, pp), (jimg, jfin, jpp) = _both(pair)
    assert img.shape == (2, 64, 64, 3) and pp.shape == (2, 64, 64, 7)
    np.testing.assert_allclose(img, jimg, atol=1e-3)
    np.testing.assert_allclose(pp, jpp, atol=1e-3)
    flips = np.mean(pp.argmax(-1) != jpp.argmax(-1))
    assert flips <= 5e-3, flips
    span = jfin.max() - jfin.min()
    off = np.mean(np.abs(fin - jfin) > 1e-2 * span)
    assert off <= 2e-2, off


def test_finetune_with_gt_parsing(pair):
    gt = np.random.RandomState(3).randint(0, 7, (2, 64, 64, 1)).astype(
        np.float32)
    (img, fin, _), (jimg, jfin, _) = _both(pair, gt_parsing=gt)
    assert np.all(np.isfinite(fin))
    np.testing.assert_allclose(fin, jfin, rtol=1e-3, atol=1e-3)


def test_state_dict_names_and_shapes():
    port = Generator(seed=0, **CFG)
    sd = port.state_dict()
    assert "synthesis.b64.torgb.m_weight1" in sd          # parsing head
    assert "synthesis.texture_b512.torgb.m_weight1" not in sd
    assert "style_encoding.model.12.weight" in sd
    assert "mapping.w_avg" in sd
    assert tuple(sd["synthesis.b8.conv1.noise_const"].shape) == (8, 8)
    assert not any(k.endswith("resample_filter") for k in sd)
    assert port.num_ws == 8
