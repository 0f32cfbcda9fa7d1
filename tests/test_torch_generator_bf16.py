"""The port's Generator in bf16 against pasta_tpu's in bf16, on the CPU.

Small config of tests/test_models.py (img_resolution=64, channel_base=2048,
channel_max=128), `num_bf16_res` 1, 2 and 3 (the top resolutions and the
conditioning encoders in bf16), noise_mode="const", seeded inputs as
tests/test_models.py::_gen_inputs makes them, and one set of weights: made on
the port's side from a seed (numpy noise on the zero-initialized biases and
noise strengths, so every term is live), crossed into JAX with
`io/from_jax.py::state_dict_to_jax` and back with `jax_to_state_dict`.

The JAX G is jitted with XLA's `xla_allow_excess_precision` off: every op
rounds to bf16, as the port's eager ops do (op-by-op JAX gives the same
gaps). With it on, XLA's default, fused elementwise chains stay in fp32
between roundings, and the port's gap to that output is 0.73-1.18 of the
JAX package's own bf16-vs-fp32 gap: a different rounding model, not a
misplaced cast.

Budgets are set from the JAX package's own bf16-vs-fp32 gap on the same
inputs (mean absolute difference), since two frameworks that round at the
same places still part where their fp32 sums differ in the last bit before
a bf16 rounding, and bf16 layers amplify that:
- coarse image and parsing logits: the port's gap to the JAX bf16 output is
  at most half the JAX gap (measured 0.04-0.36 of it);
- the finetune image, routed by the given gt_parsing: at most 0.75 of the
  JAX gap (measured 0.48-0.61: the SPADE instance norms amplify the
  encoders' last-bit differences);
- the parsing argmax: the generator tests' flip budget, 0.5% of pixels.
bias_act, where the port once multiplied bf16 activations by unrounded
constants, is held bit for bit against the JAX op.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu.ops.bias_act import bias_act as jax_bias_act
from pasta_tpu_torch.io.from_jax import jax_to_state_dict, state_dict_to_jax
from pasta_tpu_torch.models import Generator
from pasta_tpu_torch.ops.bias_act import bias_act

CFG = dict(img_resolution=64, channel_base=2048, channel_max=128,
           conv_clamp=256)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gen_inputs(rng, n, res):
    """tests/test_models.py::_gen_inputs, as numpy arrays."""
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


def _run_jax(variables, inputs, num_bf16_res):
    """The JAX G, jitted with XLA's excess precision off, so that every op
    rounds to its dtype as the port's eager ops do (with it on, XLA keeps
    fused elementwise chains in fp32 and the two part by as much as bf16
    and fp32 do)."""
    model = JaxGenerator(**CFG, num_bf16_res=num_bf16_res)
    args = (variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    out = jax.jit(lambda v, x: model.apply(
        v, z=jnp.zeros((2, 0)), noise_mode="const", **x)).lower(
            *args).compile(compiler_options={
                "xla_allow_excess_precision": False})(*args)
    return [np.asarray(o, np.float32) for o in out]


@pytest.fixture(scope="module")
def setup():
    port = Generator(seed=0, **CFG)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("bias", "m_bias1", "noise_strength")):
                p.copy_(torch.from_numpy(
                    np.asarray(rng.randn(*p.shape) * 0.2, np.float32)))
    variables = state_dict_to_jax(port.state_dict())
    inputs = _gen_inputs(np.random.RandomState(0), 2, 64)
    inputs["gt_parsing"] = np.random.RandomState(3).randint(
        0, 7, (2, 64, 64, 1)).astype(np.float32)
    return variables, inputs, _run_jax(variables, inputs, 0)


@pytest.mark.parametrize("num_bf16_res", [1, 2, 3])
def test_bf16_generator_matches_jax_bf16(setup, num_bf16_res):
    variables, inputs, ref32 = setup
    ref16 = _run_jax(variables, inputs, num_bf16_res)
    port = Generator(seed=5, num_bf16_res=num_bf16_res, **CFG).eval()
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.zeros(2, 0), noise_mode="const",
                   **{k: torch.from_numpy(v) for k, v in inputs.items()})
    got = [t.float().numpy() for t in got]
    for name, share, a, b, c in zip(("img", "finetune", "parsing"),
                                    (0.5, 0.75, 0.5), got, ref16, ref32):
        assert np.all(np.isfinite(a)), name
        port_gap = np.abs(a - b).mean()
        jax_gap = np.abs(b - c).mean()
        assert jax_gap > 1e-3, (name, jax_gap)     # bf16 did run
        assert port_gap <= share * jax_gap, (name, port_gap, jax_gap)
    flips = np.mean(got[2].argmax(-1) != ref16[2].argmax(-1))
    assert flips <= 5e-3, flips


@pytest.mark.parametrize("act,gain,clamp", [("lrelu", None, 256.0),
                                            ("lrelu", 1.0, None),
                                            ("relu", 0.5 ** 0.5, 181.0)])
def test_bias_act_bf16_bit_equal_to_jax(act, gain, clamp):
    """The activation's slope and the gain round to bf16 before the
    product, as in the JAX op: equal bit for bit on bf16 inputs."""
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 9, 9, 64) * 40).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    got = bias_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(b),
                   act=act, gain=gain, clamp=clamp)
    ref = jax_bias_act(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(b),
                       act=act, gain=gain, clamp=clamp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
