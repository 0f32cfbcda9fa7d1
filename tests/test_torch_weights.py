"""Weight carry-over from the JAX package into the port.

`jax_to_state_dict` must be the exact inverse of the JAX package's
`import_generator_state`: starting from a JAX-initialized variable tree,
the round trip reproduces every leaf bit for bit, and the port's
`load_state_dict(strict=True)` accepts the converter's output.
"""

import jax
import numpy as np
import pytest
import torch

from pasta_tpu.io.npz_ckpt import save_npz_variables
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch.io.from_jax import jax_to_state_dict, load_npz
from pasta_tpu_torch.models import Generator

CFG = dict(img_resolution=64, channel_base=2048, channel_max=128,
           conv_clamp=256)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_variables():
    n, res = 1, 64
    z = np.zeros((n, res, res, 1), np.float32)
    inputs = dict(
        z=np.zeros((n, 0), np.float32), c=np.zeros((n, 16, 16, 45), np.float32),
        retain=np.zeros((n, res, res, 6), np.float32),
        pose=np.zeros((n, res, res, 5), np.float32),
        denorm_upper_input=np.zeros((n, res, res, 3), np.float32),
        denorm_lower_input=np.zeros((n, res, res, 3), np.float32),
        denorm_upper_mask=z, denorm_lower_mask=z)
    model = JaxGenerator(**CFG)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        **inputs)
    return jax.tree_util.tree_map(np.asarray, variables)


def test_round_trip_is_exact(jax_variables):
    port = Generator(seed=1, **CFG)
    port.load_state_dict(jax_to_state_dict(jax_variables), strict=True)
    back = import_generator_state(state_dict_to_numpy(port))
    ref = dict(_flat(jax_variables))
    got = dict(_flat(back))
    assert sorted(got) == sorted(ref)
    for path, value in ref.items():
        assert got[path].shape == value.shape, path
        assert np.array_equal(got[path], value), path


def test_layouts(jax_variables):
    sd = jax_to_state_dict(jax_variables)
    w = jax_variables["params"]["synthesis"]["b8"]["conv1"]["weight"]
    assert np.array_equal(sd["synthesis.b8.conv1.weight"].numpy(),
                          w.transpose(3, 2, 0, 1))             # HWIO -> OIHW
    k = jax_variables["params"]["style_encoding"]["model.1"]["linear"]["kernel"]
    assert np.array_equal(sd["style_encoding.model.1.linear.weight"].numpy(),
                          k.T)                                 # Dense kernel
    assert np.array_equal(sd["mapping.w_avg"].numpy(),
                          jax_variables["buffers"]["mapping"]["w_avg"])


def test_load_npz(jax_variables, tmp_path):
    path = str(tmp_path / "g.npz")
    save_npz_variables(path, jax_variables)
    sd = load_npz(path)
    port = Generator(seed=1, **CFG)
    port.load_state_dict(sd, strict=True)
    for key, value in jax_to_state_dict(jax_variables).items():
        assert torch.equal(sd[key], value), key
