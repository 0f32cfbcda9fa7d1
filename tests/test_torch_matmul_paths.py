"""The two 512 px paths with the matmul warps, the port against the JAX
package on the CPU, both on the tiled path with the cut windows
(`cut_windowed`):

* `TryonPipeline.run_batch(warp_impl="matmul")` at the narrow 512 px
  generator (fp32, noise_mode="const", weights made on the port side from
  a seed and carried into JAX with `import_generator_state`), a synthetic
  person whose quads fit the paste tiles and the cut windows.
  Tolerance: the serving budget of tests/test_torch_serving.py -- 2% of
  values beyond 1e-2 of the image's range and a mean difference under
  1e-3 of it (the SPADE routing argmax may flip on near-ties).
* `assemble_train_batch_lean(warp_impl="matmul")` on one person of a
  synthetic root (both packages' native decoders off, as in
  tests/test_torch_trainsets.py), against the jitted JAX assembler: every
  plane within 1e-3 of its range (2 / 127.5 * 0.255 after the scaling to
  [-1, 1]) on all but 0.1% of the pixels (an eroded warped mask's edge
  pixel can land on either side of its threshold).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pasta_tpu.native as jnative
import pasta_tpu_torch.native as pnative
from pasta_tpu import serving as jserving
from pasta_tpu.data import trainsets as jts
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch import serving
from pasta_tpu_torch.data import preprocess as pp
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import (make_garment, make_person,
                                            write_dataset_root)
from pasta_tpu_torch.models import Generator

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)
IMG_TOL = 1e-3 * 255.0
MASK_BUDGET = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_batch_matmul_matches_jax():
    model = Generator(seed=0, **NARROW).eval()
    variables = import_generator_state(state_dict_to_numpy(model))
    items = [serving.host_prepare(make_person(1, jitter=10.0),
                                  make_garment(101), "upper", cond="device")]
    pipe = serving.TryonPipeline(model, mode="upper", warp_impl="matmul")
    got = pipe.run_batch(items).numpy()
    assert pipe.warp_impl == "matmul"
    assert pipe.last_tiled and pipe.last_cut_windowed
    ref = np.asarray(jserving.TryonPipeline(
        variables, mode="upper", model=JaxGenerator(**NARROW),
        noise_mode="const", warp_impl="matmul", cond="device"
    ).run_batch(items))
    assert got.shape == ref.shape == (1, 512, 512, 3)
    assert np.all(np.isfinite(got))
    span = ref.max() - ref.min()
    diff = np.abs(got - ref)
    assert np.mean(diff > 1e-2 * span) <= 2e-2
    assert diff.mean() <= 1e-3 * span, diff.mean()


def test_lean_assembler_matmul(tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)
    root = str(tmp_path / "root")
    names = write_dataset_root(root, 1, 60)
    rng = np.random.RandomState(4)
    items = [ts.preprocess_person_train_lean(pp.load_person(
        root, name, with_garment_parsing=True, pose_raster="device"), rng)
        for name in names]
    batch, tiled, windowed = ts.batch_to_lean_inputs(items)
    assert tiled and windowed
    got = ts.assemble_train_batch_lean(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tiled=True,
        cut_windowed=True, warp_impl="matmul")
    ref = jax.jit(jts.assemble_train_batch_lean, static_argnames=(
        "tiled", "cut_windowed", "warp_impl"))(
        {k: jnp.asarray(v) for k, v in batch.items()}, tiled=True,
        cut_windowed=True, warp_impl="matmul")
    assert sorted(got) == sorted(ref)
    tol = 2 / 127.5 * IMG_TOL
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        bad = np.mean(np.any(np.abs(g - r) > tol, axis=-1))
        assert bad <= MASK_BUDGET, (k, bad)
