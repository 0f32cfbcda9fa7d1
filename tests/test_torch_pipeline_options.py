"""The port's `TryonPipeline` options against the JAX package's, on the
CPU: `cond="host"` (host_prepare rasters the person conditioning) and
`noise_mode="none"` against the JAX pipeline, `noise_mode="random"` seeded
(the same seed bit-equal, another seed other outputs, "const" unchanged).

The generator is the narrow 512px config (channel_base=2048,
channel_max=128) in fp32, its noise strengths set to 0.05 (they are drawn
as 0, so that the noise modes would not differ); its weights are drawn by
the port from a seed and carried into JAX with `import_generator_state`.
Budget of tests/test_torch_serving.py: the assembled inputs to 1e-4; the
finetune image 2% of values off by more than 1e-2 of its range and a mean
absolute difference under 1e-3 of the range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasta_tpu.models as jmodels
from pasta_tpu import serving as jserving
from pasta_tpu.data import preprocess as jpp
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu_torch import models, serving
from pasta_tpu_torch.data.synthetic import write_tryon_root
from pasta_tpu_torch.data import preprocess as pp

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)
N_PERSONS = 5


def _budget(got, ref, what):
    span = ref.max() - ref.min()
    diff = np.abs(got - ref)
    assert np.all(np.isfinite(got)), what
    assert np.mean(diff > 1e-2 * span) <= 2e-2, what
    assert diff.mean() <= 1e-3 * span, (what, diff.mean() / span)


def with_noise(model, strength=0.05):
    """The model with every synthesis layer's noise strength set to
    `strength` (drawn as 0, so that noise_mode would change nothing)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(strength)
    return model


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs these files beside others on every core: two
    intra-op threads a worker keep the 512px forwards from thrashing."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    model = with_noise(models.Generator(seed=0, **NARROW).eval())
    return model, import_generator_state(state_dict_to_numpy(model))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("optsroot") / "root")
    return path, write_tryon_root(path, N_PERSONS, seed=90)


def _jax_pipe(variables, **kw):
    return jserving.TryonPipeline(variables, model=jmodels.Generator(**NARROW),
                                  **kw)


def _records(path, pairs, pose_raster, lib):
    load = pp.load_person if lib == "port" else jpp.load_person
    return [(load(path, p, pose_raster=pose_raster),
             load(path, c, pose_raster="device", with_garment_parsing=True))
            for p, c in pairs]


def test_cond_host_matches_jax(weights, root):
    """cond="host": host_prepare rasters the conditioning; the assembled
    inputs and the pipeline's output against the JAX pipeline's."""
    model, variables = weights
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper", cond="host")
    items = [pipe.prepare(p, c) for p, c in
             _records(path, pairs[:1], "host", "port")]
    assert "pose" in items[0] and "parsing" not in items[0]
    jpipe = _jax_pipe(variables, mode="upper", cond="host")
    jitems = [jpipe.prepare(p, c) for p, c in
              _records(path, pairs[:1], "host", "jax")]
    tiled = all(bool(it["tiles_fit"]) for it in items)
    got = serving.assemble_inputs_device(serving.ingest_device(
        pipe._upload(items)), "upper", tiled=tiled)
    ref = jax.jit(lambda b: jserving.assemble_inputs_device(
        jserving.ingest_device(b), "upper", tiled=tiled))(
        {k: jnp.asarray(np.stack([it[k] for it in jitems]))
         for k in items[0] if k != "tiles_fit"})
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    _budget(pipe.run_batch(items).numpy(),
            np.asarray(jpipe.run_batch(jitems)), "cond host")


def test_noise_none_matches_jax(weights, root):
    model, variables = weights
    path, pairs = root
    pipe = serving.TryonPipeline(model, mode="upper", noise_mode="none")
    items = [pipe.prepare(p, c) for p, c in
             _records(path, pairs[:1], "device", "port")]
    jpipe = _jax_pipe(variables, mode="upper", noise_mode="none",
                      cond="device")
    got = pipe.run_batch(items).numpy()
    _budget(got, np.asarray(jpipe.run_batch(items)), "noise none")
    const = serving.TryonPipeline(model, mode="upper").run_batch(items)
    assert not np.array_equal(got, const.numpy())


def test_noise_random_is_seeded(weights, root):
    """The same seed gives the same outputs bit for bit, batch after batch;
    another seed other outputs; "const" ignores the seed."""
    model, _ = weights
    path, pairs = root
    items = [serving.host_prepare(p, c, "upper", cond="device") for p, c in
             _records(path, pairs[:1], "device", "port")]

    def outputs(noise_mode, seed, n=2):
        pipe = serving.TryonPipeline(model, mode="upper",
                                     noise_mode=noise_mode, seed=seed)
        return [pipe.run_batch(items).numpy() for _ in range(n)]

    a, b = outputs("random", 7), outputs("random", 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])          # advanced once a batch
    assert not np.array_equal(a[0], outputs("random", 8, n=1)[0])
    const = outputs("const", 7, n=1) + outputs("const", 8, n=1)
    assert np.array_equal(*const)
    assert not np.array_equal(a[0], const[0])
