"""The port's `TryonPipeline(mesh=...)`, a batch split over devices, on the
CPU: against the JAX pipeline's split over a 2-device CPU mesh (the
conftest's virtual devices), and against the port's own pipeline without a
mesh on the tiled and the forced-full paths, under noise_mode "const" and
"random"; `run_stream` through a mesh against the mesh's `run_batch`; the
indivisible batch; the pool's threads ended by `close()`.

The mesh is ["cpu", "cpu"]: one device twice, which serves its two shards
in turn on the pipeline's one host thread for it. The generator is the
narrow 512px config of tests/test_torch_stream.py in fp32, its noise
strengths set to 0.05 (they are drawn as 0). Budgets: against JAX, the
serving budget of tests/test_torch_stream.py; mesh against one device,
the JAX package's budget for its own split (tests/test_serving.py,
`test_pipeline_mesh_matches_single`). A forward of this G costs about 4 s
an item on two CPU threads, so the split against one device runs at batch
2 (one row a shard) where batch 4 buys nothing more, and the batch of 4
that the JAX test and the stream share is run once.
"""

import re
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pasta_tpu.models as jmodels
from pasta_tpu import serving as jserving
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu_torch import models, serving
from pasta_tpu_torch.data.synthetic import write_tryon_root

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)
MESH = ["cpu", "cpu"]
BATCH = 4


def _serving_budget(got, ref, what):
    span = ref.max() - ref.min()
    diff = np.abs(got - ref)
    assert np.all(np.isfinite(got)), what
    assert np.mean(diff > 1e-2 * span) <= 2e-2, what
    assert diff.mean() <= 1e-3 * span, (what, diff.mean() / span)


def _split_budget(got, ref, what):
    """The JAX package's budget for its split (partitioning may change an
    accumulation order): distribution-level equality."""
    assert got.shape == ref.shape and np.all(np.isfinite(got)), what
    diff = np.abs(got - ref)
    span = ref.max() - ref.min()
    assert diff.mean() / span < 1e-4, (what, diff.mean(), span)
    assert np.mean(diff > 0.01 * span) < 1e-3, what


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    m = models.Generator(seed=0, **NARROW).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.05)
    return m


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meshroot") / "root")
    return path, write_tryon_root(path, 2 * BATCH, seed=90)


@pytest.fixture(scope="module")
def mesh_pipe(model):
    pipe = serving.TryonPipeline(model, mode="upper", mesh=MESH)
    yield pipe
    pipe.close()


@pytest.fixture(scope="module")
def items(mesh_pipe, root):
    """The first BATCH pairs of the root, prepared; they take the tiled
    path."""
    path, pairs = root
    its = [mesh_pipe.prepare_pair(path, p) for p in pairs[:BATCH]]
    assert all(bool(it["tiles_fit"]) for it in its)
    return its


@pytest.fixture(scope="module")
def mesh_out(mesh_pipe, items):
    """The mesh's output on `items`, "const" noise."""
    out = mesh_pipe.run_batch(items)
    assert mesh_pipe.last_tiled
    return out.numpy()


def test_mesh_matches_jax_mesh(model, items, mesh_out):
    """Batch 4 over ["cpu", "cpu"] against the JAX pipeline over a mesh of
    two CPU devices, cond="device" on both sides, tiled path."""
    variables = import_generator_state(state_dict_to_numpy(model))
    jpipe = jserving.TryonPipeline(
        variables, mode="upper", model=jmodels.Generator(**NARROW),
        cond="device", mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
    ref = np.asarray(jpipe.run_batch(items))
    assert mesh_out.shape == ref.shape == (BATCH, 512, 512, 3)
    _serving_budget(mesh_out, ref, "mesh vs JAX mesh")


def test_mesh_matches_single_tiled(model, items, mesh_out):
    single = serving.TryonPipeline(model, mode="upper")
    _split_budget(mesh_out, single.run_batch(items).numpy(), "tiled")


def test_mesh_matches_single_full(model, items):
    """The forced-full paste and cut path, decided over the whole batch
    (one item that does not fit sends every shard down it)."""
    forced = [dict(it) for it in items[:2]]
    forced[1]["tiles_fit"] = np.asarray(False)
    single = serving.TryonPipeline(model, mode="upper")
    with serving.TryonPipeline(model, mode="upper", mesh=MESH) as mesh:
        got = mesh.run_batch(forced).numpy()
        assert not mesh.last_tiled
    ref = single.run_batch(forced).numpy()
    assert not single.last_tiled
    _split_budget(got, ref, "full")


def test_mesh_random_noise_matches_single(model, items, mesh_out):
    """noise_mode="random", one seed: each shard draws the whole batch's
    noise from its own generator in the batch's state and keeps its rows,
    so that the split gets the single pipeline's noise."""
    single = serving.TryonPipeline(model, mode="upper", noise_mode="random",
                                   seed=5)
    with serving.TryonPipeline(model, mode="upper", noise_mode="random",
                               seed=5, mesh=MESH) as mesh:
        got = mesh.run_batch(items[:2]).numpy()
    ref = single.run_batch(items[:2]).numpy()
    _split_budget(got, ref, "random")
    const = mesh_out[:2]
    assert np.abs(got - const).mean() > 1e-3 * (const.max() - const.min())


def test_run_stream_through_mesh(mesh_pipe, root, mesh_out):
    """8 pairs at batch 4: two batches in order, each equal bit for bit to
    the mesh's run_batch on the same items."""
    path, pairs = root
    streamed = list(mesh_pipe.run_stream(path, pairs, batch_size=BATCH,
                                         num_workers=2, prefetch=1))
    assert [c for c, _ in streamed] == [pairs[:BATCH], pairs[BATCH:]]
    first, second = streamed[0][1], streamed[1][1]
    assert first.dtype == np.float32 and first.shape == mesh_out.shape
    assert np.array_equal(first, mesh_out)
    rest = [mesh_pipe.prepare_pair(path, p) for p in pairs[BATCH:]]
    assert np.array_equal(second, mesh_pipe.run_batch(rest).numpy())


def test_indivisible_batch_and_close(model, items):
    """A batch the mesh's size does not divide fails with the JAX text;
    close() ends the pipeline's host threads, after which it takes no
    batch."""
    with serving.TryonPipeline(model, mode="upper", mesh=MESH) as pipe:
        with pytest.raises(AssertionError, match=re.escape(
                "batch 3 not divisible by mesh size 2")):
            pipe.run_batch(items[:3])
        pool = pipe._pools[torch.device("cpu")]
        pool.submit(int).result()              # its thread starts
        prefix = f"TryonPipeline-{id(pipe)}-"
        threads = [t for t in threading.enumerate()
                   if t.name.startswith(prefix)]
        assert len(threads) == 1
    assert not any(t.is_alive() for t in threads)
    with pytest.raises(RuntimeError):
        pipe.run_batch(items[:2])
