"""The port's `TryonPipeline.run_stream` and `cli.test --pipeline serving`
against the JAX package's, on the CPU: `run_stream` against the port's
`run_batch` (bit for bit) and against the JAX `run_stream` on the same
root, tail padding included; the serving CLI against the JAX CLI on the
same `.npz`; the pipeline options that are not valid raising by name.
tests/test_torch_pipeline_options.py holds `cond` and `noise_mode`.

The generator is the narrow 512px config (channel_base=2048,
channel_max=128) in fp32, its noise strengths set to 0.05 (they are drawn
as 0); its weights are drawn by the port from a seed and carried into JAX
with `import_generator_state`. Budget of tests/test_torch_serving.py: the
finetune image 2% of values off by more than 1e-2 of its range and a mean
absolute difference under 1e-3 of the range (the SPADE routing's argmax
may flip where two parsing logits tie within fp32 conv noise); on a
composite's 0..255 generated column the same fractions of 255.
"""

import functools
import os

import cv2
import numpy as np
import pytest
import torch

import pasta_tpu.models as jmodels
from pasta_tpu import serving as jserving
from pasta_tpu.cli import test as jcli_test
from pasta_tpu.io.npz_ckpt import save_npz_variables
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu_torch import models, serving
from pasta_tpu_torch.data.synthetic import write_tryon_root
from pasta_tpu_torch.cli import test as cli_test

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
    path = str(tmp_path_factory.mktemp("streamroot") / "root")
    return path, write_tryon_root(path, N_PERSONS, seed=90)


def _jax_pipe(variables, **kw):
    return jserving.TryonPipeline(variables, model=jmodels.Generator(**NARROW),
                                  **kw)


def test_run_stream_matches_run_batch_and_jax(weights, root):
    """3 pairs at batch 2: two batches in order, the last padded; each
    equal to run_batch on the same items and to the JAX run_stream."""
    model, variables = weights
    path, pairs = root
    pairs = pairs[:3]
    pipe = serving.TryonPipeline(model, mode="upper")
    streamed = list(pipe.run_stream(path, pairs, batch_size=2,
                                    num_workers=3, prefetch=1))
    assert [c for c, _ in streamed] == [pairs[0:2], pairs[2:]]
    for chunk, out in streamed:
        items = [pipe.prepare_pair(path, p) for p in chunk]
        items += [items[-1]] * (2 - len(items))
        assert out.dtype == np.float32 and out.shape == (len(chunk), 512,
                                                         512, 3)
        assert np.array_equal(out, pipe.run_batch(items).numpy()[:len(chunk)])
    jstreamed = list(_jax_pipe(variables, mode="upper", cond="device")
                     .run_stream(path, pairs, batch_size=2, num_workers=3))
    assert [c for c, _ in jstreamed] == [c for c, _ in streamed]
    for (_, out), (_, ref) in zip(streamed, jstreamed):
        _budget(out, np.asarray(ref), "run_stream")


def test_cli_serving_matches_jax(weights, root, tmp_path):
    """cli.test --pipeline serving (run_stream) and the JAX CLI's serving
    pipeline on one .npz: one composite per pair, the clothes and person
    columns equal, the generated column within the budget."""
    _, variables = weights
    path, pairs = root
    npz = str(tmp_path / "g.npz")
    save_npz_variables(npz, variables)
    (tmp_path / "three.txt").write_text(
        "".join(f"{c} {p}\n" for p, c in pairs[:3]))
    port_g = models.Generator

    class Narrow(port_g):
        def __init__(self, **kw):
            super().__init__(**{**kw, **NARROW, "seed": 1})

    argv = ["--network", npz, "--dataroot", path, "--testtxt",
            str(tmp_path / "three.txt"), "--batchsize", "2", "--pipeline",
            "serving"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, "Generator", Narrow)
        mp.setattr(jmodels, "Generator",
                   functools.partial(jmodels.Generator, **NARROW))
        assert cli_test.main(argv + ["--outdir", str(tmp_path / "port"),
                                     "--device", "cpu"]) == 3
        jcli_test.main(argv + ["--outdir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"{p[:-4]}___{c[:-4]}.png" for p, c in pairs[:3])
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / name)).astype(np.float64)
        ref = cv2.imread(str(tmp_path / "jax" / name)).astype(np.float64)
        assert got.shape == ref.shape == (512, 960, 3)
        assert np.array_equal(got[:, :640], ref[:, :640]), name
        diff = np.abs(got[:, 640:] - ref[:, 640:])
        assert np.mean(diff > 2.55) <= 2e-2, name
        assert diff.mean() <= 1e-3 * 255, (name, diff.mean())


def _stub_pipe(monkeypatch, calls):
    """A pipeline whose run_batch returns each item's person image as
    fp32 (no generator forward) and records the batch sizes it got."""
    model = models.Generator(seed=0, img_resolution=64, channel_base=256,
                             channel_max=16)
    pipe = serving.TryonPipeline(model, mode="upper")

    def run_batch(items):
        calls.append(len(items))
        return torch.stack([torch.from_numpy(it["image"].astype(np.float32))
                            for it in items])

    monkeypatch.setattr(pipe, "run_batch", run_batch)
    return pipe


def test_run_stream_with_images(root, monkeypatch):
    """with_images: each yield also carries the chunk's padded person and
    clothes images as load_person decodes them; the chunks and outputs
    are those of the plain run_stream."""
    from pasta_tpu_torch.data import preprocess as pp
    from pasta_tpu_torch.data.roots import as_root

    path, pairs = root
    pipe = _stub_pipe(monkeypatch, [])
    plain = list(pipe.run_stream(path, pairs[:3], batch_size=2))
    got = list(pipe.run_stream(path, pairs[:3], batch_size=2,
                               with_images=True))
    assert [c for c, _, _ in got] == [c for c, _ in plain]
    data = as_root(path)
    for (chunk, out, images), (_, ref) in zip(got, plain):
        assert np.array_equal(out, ref)
        assert len(images) == len(chunk)
        for (pn, cn), (person, clothes) in zip(chunk, images):
            assert np.array_equal(person, pp.load_person(data, pn).image)
            assert np.array_equal(clothes, pp.load_person(data, cn).image)
            assert person.shape == clothes.shape == (512, 512, 3)


def test_bench_stream_throughput_cycles_the_pairs(root, monkeypatch):
    """cli.bench's one run_stream measurement: a warm-up batch, then one
    timed pass over n_pairs pairs (the pairs cycled, the tail padded),
    inside the context it is given."""
    from pasta_tpu_torch.cli import bench

    path, pairs = root
    calls, entered = [], []

    class Context:
        def __enter__(self):
            entered.append(len(calls))

        def __exit__(self, *exc):
            entered.append(len(calls))

    pipe = _stub_pipe(monkeypatch, calls)
    rate = bench.stream_throughput(pipe, path, pairs[:3], 2, num_workers=2,
                                   n_pairs=5, context=Context())
    assert rate > 0 and np.isfinite(rate)
    assert calls == [2, 2, 2, 2] and entered == [1, 4]


def test_options_not_ported_raise(weights):
    model, _ = weights
    with pytest.raises(ValueError):
        serving.TryonPipeline(model, noise_mode="sometimes")
    with pytest.raises(ValueError):
        serving.TryonPipeline(model, cond="cloud")


@pytest.mark.parametrize("impl", ["auto", "gather", "matmul", "matmul_bf16",
                                  "nearest"])
def test_warp_impl_is_the_gather(weights, impl):
    """The gather is the port's one warp: "auto" and "gather" name it, and
    every other name (the JAX package's matmul warps included) raises."""
    model, _ = weights
    if impl in ("auto", "gather"):
        pipe = serving.TryonPipeline(model, warp_impl=impl)
        assert pipe.warp_impl == "gather" and pipe.cond == "device"
    else:
        with pytest.raises(ValueError, match="warp_impl"):
            serving.TryonPipeline(model, warp_impl=impl)
