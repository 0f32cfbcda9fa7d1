"""The training run's cross-pair try-on grid and its trace, on the CPU:

* `train/loop.py::save_cross_pair_grid` of both packages on one synthetic
  root (3 persons, mode="thirds": a lower, a full and an upper row, items
  resized from 512 to 64 px) and one G-EMA at 64 px (the port's weights
  carried into JAX with `state_dict_to_jax`). Both grids' images are taken
  where each package hands them to its `save_image_grid`. The generated
  cells are held to the generator tests' flip budget (tests/
  test_torch_serving.py: 2% of values beyond 1e-2 of the image's range,
  mean difference under 1e-3 of it; the SPADE routing argmax may flip on
  near-ties), the source persons in the border exactly, and the PNGs have
  one size.
* `cli.train --tryon-grid 3 --trace DIR` on the CPU with a stub step (no
  step is computed): 3 steps (the JAX CLI's cap without --max-steps), a
  stats row a step, the grid at the snapshot, and a Chrome trace that
  parses and holds the snapshot's generator forward.
"""

import json
import os
import types

import numpy as np
import PIL.Image
import pytest
import torch

import pasta_tpu.native as jnative
import pasta_tpu_torch.native as pnative
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loop as jloop
from pasta_tpu_torch.cli import train as cli
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.io.from_jax import state_dict_to_jax
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import loop as ploop
from pasta_tpu_torch.train.state import make_models

K = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "root")
    return path, write_dataset_root(path, 4, 71)


def _recorded(module, monkeypatch):
    """Record what `module.save_image_grid` is handed, then write it."""
    calls = []
    original = module.save_image_grid

    def record(images, path, **kw):
        calls.append((np.asarray(images), kw))
        return original(images, path, **kw)

    monkeypatch.setattr(module, "save_image_grid", record)
    return calls


def test_grid_matches_jax(root, tmp_path, monkeypatch):
    path, names = root
    pcfg = pconfig.smoke_config(1)
    jcfg = jconfig.smoke_config(1)
    g_ema = make_models(pcfg, seed=5)[0].eval()
    variables = state_dict_to_jax(g_ema.state_dict())
    got_calls = _recorded(ploop, monkeypatch)
    ref_calls = _recorded(jloop, monkeypatch)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got_png = ploop.save_cross_pair_grid(
        pcfg, types.SimpleNamespace(g_ema=g_ema), path,
        str(tmp_path / "port"), 7, k=K, mode="thirds",
        image_names=names[:K])
    jloop.save_cross_pair_grid(
        jcfg, types.SimpleNamespace(g_ema_params=variables["params"],
                                    g_ema_buffers=variables["buffers"]),
        path, str(tmp_path / "jax"), 7, k=K, mode="thirds",
        image_names=names[:K])
    assert got_png == str(tmp_path / "port" / "tryon_grid000007.png")
    ref_png = tmp_path / "jax" / "tryon_grid000007.png"
    (got, got_kw), = got_calls
    (ref, ref_kw), = ref_calls
    assert got.shape == ref.shape == (K * K, 64, 64, 3)
    assert np.all(np.isfinite(got))
    span = ref.max() - ref.min()
    diff = np.abs(got - ref)
    assert np.mean(diff > 1e-2 * span) <= 2e-2
    assert diff.mean() <= 1e-3 * span, diff.mean()
    assert got_kw["grid_cols"] == ref_kw["grid_cols"] == K
    for key in ("side_images", "top_images"):
        np.testing.assert_array_equal(got_kw[key], ref_kw[key])
    a = np.asarray(PIL.Image.open(got_png))
    b = np.asarray(PIL.Image.open(ref_png))
    assert a.shape == b.shape == ((K + 1) * 64 + 4, (K + 1) * 64 + 4, 3)
    np.testing.assert_array_equal(a[:64], b[:64])       # the garment row


def test_cli_tryon_grid_and_trace(root, tmp_path, monkeypatch):
    path, _ = root
    steps = []

    def make_step(cfg, vgg=None):
        def step(state, batch, generator, do_r1_d=False, do_r1_dp=False,
                 do_pl=False):
            steps.append(batch["real_img"].shape)
            state.step += 1
            return state, {"g_loss": torch.zeros(()),
                           "d_loss": torch.zeros(()), "ada_p": 0.0}
        return step

    monkeypatch.setattr(ploop, "make_train_step", make_step)
    trace = str(tmp_path / "trace")
    run = cli.main(["--outdir", str(tmp_path / "runs"), "--data", path,
                    "--cfg", "smoke", "--vgg_weight", "0", "--device", "cpu",
                    "--tick", "1", "--snap", "3", "--workers", "1",
                    "--tryon-grid", str(K), "--trace", trace])
    assert len(steps) == 3                      # --max-steps or 3
    with open(os.path.join(run, "stats.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    grid = np.asarray(PIL.Image.open(os.path.join(run,
                                                  "tryon_grid000003.png")))
    assert grid.shape == ((K + 1) * 64 + 4, (K + 1) * 64 + 4, 3)
    assert os.path.exists(os.path.join(run, "ckpt-000003.pt"))
    with open(os.path.join(trace, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv2d" in n for n in names), sorted(names)[:20]
    options = json.load(open(os.path.join(run, "training_options.json")))
    assert options["args"]["tryon_grid"] == K
    assert options["args"]["trace"] == trace
