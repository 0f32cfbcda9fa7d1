"""The port's in-training evaluator (train/loop.py::TrainingEvaluator)
against pasta_tpu's, and the port's training loop with the metrics on, on
the CPU.

Both evaluators run on one synthetic dataset root of 4 items at the smoke
config (64 px, the host loader's items resized by `_resize_item`), with
the same G-EMA weights (the port's `init_state`, carried by
`state_dict_to_jax`) and the same seeded Inception detector
(`random_inception_params(0)`): fid_holdout, kid_holdout and fid_tryon.
There is no JAX training loop here (its compile costs minutes); the port's
`training_loop` runs 2 steps with eval_metrics=("fid",), one tick and
eval_ticks=1, and its stats.jsonl must carry fid_holdout while the sampler
never hands out a held-out index. A second evaluator over the same items
reads the reals' stats from the disk cache the first wrote.

Both packages decode with PIL / cv2 (their `native.available` patched to
False). Tolerances: the reals' detector features 1e-4 of their largest
magnitude (fp32 through ~50 layers); the generated images' features 1e-3
(the G-EMA's SPADE routing may flip an argmax where two parsing logits tie
within fp32 noise, as tests/test_torch_generator.py budgets); KID 1e-2
relative. FID's statistics are held through a stand-in for compute_fid in
both packages (the same numpy code, held equal in
tests/test_torch_metrics.py; scipy's sqrtm of a 2048 x 2048 product takes
~10 s a call on a CPU): their means and covariances at the features'
tolerances.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import pasta_tpu.native as jnative
from pasta_tpu.data import trainsets as jts
from pasta_tpu.metrics import fid as jfid
from pasta_tpu.metrics import inception as jinc
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loop as jloop
import pasta_tpu_torch.native as pnative
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.io.from_jax import (inception_jax_to_state_dict,
                                         state_dict_to_jax)
from pasta_tpu_torch.metrics import fid as pfid
from pasta_tpu_torch.metrics.inception import InceptionV3
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import loop as ploop
from pasta_tpu_torch.train import state as pstate

N_ITEMS = 4


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
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval") / "root")
    write_dataset_root(root, N_ITEMS, 82)
    params = jinc.random_inception_params(0)
    detector = InceptionV3().eval()
    detector.load_state_dict(inception_jax_to_state_dict(params), strict=True)
    return root, params, detector


class FidSpy:
    """compute_fid's stand-in: records its statistics, returns the FID
    without the sqrtm term."""

    def __init__(self):
        self.calls = []

    def __call__(self, mu_r, sig_r, mu_g, sig_g):
        self.calls.append((mu_r, sig_r, mu_g, sig_g))
        return float(np.square(mu_g - mu_r).sum() + np.trace(sig_g)
                     + np.trace(sig_r))


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_evaluators_agree(setup, monkeypatch):
    root, params, detector = setup
    metrics = ("fid", "kid", "fid_tryon")
    pcfg = pconfig.smoke_config(1)
    jcfg = jconfig.smoke_config(1)
    state = pstate.init_state(pcfg, seed=4, device="cpu")
    variables = state_dict_to_jax(state.g_ema.state_dict())
    spies = FidSpy(), FidSpy()
    monkeypatch.setattr(pfid, "compute_fid", spies[0])
    monkeypatch.setattr(jfid, "compute_fid", spies[1])

    ev = ploop.TrainingEvaluator(
        pcfg, ts.TryonTrainDataset(root, seed=0, resolution=64), detector,
        num_items=N_ITEMS, metrics=metrics)
    jev = jloop.TrainingEvaluator(
        jcfg, jts.TryonTrainDataset(root, seed=0, resolution=64), params,
        num_items=N_ITEMS, metrics=metrics)
    _close(ev.real_stats.get_all(), jev.real_stats.get_all(), 1e-4)
    got = ev(state)
    ref = jev(types.SimpleNamespace(g_ema_params=variables["params"],
                                    g_ema_buffers=variables["buffers"]))
    assert sorted(got) == sorted(ref) == ["fid_holdout", "fid_tryon",
                                          "kid_holdout"]
    np.testing.assert_allclose(got["kid_holdout"], ref["kid_holdout"],
                               rtol=1e-2)
    for k in ("fid_holdout", "fid_tryon"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3)
    assert len(spies[0].calls) == len(spies[1].calls) == 2
    for call, jcall in zip(spies[0].calls, spies[1].calls):
        for a, b, tol in zip(call, jcall, (1e-4, 1e-4, 1e-3, 1e-3)):
            _close(a, b, tol)


def test_loop_writes_metrics_and_skips_holdout(setup, tmp_path,
                                                monkeypatch):
    root, _, detector = setup
    taken = []

    class Recording(ploop.ParallelLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            get = self._get
            self._get = lambda i: taken.append(i) or get(i)

    monkeypatch.setattr(ploop, "ParallelLoader", Recording)
    spy = FidSpy()
    monkeypatch.setattr(pfid, "compute_fid", spy)
    cfg = pconfig.smoke_config(1, use_noise=False, use_ada=False)
    run = str(tmp_path / "run")
    ploop.training_loop(
        cfg, ts.TryonTrainDataset(root, seed=0, resolution=64), run,
        total_steps=2, tick_interval=2, snapshot_ticks=10, num_workers=1,
        device="cpu", eval_metrics=("fid",), eval_ticks=1, eval_items=2,
        detector=detector)
    with open(os.path.join(run, "stats.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert row["step"] == 2 and len(spy.calls) == 1
    assert row["fid_holdout"] == spy(*spy.calls[0]) > 0
    assert "metrics fid_holdout" in open(os.path.join(run, "log.txt")).read()
    # the sampler held the first 2 items out: batch 2, two batches in flight
    assert taken and min(taken) >= 2 and set(taken) <= {2, 3}


def test_real_stats_cached_across_constructions(setup, tmp_path,
                                                monkeypatch):
    """The held-out reals' detector stats are computed once: a second
    evaluator over the same items and detector reads them from the cache
    and extracts no real feature."""
    root, _, detector = setup
    cfg = pconfig.smoke_config(1)
    cache = str(tmp_path / "cache")
    first = ploop.TrainingEvaluator(
        cfg, ts.TryonTrainDataset(root, seed=0, resolution=64), detector,
        num_items=2, cache_dir=cache)
    (name,) = os.listdir(cache)
    assert name.startswith("train-real-stats-")
    from pasta_tpu_torch.metrics import metric_main

    def no_extraction(*a, **kw):
        raise AssertionError("the reals' features were extracted again")

    monkeypatch.setattr(metric_main.DetectorRunner, "array_stats",
                        no_extraction)
    second = ploop.TrainingEvaluator(
        cfg, ts.TryonTrainDataset(root, seed=0, resolution=64), detector,
        num_items=2, cache_dir=cache)
    np.testing.assert_array_equal(second.real_stats.get_all(),
                                  first.real_stats.get_all())
    assert os.listdir(cache) == [name]
