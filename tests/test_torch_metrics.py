"""The port's metrics against pasta_tpu's on the CPU: the copied numpy
formulas, the detectors (InceptionV3, VGG16 with LPIPS), their weights
crossed by `io/from_jax.py`, and the k-NN precision / recall.

Detectors run at full width on 2 seeded images, with the JAX package's
seeded random weights (`random_inception_params(0)`,
`random_vgg16_params(0)`, built once per module), carried into the port
with `inception_jax_to_state_dict` / `vgg16_jax_to_state_dict`; the port's
own `random_*_state(0)` draws the same weights.

Tolerances: the numpy formulas and FeatureStats are the same code, so equal
(FID, KID, IS to 1e-12 relative: one machine, one numpy); detector features
and logits fp32 through ~50 (Inception) or 16 (VGG16) layers, sums in
other orders: 1e-4 of the output's largest magnitude; resizes 1e-5 on
[-1, 1] values; precision / recall: identical counts on 200 x 64 features.
A stub launcher in place of the ctypes launch (as in
tests/test_torch_conv3x3_grad.py) shows that the detectors' convs in K1's
scope take the kernel route, C_out = 96 included.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.metrics import feature_stats as jfs
from pasta_tpu.metrics import fid as jfid
from pasta_tpu.metrics import inception as jinc
from pasta_tpu.metrics import inception_score as jis
from pasta_tpu.metrics import kid as jkid
from pasta_tpu.metrics import metric_main as jmm
from pasta_tpu.metrics import ppl as jppl
from pasta_tpu.metrics import precision_recall as jpr
from pasta_tpu.metrics import vgg16 as jvgg
from pasta_tpu_torch.io.from_jax import (inception_jax_to_state_dict,
                                         vgg16_jax_to_state_dict)
from pasta_tpu_torch.metrics import feature_stats, inception, ppl, vgg16
from pasta_tpu_torch.metrics import metric_main as mm
from pasta_tpu_torch.metrics.fid import compute_fid
from pasta_tpu_torch.metrics.inception_score import compute_is
from pasta_tpu_torch.metrics.kid import compute_kid
from pasta_tpu_torch.metrics.precision_recall import compute_pr
from pasta_tpu_torch.ops import conv3x3 as k1

TOL = 1e-4      # of the output's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def inc():
    params = jinc.random_inception_params(0)
    model = inception.InceptionV3().eval()
    model.load_state_dict(inception_jax_to_state_dict(params), strict=True)
    return params, model


@pytest.fixture(scope="module")
def vgg():
    params = jvgg.random_vgg16_params(0)
    model = vgg16.VGG16().eval()
    model.load_state_dict(vgg16_jax_to_state_dict(params), strict=True)
    return params, model


# ---------------------------------------------------------------- numpy ----

def test_fid_kid_is_equal():
    rng = np.random.RandomState(0)
    a = rng.randn(40, 16)
    b = rng.randn(40, 16) * 1.3 + 0.2
    mu_a, mu_b = a.mean(0), b.mean(0)
    sa, sb = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    np.testing.assert_allclose(compute_fid(mu_a, sa, mu_b, sb),
                               jfid.compute_fid(mu_a, sa, mu_b, sb),
                               rtol=1e-12)
    np.testing.assert_allclose(compute_kid(a, b, num_subsets=7,
                                           max_subset_size=30),
                               jkid.compute_kid(a, b, num_subsets=7,
                                                max_subset_size=30),
                               rtol=1e-12)
    probs = rng.dirichlet(np.ones(10), size=25)
    np.testing.assert_allclose(compute_is(probs, num_splits=3),
                               jis.compute_is(probs, num_splits=3),
                               rtol=1e-12)


def test_feature_stats_cross_load_and_cache_key(tmp_path):
    """A stats file written by either package loads in the other; the cache
    key is the same for the same arguments."""
    rng = np.random.RandomState(1)
    x = rng.randn(10, 6).astype(np.float32)
    for writer, reader in ((feature_stats.FeatureStats, jfs.FeatureStats),
                           (jfs.FeatureStats, feature_stats.FeatureStats)):
        s = writer(capture_all=True, capture_mean_cov=True, max_items=8)
        s.append(x[:5])
        s.append(x[5:])
        path = str(tmp_path / f"{writer.__module__}.pkl")
        s.save(path)
        got = reader.load(path)
        assert got.num_items == 8 and got.is_full()
        np.testing.assert_array_equal(got.get_all(), x[:8])
        for a, b in zip(got.get_mean_cov(), s.get_mean_cov()):
            np.testing.assert_array_equal(a, b)
    kw = dict(folder="/data/x", max_items=None, crop=(0, 512, 640, 960),
              detector="inception")
    assert (feature_stats.cache_path(str(tmp_path / "c"), "feats", **kw)
            == jfs.cache_path(str(tmp_path / "c"), "feats", **kw))
    assert os.path.isdir(tmp_path / "c")


def test_precision_recall_identical():
    rng = np.random.RandomState(2)
    real = rng.randn(200, 64).astype(np.float32)
    gen = (rng.randn(200, 64) * 1.1 + 0.15).astype(np.float32)
    got = compute_pr(real, gen, device="cpu")
    ref = jpr.compute_pr(real, gen)
    assert got == ref, (got, ref)
    assert 0 < got[0] < 1 and 0 < got[1] < 1


# ------------------------------------------------------------ inception ----

def test_random_state_matches_jax_draws(inc):
    """The port's seeded Inception is the JAX package's (VGG16's draw is
    written alike; drawing its 138 M weights twice costs 6 s here)."""
    ours = inception.random_inception_state(0)
    ref = inception_jax_to_state_dict(inc[0])
    assert sorted(ours) == sorted(ref)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


@pytest.mark.parametrize("size", [75, 299])
def test_inception_features_and_logits(inc, size):
    params, model = inc
    x = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    ref_f, ref_l = jax.jit(lambda p, x: jinc.inception_features(
        p, x, return_logits=True))(params, jnp.asarray(x))
    with torch.no_grad():
        feats, logits = model(torch.from_numpy(x), return_logits=True)
        plain = model(torch.from_numpy(x), fid_variant=False)
    assert feats.shape == (2, 2048) and logits.shape == (2, 1000)
    _close(feats.numpy(), ref_f)
    _close(logits.numpy(), ref_l)
    if size == 75:
        ref_plain = jax.jit(lambda p, x: jinc.inception_features(
            p, x, fid_variant=False))(params, jnp.asarray(x))
        _close(plain.numpy(), ref_plain)


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (2, 400, 320, 3)])
def test_inception_preprocess(shape):
    """Bilinear to 299 without antialias, up and down."""
    u8 = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    got = inception.preprocess_images(torch.from_numpy(u8)).numpy()
    ref = np.asarray(jinc.preprocess_images(u8))
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_inception_torchvision_state():
    """A torchvision-style state dict (aux head, batch counters) loads
    into the module as the JAX importer reads it."""
    sd = dict(inception.random_inception_state(1))
    sd["AuxLogits.fc.weight"] = torch.zeros(3)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(7)
    got = inception.torchvision_state(sd)
    ref = inception_jax_to_state_dict(jinc.import_inception_torch_state(
        {k: v.numpy() for k, v in sd.items()}))
    assert sorted(got) == sorted(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


# ---------------------------------------------------------------- vgg16 ----

@pytest.mark.parametrize("size", [64, 256])
def test_vgg16_fc_features_and_logits(vgg, size):
    """64 px inputs are upscaled to 224; 256 px downscaled, where
    jax.image.resize's default antialias applies."""
    params, model = vgg
    u8 = np.random.RandomState(size).randint(
        0, 256, (2, size, size, 3)).astype(np.uint8)
    with torch.no_grad():
        feats = model.fc_features(torch.from_numpy(u8))
        logits = model.logits(torch.from_numpy(u8))
    assert feats.shape == (2, 4096) and logits.shape == (2, 1000)
    _close(feats.numpy(), jvgg.fc_features(params, u8))
    _close(logits.numpy(), jvgg.logits(params, u8))


def test_vgg16_lpips(vgg):
    params, model = vgg
    rng = np.random.RandomState(4)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        fa = model.lpips_features(torch.from_numpy(a))
        d = model.lpips_distance(torch.from_numpy(a), torch.from_numpy(b))
    _close(fa.numpy(), jvgg.lpips_features(params, a))
    np.testing.assert_allclose(d.numpy(), jvgg.lpips_distance(params, a, b),
                               rtol=TOL)
    assert torch.allclose(d, (fa - model.lpips_features(
        torch.from_numpy(b))).square().sum(-1))


def test_vgg16_runner_matches_jax(vgg):
    """DetectorRunner(kind="vgg16"): fc7 features of in-memory uint8
    images (the PR detector), batches of 2 and a tail of 1."""
    params, model = vgg
    u8 = np.random.RandomState(6).randint(0, 256, (3, 64, 64, 3)).astype(
        np.uint8)
    got = mm.DetectorRunner(model, batch_size=2, kind="vgg16").array_stats(
        u8, capture_all=True)
    ref = jmm.DetectorRunner(params, batch_size=2, kind="vgg16").array_stats(
        u8, capture_all=True)
    assert got.probs is None and ref.probs is None
    _close(got.get_all(), ref.get_all())


def test_lpips_feature_fn_matches_jax(vgg):
    """PPL's LPIPS feature map, with its box downsample (128 -> 64)."""
    params, model = vgg
    x = np.random.RandomState(8).uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)
    for size in (64, 256):
        got = ppl.make_lpips_feature_fn(model, downsample_to=size)(
            torch.from_numpy(x))
        ref = jppl.make_lpips_feature_fn(params, downsample_to=size)(
            jnp.asarray(x))
        _close(got.detach().numpy(), ref)


def test_vgg16_import_state_with_lpips(vgg):
    sd = vgg[1].state_dict()
    tv = {k: v.numpy() for k, v in sd.items() if not k.startswith("lins")}
    lp = {f"lin{k}.model.1.weight": sd[f"lins.{k}"].numpy().reshape(
        1, -1, 1, 1) for k in range(5)}
    for lpips_state in (lp, None):
        got = vgg16.import_state(tv, lpips_state)
        ref = vgg16_jax_to_state_dict(jvgg.import_vgg16_torch_state(
            tv, lpips_state))
        assert sorted(got) == sorted(ref)
        assert all(torch.equal(got[k], ref[k]) for k in ref)


# ------------------------------------------------------------- K1 route ----

@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors down the kernel route, with a CPU stand-in for the
    ctypes launch that records each launch's shapes."""
    def stub(x, w, out_w, pad=0):
        stub.calls.append((tuple(x.shape), tuple(w.shape), out_w, pad))
        out = k1.conv3x3_valid_plain(x.detach(), w.detach(), out_w, pad)
        assert out.grad_fn is None
        return out

    stub.calls = []
    monkeypatch.setattr(k1, "_plain_route", lambda x: False)
    monkeypatch.setattr(k1, "_kernel", stub)
    monkeypatch.setattr(k1.conv3x3_valid, "launches", 0)
    return stub


def test_detector_convs_take_k1(inc, vgg, kernel_route):
    """InceptionV3: the four branch3x3dbl_2 convs (64 -> 96) of Mixed_5b,
    5c, 5d and 6a; VGG16's LPIPS backbone: features.2, .5 and .7. Each a
    launch of K1 (counted), and the outputs those of the plain route."""
    _, model = inc
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (2, 80, 80, 3)).astype(np.float32))
    with torch.no_grad():
        got = model(x)
    calls = list(kernel_route.calls)
    assert len(calls) == 4 and k1.conv3x3_valid.launches == 4
    side = calls[0][0][1]
    for xs, ws, out_w, pad in calls:
        assert xs == (2, side, side, 64) and ws == (3, 3, 64, 96)
        assert out_w == side - 2 and pad == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k1, "_plain_route", lambda x: True)
        with torch.no_grad():
            ref = model(x)
    assert torch.equal(got, ref)

    kernel_route.calls.clear()
    _, vmodel = vgg
    with torch.no_grad():
        vmodel.lpips_features(x[:, :64, :64])
    assert [(c[0][1:], c[1][2:]) for c in kernel_route.calls] == [
        ((66, 66, 64), (64, 64)), ((34, 34, 64), (64, 128)),
        ((34, 34, 128), (128, 128))]
    assert k1.conv3x3_valid.launches == 7
