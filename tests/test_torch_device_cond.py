"""The port's device conditioning (pasta_tpu_torch/data/device_cond.py) vs
its JAX twins on synthetic records. Masks, rasters, LUT masks and the
median are exact in the JAX package, so the port must match exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pasta_tpu import serving as jserving
from pasta_tpu.data import device_cond as jdc
from pasta_tpu_torch import serving as tserving
from pasta_tpu_torch.data import device_cond as tdc
from pasta_tpu_torch.data.host import host_prepare
from pasta_tpu_torch.data.synthetic import make_garment, make_person


@pytest.fixture(scope="module")
def batch():
    items = [host_prepare(make_person(s, jitter=j), make_garment(100 + s),
                          "upper", cond="device")
             for s, j in ((0, 3.0), (1, 20.0), (2, 40.0))]
    return {k: np.stack([it[k] for it in items]) for k in items[0]
            if k != "tiles_fit"}


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


POSE_KEYS = ("limb_pts", "limb_valid", "joint_pts", "joint_valid", "pose_xlim")


def test_draw_pose(batch):
    args = [batch[k] for k in POSE_KEYS]
    got = tdc.draw_pose_device(*_t(*args))
    ref = jdc.draw_pose_device(*_j(*args))
    assert got.shape == (3, 512, 512, 3) and float(got.max()) > 0
    _eq(got, ref)


@pytest.mark.parametrize("k", [5, 8, 28, 35])
def test_dilate(k):
    rng = np.random.RandomState(k)
    m = (rng.rand(2, 40, 48, 1) > 0.97).astype(np.float32)
    _eq(tdc.dilate_cv(*_t(m), k), jdc.dilate_cv(*_j(m), k))


def test_fill_quad(batch):
    quads = batch["palm_quads"][:, 0, 0]                      # [B, 4, 2]
    got = tdc._fill_quad_device(*_t(quads), 512)
    assert got.any()
    _eq(got, jdc._fill_quad_device(*_j(quads), 512))


def test_palm_retain_lut_skin(batch):
    pq, pv, par, img = (batch["palm_quads"], batch["palm_valid"],
                        batch["parsing"], batch["image"])
    palm = tdc.palm_mask_device(*_t(pq, pv, par))
    jpalm = jdc.palm_mask_device(*_j(pq, pv, par))
    assert float(palm.sum()) > 0
    _eq(palm, jpalm)
    _eq(tdc.retain_mask_device(*_t(par), palm),
        jdc.retain_mask_device(*_j(par), jpalm))
    for lut, src in (("upper_lut", "upper_src_parsing"),
                     ("lower_lut", "lower_src_parsing")):
        _eq(tdc.garment_lut_mask(*_t(batch[lut], batch[src])),
            jdc.garment_lut_mask(*_j(batch[lut], batch[src])))
    _eq(tdc.skin_median_device(*_t(img, par)),
        jdc.skin_median_device(*_j(img, par)))


def test_skin_median_empty_and_even_counts():
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    par = np.zeros((3, 16, 16, 1), np.uint8)
    par[1, :4, :5] = 13                 # 20 pixels: even count
    par[2, 3:10, 2:9] = 10              # 49 pixels: odd count
    img[2, 3:5, 2:9, 1] = 0             # zeros are excluded
    got = tdc.skin_median_device(*_t(img, par))
    _eq(got, jdc.skin_median_device(*_j(img, par)))
    assert np.all(got.numpy()[0] == 0)


def test_compute_device_cond(batch):
    got = tserving.compute_device_cond(dict(zip(batch, _t(*batch.values()))))
    ref = jserving.compute_device_cond(dict(zip(batch, _j(*batch.values()))))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _eq(got[k], ref[k])
