"""The port's host stage (pasta_tpu_torch/data/host.py) equals the
functions it was carried from, on synthetic records: every output is
`np.array_equal` to the original's."""

import numpy as np
import pytest

from pasta_tpu import serving as jserving
from pasta_tpu.data import device_cond as jcond
from pasta_tpu.data import device_warp as jwarp
from pasta_tpu_torch.data import host
from pasta_tpu_torch.data.synthetic import make_garment, make_person

# (seed, jitter): small jitter fits the paste tiles, large jitter does not
PAIRS = [(0, 3.0), (2, 30.0), (3, 60.0)]


def _equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what


@pytest.mark.parametrize("seed,jitter", PAIRS)
@pytest.mark.parametrize("mode", ["upper", "lower", "full"])
@pytest.mark.parametrize("cond", ["device", "host"])
def test_host_prepare_equals_original(seed, jitter, mode, cond):
    person = make_person(seed, jitter=jitter, garment=(mode == "lower"))
    clothes = make_garment(100 + seed, jitter=jitter)
    got = host.host_prepare(person, clothes, mode, cond=cond)
    ref = jserving.host_prepare(person, clothes, mode, cond=cond)
    _equal(got, ref, f"host_prepare[{mode},{cond}]")


def test_host_prepare_without_sleeve_mask():
    person, clothes = make_person(4), make_garment(104)
    _equal(host.host_prepare(person, clothes, "upper", use_sleeve_mask=False,
                             cond="device"),
           jserving.host_prepare(person, clothes, "upper",
                                 use_sleeve_mask=False, cond="device"),
           "host_prepare[no sleeve]")


@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_matrices_and_layouts(seed, jitter):
    a, b, c = (make_person(s, jitter=jitter).keypoints
               for s in (seed, seed + 10, seed + 20))
    for fwd in (False, True):
        _equal(host.host_matrices_for_pair(a, b, c, return_paste_fwd=fwd),
               jwarp.host_matrices_for_pair(a, b, c, return_paste_fwd=fwd),
               "host_matrices_for_pair")
    mu, ml, pinv, valid, pfwd = jwarp.host_matrices_for_pair(
        a, b, c, return_paste_fwd=True)
    _equal(host.paste_tile_layout(pinv, valid[:, 2]),
           jwarp.paste_tile_layout(pinv, valid[:, 2]), "paste_tile_layout")
    _equal(host.paste_tile_layout(pinv, valid[:, 2], paste_fwd_parts=pfwd),
           jwarp.paste_tile_layout(pinv, valid[:, 2], paste_fwd_parts=pfwd),
           "paste_tile_layout[fwd]")
    _equal(host.cut_window_layout(mu, valid[:, 0]),
           jwarp.cut_window_layout(mu, valid[:, 0]), "cut_window_layout")
    _equal(host.part_layouts_for_pair(mu, ml, pinv, valid, pfwd),
           jwarp.part_layouts_for_pair(mu, ml, pinv, valid, pfwd),
           "part_layouts_for_pair")


@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_pose_and_palm_params(seed, jitter):
    kp = make_person(seed, jitter=jitter).keypoints
    kp[9, 1] = 480.0            # an ankle/knee near the border: invalidated
    ka, kb = kp.copy(), kp.copy()
    _equal(host.pose_device_params(ka, 512, 320, 96),
           jcond.pose_device_params(kb, 512, 320, 96), "pose_device_params")
    _equal(ka, kb, "mutated keypoints")
    _equal(host.palm_device_params(kp), jcond.palm_device_params(kp),
           "palm_device_params")


def test_winding_normalized():
    rng = np.random.RandomState(5)
    quads = [rng.rand(4, 2) * 50, rng.rand(4, 2)[::-1] * 50,
             np.tile([[3.0, 4.0]], (4, 1))]          # degenerate: a point
    for q in quads:
        _equal(host._winding_normalized(q), jcond._winding_normalized(q),
               "_winding_normalized")
