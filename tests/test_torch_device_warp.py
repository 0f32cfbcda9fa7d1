"""The port's device warps (pasta_tpu_torch/data/device_warp.py) vs their
JAX twins on synthetic inputs. Erosion, source stacks, sleeve mirroring,
conflict zeroing and the bound planes are exact. Bilinear warps compute the
same fp32 coordinates and taps; the tolerance (1e-3 on 0..255 values)
covers a different rounding of the tap blend. Composited masks pass an
erode-then-threshold step, so a pixel whose warped value sits at the
threshold may flip: at most 1e-4 of them may differ."""

import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pasta_tpu.data import device_warp as jdw
from pasta_tpu_torch.data import device_warp as tdw
from pasta_tpu_torch.data.host import host_prepare
from pasta_tpu_torch.data.synthetic import make_garment, make_person
from pasta_tpu_torch.serving import ingest_device


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=1e-3)


def _homographies(rng, n):
    m = np.tile(np.eye(3), (n, 1, 1)) + rng.randn(n, 3, 3) * [
        [0.2, 0.2, 3.0], [0.2, 0.2, 3.0], [1e-3, 1e-3, 0.0]]
    return m.astype(np.float32)


def _quad_h(rng, src, out):
    """dst->src homography of a random rotated perspective quad."""
    dst = np.float32([[0, 0], [out - 1, 0], [out - 1, out - 1], [0, out - 1]])
    ang = rng.uniform(0, 2 * np.pi)
    rot = np.float32([[np.cos(ang), -np.sin(ang)],
                      [np.sin(ang), np.cos(ang)]])
    base = np.float32([[-1, -1], [1, -1], [1, 1], [-1, 1]]) \
        * rng.uniform(src * 0.2, src * 0.45)
    quad = (base @ rot.T) + src / 2 + rng.uniform(
        -0.06 * src, 0.06 * src, (4, 2)).astype(np.float32)
    return cv2.getPerspectiveTransform(dst, quad.astype(np.float32))


def _random_maps():
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 40, 36, 3) * 255).astype(np.float32)
    return img, _homographies(rng, 2), 48, 44


def _rotated_maps():
    """Rotation-heavy quads, a quarter turn, and the all-zero matrix of an
    invalid part (every denominator 0: _src_coords' safe branch)."""
    rng = np.random.RandomState(3)
    img = (rng.rand(8, 48, 48, 3) * 255).astype(np.float32)
    turn = np.zeros((3, 3))
    turn[0, 1], turn[1, 0], turn[1, 2], turn[2, 2] = 1.0, -1.0, 47.0, 1.0
    m = np.stack([_quad_h(rng, 48, 40) for _ in range(6)]
                 + [turn, np.zeros((3, 3))]).astype(np.float32)
    return img, m, 40, 40


def _axis_aligned_maps():
    """An axis-aligned scale with integer shifts."""
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 255, (2, 64, 64, 2)).astype(np.float32)
    m = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    m[:, 0, 0] = [0.53, 1.0]
    m[:, 0, 2] = [3.0, -9.0]
    m[:, 1, 2] = [0.0, 12.0]
    return img, m, 48, 48


@pytest.mark.parametrize("maps", [_random_maps, _rotated_maps,
                                  _axis_aligned_maps],
                         ids=["random", "rotated", "axis_aligned"])
def test_warp_perspective(maps):
    img, m, out_h, out_w = maps()
    got = tdw.warp_perspective(*_t(img, m), out_h, out_w)
    assert got.shape == (len(img), out_h, out_w, img.shape[-1])
    assert np.isfinite(got.numpy()).all()
    _close(got, jdw.warp_perspective(*_j(img, m), out_h, out_w))


def _random_parts():
    rng = np.random.RandomState(1)
    src = (rng.rand(2, 3, 32, 30, 4) * 255).astype(np.float32)
    m = _homographies(rng, 10).reshape(2, 5, 3, 3)
    return src, np.array([0, 2, 1, 1, 0]), m, 20, 24


def _rotated_parts():
    """The rotated maps as 2 x 4 parts: the second item's last two are
    the quarter turn and the all-zero matrix host prep gives an invalid
    part."""
    img, m, out_h, out_w = _rotated_maps()
    src = np.concatenate([img, img[..., :1]], -1).reshape(2, 4, 48, 48, 4)
    return src[:, :3], np.array([0, 2, 1, 0]), m.reshape(2, 4, 3, 3), \
        out_h, out_w


@pytest.mark.parametrize("parts", [_random_parts, _rotated_parts],
                         ids=["random", "rotated"])
def test_warp_perspective_multi(parts):
    src, idx, m, out_h, out_w = parts()
    got = tdw.warp_perspective_multi(*_t(src), idx, *_t(m), out_h, out_w)
    assert got.shape == (2, len(idx), out_h, out_w, 4)
    _close(got, jdw.warp_perspective_multi(*_j(src), idx, *_j(m), out_h,
                                           out_w))


@pytest.mark.parametrize("k", [5, 8])
def test_erode(k):
    mask = ((np.random.RandomState(k).rand(2, 64, 64, 1) > 0.3) * 255.0
            ).astype(np.float32)
    _eq(tdw.erode(*_t(mask), k), jdw.erode(*_j(mask), k))


@pytest.fixture(scope="module")
def ingested():
    items = [host_prepare(make_person(s, jitter=j), make_garment(100 + s),
                          "upper", cond="device")
             for s, j in ((0, 3.0), (1, 10.0))]
    assert all(bool(it["tiles_fit"]) for it in items)
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]
             if k != "tiles_fit"}
    out = ingest_device(dict(zip(batch, _t(*batch.values()))))
    return {k: v.numpy() for k, v in out.items()}


ARGS = ("upper_img", "lower_img", "upper_mask", "lower_mask", "sleeve",
        "upper_cut_m", "lower_cut_m", "paste_m_inv", "part_valid")


def test_cut_src_stack(ingested):
    a = [ingested[k] for k in ARGS[:5]]
    for sv in (None, np.array([1.0, 0.0], np.float32)):
        extra_t = _t(sv)[0] if sv is not None else None
        extra_j = _j(sv)[0] if sv is not None else None
        _eq(tdw._cut_src_stack(*_t(*a), extra_t),
            jdw._cut_src_stack(*_j(*a), extra_j))


@pytest.mark.parametrize("tiled", [False, True])
def test_normalize_patches(ingested, tiled):
    args = [ingested[k] for k in ARGS]
    kw = dict(erode_k=8, track_wo_sleeve=True)
    if tiled:
        got = tdw.normalize_patches_device_tiled(
            *_t(*args), *_t(ingested["tile_offsets"]), **kw,
            sleeve_valid=_t(ingested["sleeve_valid"])[0])
        ref = jdw.normalize_patches_device_tiled(
            *_j(*args), *_j(ingested["tile_offsets"]), **kw,
            sleeve_valid=_j(ingested["sleeve_valid"])[0])
    else:
        got = tdw.normalize_patches_device(
            *_t(*args), **kw, sleeve_valid=_t(ingested["sleeve_valid"])[0])
        ref = jdw.normalize_patches_device(
            *_j(*args), **kw, sleeve_valid=_j(ingested["sleeve_valid"])[0])
    assert sorted(got) == sorted(ref)
    assert float(got["denorm_upper_img"].sum()) > 0
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        # compare pixels: a flipped composite-mask pixel moves all channels
        bad = np.any(np.abs(g - r) > 1e-3, axis=-1)
        assert np.mean(bad) <= 1e-4, (k, np.mean(bad))


def test_mirror_and_conflicts():
    rng = np.random.RandomState(3)
    imgs = rng.rand(3, 8, 8, 30).astype(np.float32)
    masks = (rng.rand(3, 8, 8, 10) > 0.5).astype(np.float32)
    masks[0, ..., 2] = 0                  # item 0: sleeve 2 missing
    masks[1, ..., 5] = 0                  # item 1: sleeve 5 missing
    masks[2, ..., 3] = masks[2, ..., 5] = 0
    norm = dict(norm_img=imgs, norm_clothes_masks=masks,
                norm_img_lower=rng.rand(3, 8, 8, 15).astype(np.float32),
                norm_clothes_masks_lower=(rng.rand(3, 8, 8, 5) > 0.5).astype(
                    np.float32))
    for fn in ("mirror_sleeves_device", "zero_conflicts_device"):
        got = getattr(tdw, fn)(dict(zip(norm, _t(*norm.values()))))
        ref = getattr(jdw, fn)(dict(zip(norm, _j(*norm.values()))))
        for k in ref:
            _eq(got[k], ref[k])


def test_bound_planes():
    rng = np.random.RandomState(4)
    mask = np.zeros((3, 32, 24, 1), np.float32)
    mask[0, 5:9, 3:7] = 1
    mask[1, 20:30, 10:12] = 1             # item 2 stays empty
    bound = (rng.rand(3, 32, 24, 1) > 0.5).astype(np.float32) * 255
    _eq(tdw.bound_from_mask_top(*_t(mask)), jdw.bound_from_mask_top(*_j(mask)))
    _eq(tdw.zero_bound_above_mask_bottom(*_t(bound, mask)),
        jdw.zero_bound_above_mask_bottom(*_j(bound, mask)))
