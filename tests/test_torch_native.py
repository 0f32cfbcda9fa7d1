"""The port's native C++ plugin (pasta_tpu_torch/native/) against the JAX
package's (pasta_tpu/native/), built from the port's own copy of warp.cpp
into pasta_tpu_torch/_build/: bit-equal on the same bytes and matrices, and
against cv2 / PIL as tests/test_native.py holds the JAX one (warps within
+-1 of cv2's fixed-point bilinear, erosion and PNG decode exact, JPEG within
+-1 of PIL). Then the branches that go through it: `DataRoot.decode_image`,
`_decode_label_plane` (gray, truecolour and palette PNGs), `_warp` and
`_erode_mask_255` with PASTA_USE_NATIVE on, one loader case with the plugin
on in both packages, and the clean fallback when it cannot build.

Whether the plugin built is decided in a fixture: a test that needs it
skips with the build error where it did not build.
"""

import dataclasses
import io

import cv2
import numpy as np
import PIL.Image
import pytest

import pasta_tpu.native as jnative
import pasta_tpu_torch.native as pnative
from pasta_tpu.data import preprocess as jpp
from pasta_tpu.data import roots as jroots
from pasta_tpu.data.geometry import get_perspective_transform
from pasta_tpu_torch.data import preprocess as pp
from pasta_tpu_torch.data import roots
from pasta_tpu_torch.data.synthetic import write_dataset_root


@pytest.fixture
def built():
    if not pnative.available():
        pytest.skip(f"port's native plugin: {pnative.build_error()}")
    if not jnative.available():
        pytest.skip(f"JAX package's native plugin: {jnative.build_error()}")


def _png(array, mode=None, palette=None):
    img = PIL.Image.fromarray(array, mode=mode) if mode else \
        PIL.Image.fromarray(array)
    if palette is not None:
        img.putpalette(palette)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def _jpeg(array):
    buf = io.BytesIO()
    PIL.Image.fromarray(array).save(buf, "JPEG", quality=95)
    return buf.getvalue()


def test_builds_into_the_package(built):
    assert pnative.build_error() is None
    assert pnative._lib._name.startswith(pnative._BUILD_ROOT)


@pytest.mark.parametrize("c,out", [(3, (128, 128)), (1, (70, 90))])
def test_warp_equals_jax_and_cv2(built, c, out):
    rng = np.random.RandomState(c)
    imgs = rng.randint(0, 255, (4, 96, 80, c), np.uint8)
    src_pts = np.float32([[5, 8], [10, 90], [70, 85], [66, 4]])
    dst_pts = np.float32([[0, 0], [0, out[0]], [out[1], out[0]], [out[1], 0]])
    m = get_perspective_transform(src_pts, dst_pts)
    mats = np.stack([np.linalg.inv(m + rng.rand(3, 3) * 1e-4 * i)
                     for i in range(4)])
    got = pnative.warp_perspective_batch(imgs, mats, *out, num_threads=3)
    ref = jnative.warp_perspective_batch(imgs, mats, *out, num_threads=3)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    ref_cv2 = cv2.warpPerspective(imgs[0], np.linalg.inv(mats[0]),
                                  out[::-1], borderMode=cv2.BORDER_CONSTANT)
    diff = np.abs(got[0].reshape(ref_cv2.shape).astype(int)
                  - ref_cv2.astype(int))
    assert diff.max() <= 1


def test_warp_degenerate_and_identity(built):
    img = np.full((1, 8, 8, 1), 200, np.uint8)
    m = np.eye(3)
    m[2] = 0.0                                  # denominator zero: border
    assert not pnative.warp_perspective_batch(img, m[None], 8, 8).any()
    ramp = np.arange(64, dtype=np.uint8).reshape(1, 8, 8, 1)
    assert np.array_equal(
        pnative.warp_perspective_batch(ramp, np.eye(3)[None], 8, 8), ramp)
    with pytest.raises(ValueError):
        pnative.warp_perspective_batch(ramp, np.eye(3)[None][:0], 8, 8)


@pytest.mark.parametrize("k", [5, 8])
def test_erode_equals_jax_and_cv2(built, k):
    rng = np.random.RandomState(k)
    masks = (rng.rand(6, 64, 72) > 0.4).astype(np.uint8) * 255
    got = pnative.erode_batch(masks, k, num_threads=4)
    assert np.array_equal(got, jnative.erode_batch(masks, k))
    for i in range(6):
        assert np.array_equal(
            got[i], cv2.erode(masks[i], np.ones((k, k), np.uint8)))


def test_decode_equals_jax_and_pil(built):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (33, 47, 3), np.uint8)
    rgba = rng.randint(0, 255, (9, 11, 4), np.uint8)
    gray = rng.randint(0, 255, (21, 17), np.uint8)
    pal = rng.randint(0, 7, (30, 20), np.uint8)
    palette = [v for i in range(256) for v in (i, 0, 255 - i)]
    for data, want in ((_png(rgb), rgb), (_png(rgba), rgba),
                       (_png(gray), gray),
                       (_png(pal, "P", palette), pal)):
        got = pnative.decode_image(data)
        assert np.array_equal(got, jnative.decode_image(data))
        assert np.array_equal(got, want)           # PNG: lossless
    data = _jpeg(rgb)
    got = pnative.decode_image(data)
    assert np.array_equal(got, jnative.decode_image(data))
    ref = np.array(PIL.Image.open(io.BytesIO(data)))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        pnative.decode_image(b"not an image at all")


def test_decode_batch_equals_jax(built):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 255, (5, 24, 16, 3), np.uint8)
    blobs = [_png(imgs[i]) if i % 2 else _jpeg(imgs[i]) for i in range(5)]
    got = pnative.decode_batch(blobs, 24, 16, 3, num_threads=3)
    assert np.array_equal(got, jnative.decode_batch(blobs, 24, 16, 3))
    assert np.array_equal(got[1::2], imgs[1::2])
    with pytest.raises(ValueError):
        pnative.decode_batch(blobs[:1], 16, 16, 3)


def test_label_plane_decode(built, tmp_path):
    """_decode_label_plane through the plugin == cv2.imread channel 0 ==
    the JAX package's, for gray, truecolour and palette PNGs, and a JPEG
    (the cv2 branch)."""
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 20, (40, 30), np.uint8)
    files = {
        "gray.png": _png(idx),
        "rgb.png": _png(rng.randint(0, 255, (40, 30, 3), np.uint8)),
        "pal.png": _png(idx, "P", [v for i in range(256)
                                   for v in (i, 255 - i, (i * 7) % 256)]),
        "photo.jpg": _jpeg(rng.randint(0, 255, (40, 30, 3), np.uint8)),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    assert files["pal.png"][25] == 3
    root, jroot = roots.as_root(str(tmp_path)), jroots.as_root(str(tmp_path))
    for name, data in files.items():
        got = pp._decode_label_plane(root, name)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR)[..., 0:1]
        assert np.array_equal(got, ref), name
        assert np.array_equal(got, jpp._decode_label_plane(jroot, name)), name
        assert np.array_equal(root.decode_image(name),
                              jroot.decode_image(name)), name
    assert pp._png_palette_blue(files["pal.png"]) is not None
    assert pp._png_palette_blue(files["gray.png"]) is None


@pytest.mark.parametrize("k", [5, 8])
def test_warp_and_erode_branches(built, monkeypatch, k):
    """`_warp` and `_erode_mask_255` with PASTA_USE_NATIVE on equal the
    JAX package's with it on, and the cv2 branch within +-1 / exactly."""
    rng = np.random.RandomState(k)
    img = rng.randint(0, 255, (64, 64, 3), np.uint8)
    m = get_perspective_transform(
        np.float32([[3, 5], [4, 60], [58, 62], [61, 2]]),
        np.float32([[0, 0], [0, 48], [40, 48], [40, 0]]))
    mask = (rng.rand(64, 64, 1) > 0.3).astype(np.uint8) * 255
    cv2_warp, cv2_erode = pp._warp(img, m, (40, 48)), pp._erode_mask_255(
        mask, k)
    monkeypatch.setattr(pp, "_USE_NATIVE", True)
    monkeypatch.setattr(jpp, "_USE_NATIVE", True)
    got = pp._warp(img, m, (40, 48))
    assert np.array_equal(got, jpp._warp(img, m, (40, 48)))
    assert np.abs(got.astype(int) - cv2_warp.astype(int)).max() <= 1
    got = pp._erode_mask_255(mask, k)
    assert np.array_equal(got, jpp._erode_mask_255(mask, k))
    assert np.array_equal(got, cv2_erode)


@pytest.mark.parametrize("as_zip", [False, True])
def test_loader_with_both_plugins(built, tmp_path, as_zip):
    """load_person over a root written to disk, both packages decoding
    through their plugins: every field of the record equal."""
    path = str(tmp_path / ("root.zip" if as_zip else "root"))
    names = write_dataset_root(path, 2, 70, as_zip=as_zip)
    for name in names:
        for raster in ("host", "device"):
            got = pp.load_person(path, name, with_garment_parsing=True,
                                 pose_raster=raster)
            ref = jpp.load_person(path, name, with_garment_parsing=True,
                                  pose_raster=raster)
            for f in dataclasses.fields(got):
                x, y = getattr(got, f.name), getattr(ref, f.name)
                if isinstance(x, dict):
                    assert all(np.array_equal(x[k], y[k]) for k in x)
                elif x is None or isinstance(x, str):
                    assert x == y, f.name
                else:
                    assert np.array_equal(x, y), f.name


def test_fallback_when_the_build_fails(monkeypatch, tmp_path):
    """A source that does not compile leaves available() False and the
    compiler's message in build_error(); the callers then take cv2 / PIL."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_SRC", str(bad))
    monkeypatch.setattr(pnative, "_BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_build_error", None)
    assert not pnative.available()
    assert "g++" in pnative.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        pnative.erode_batch(np.zeros((1, 4, 4), np.uint8), 3)
    data = _png(np.arange(12, dtype=np.uint8).reshape(3, 4))
    (tmp_path / "p.png").write_bytes(data)
    root = roots.as_root(str(tmp_path))
    assert np.array_equal(root.decode_image("p.png"),
                          np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert np.array_equal(pp._decode_label_plane(root, "p.png")[..., 0],
                          np.arange(12, dtype=np.uint8).reshape(3, 4))
