"""The port's host stage (pasta_tpu_torch/data/host.py) equals the
functions it was carried from, on synthetic records: every output is
`np.array_equal` to the original's, but for the cut windows (WINDOWS),
which serve only the JAX package's matmul warps and which the port does
not carry."""

import dataclasses

import numpy as np
import pytest

from pasta_tpu import serving as jserving
from pasta_tpu.data import geometry as jgeometry
from pasta_tpu.data import pose as jpose
from pasta_tpu.data import preprocess as jpp
from pasta_tpu.data import device_cond as jcond
from pasta_tpu.data import device_warp as jwarp
from pasta_tpu_torch.data import geometry, host, pose
from pasta_tpu_torch.data import preprocess as pp
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import make_garment, make_person

# (seed, jitter): small jitter fits the paste tiles, large jitter does not
PAIRS = [(0, 3.0), (2, 30.0), (3, 60.0)]
# the JAX items' fields of the windowed cut, which the port does not carry
WINDOWS = ("cut_window_offsets", "cut_fits")


def _jax_item(item):
    """A JAX host item without its WINDOWS."""
    return {k: v for k, v in item.items() if k not in WINDOWS}


def _jax_record(rec):
    """The port's PersonRecord as the JAX package's own class, field by
    field, for the calls that cross to `pasta_tpu`."""
    return jpp.PersonRecord(**{f.name: getattr(rec, f.name)
                              for f in dataclasses.fields(rec)})


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
    ref = jserving.host_prepare(_jax_record(person), _jax_record(clothes),
                                mode, cond=cond)
    _equal(got, _jax_item(ref), f"host_prepare[{mode},{cond}]")


def test_host_prepare_without_sleeve_mask():
    person, clothes = make_person(4), make_garment(104)
    _equal(host.host_prepare(person, clothes, "upper", use_sleeve_mask=False,
                             cond="device"),
           _jax_item(jserving.host_prepare(
               _jax_record(person), _jax_record(clothes), "upper",
               use_sleeve_mask=False, cond="device")),
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
    _equal(host.part_layouts_for_pair(pinv, valid, pfwd),
           jwarp.part_layouts_for_pair(mu, ml, pinv, valid, pfwd)[:2],
           "part_layouts_for_pair")


@pytest.mark.parametrize("kind", ["host_prepare_device",
                                  "host_prepare_host", "train_lean"])
def test_items_carry_tiles_and_no_windows(kind):
    """Serving and lean training items carry no cut windows, and their
    paste tiles are the JAX layout function's."""
    person, clothes = make_person(5, jitter=3.0), make_garment(105)
    if kind == "train_lean":
        item = ts.preprocess_person_train_lean(person,
                                               np.random.RandomState(5))
        sources = (person, person, person)
    else:
        item = host.host_prepare(person, clothes, "upper",
                                 cond=kind.rsplit("_", 1)[1])
        sources = (clothes, person, person)   # upper cut, lower cut, paste
    assert not set(WINDOWS) & set(item)
    mats = jwarp.host_matrices_for_pair(*(r.keypoints for r in sources),
                                        return_paste_fwd=True)
    offsets, fits, _, _ = jwarp.part_layouts_for_pair(*mats)
    _equal(item["tile_offsets"], offsets, "tile_offsets")
    assert bool(item["tiles_fit"]) == fits


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


# ---------------------------------------------------------------------------
# the port's own pose / geometry / preprocess modules against the originals

@pytest.mark.parametrize("mod,orig,name", [
    (pose, jpose, "LIMB_SEQ"), (pose, jpose, "KPT_COLORS"),
    (pose, jpose, "JOINT_ORDER"), (geometry, jgeometry, "BODY_PARTS"),
    (geometry, jgeometry, "LOWER_PARTS"),
    (geometry, jgeometry, "SLEEVE_PARTS"), (pp, jpp, "_RETAIN_LUT"),
    (pp, jpp, "_USE_NATIVE"),
])
def test_copied_constants(mod, orig, name):
    got, ref = getattr(mod, name), getattr(orig, name)
    assert type(got) is type(ref)
    if isinstance(ref, np.ndarray):
        _equal(got, ref, name)
    else:
        assert got == ref


def test_person_record_fields():
    got = [(f.name, f.default) for f in dataclasses.fields(pp.PersonRecord)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jpp.PersonRecord)]
    assert got == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_and_rectangle_quads(seed):
    rng = np.random.RandomState(seed)
    quads = [rng.rand(4, 2) * 60 - 5,                       # partly outside
             np.array([[5, 5], [40, 8], [38, 30], [3, 28]], np.float64),
             np.tile([[7.0, 9.0]], (4, 1)),                 # a point
             rng.rand(4, 2) * 10 + 100]                     # off the canvas
    for q in quads:
        _equal(pose._fill_quad(q, (48, 64)), jpose._fill_quad(q, (48, 64)),
               "_fill_quad")
    for _ in range(4):
        a, b, c, d = rng.rand(4) * 100
        _equal(pose._rectangle_quad(a, b, c, d),
               jpose._rectangle_quad(a, b, c, d), "_rectangle_quad")
    _equal(pose._rectangle_quad(3.0, 4.0, 3.0, 4.0),
           jpose._rectangle_quad(3.0, 4.0, 3.0, 4.0), "_rectangle_quad[0]")


@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_part_quads_and_perspective(seed, jitter):
    kp = make_person(seed, jitter=jitter).keypoints
    cases = [kp]
    for drop in ([9], [12, 13], [0], [8, 11], [3, 4]):    # fallback chains
        k = kp.copy()
        k[drop, 2] = 0.0
        cases.append(k)
    for k in cases:
        got, ref = geometry.part_quads(k, 512, 512), jgeometry.part_quads(
            k, 512, 512)
        _equal(got, ref, "part_quads")
    rng = np.random.RandomState(seed)
    src = rng.rand(6, 4, 2) * 100
    dst = src + rng.rand(6, 4, 2) * 20
    got = geometry.perspective_batch(src, dst)
    ref = jgeometry.perspective_batch(src, dst)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    # float matrices: the same LAPACK solve on the same system
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _parsing_with(rng, labels, res=64):
    """A label plane with random rectangles of the given labels."""
    p = np.zeros((res, res, 1), np.uint8)
    for lab in labels:
        y, x = rng.randint(0, res - 8, 2)
        h, w = rng.randint(4, 30, 2)
        p[y:y + h, x:x + w] = lab
    return p


@pytest.mark.parametrize("labels", [
    (5, 9), (5, 12), (6,), (6, 9), (5, 6, 12), (7, 6, 5), (6, 12, 12, 5),
    (), (9, 12, 12, 12),
])
def test_garment_class_routing_and_luts(labels):
    rng = np.random.RandomState(len(labels) + sum(labels))
    parsing = _parsing_with(rng, labels)
    got, ref = pp.garment_class_routing(parsing), jpp.garment_class_routing(
        parsing)
    assert got == ref
    for cls, (labs, _) in ref.items():
        _equal(pp.label_lut(labs), jpp.label_lut(labs), f"label_lut[{cls}]")
        assert pp.bbox_of_labels(parsing, labs) == jpp.bbox_of_labels(
            parsing, labs)
    mask = rng.rand(40, 50, 3) > 0.97
    assert pp.mask_to_bbox(mask) == jpp.mask_to_bbox(mask)
    assert pp.mask_to_bbox(np.zeros((8, 8))) is None


@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_record_masks_and_skin(seed, jitter):
    """sleeve_mask_from, retain_mask_of (with the palm mask under it) and
    skin_median_color on the port's record and on its JAX-side twin."""
    for rec in (make_person(seed, jitter=jitter),
                make_garment(100 + seed, jitter=jitter)):
        jrec = _jax_record(rec)
        _equal(pp.sleeve_mask_from(rec), jpp.sleeve_mask_from(jrec),
               "sleeve_mask_from")
        _equal(pp.retain_mask_of(rec), jpp.retain_mask_of(jrec),
               "retain_mask_of")
        _equal(pose.get_palm_mask(rec.keypoints, rec.parsing),
               jpose.get_palm_mask(jrec.keypoints, jrec.parsing),
               "get_palm_mask")
        _equal(pp.skin_median_color(rec.image, rec.parsing),
               jpp.skin_median_color(jrec.image, jrec.parsing),
               "skin_median_color")
    no_arm = make_person(seed, jitter=jitter)
    no_arm.keypoints[[3, 6], 2] = 0.05          # elbows lost: empty palms
    _equal(pp.retain_mask_of(no_arm), jpp.retain_mask_of(_jax_record(no_arm)),
           "retain_mask_of[no elbows]")


# ---------------------------------------------------------------------------
# the host functions the training loaders brought along

@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_draw_pose_and_load_keypoints(seed, jitter, tmp_path):
    """The host stick-figure raster: the same cv2 lines and disks, and the
    same in-place invalidation of knees and ankles near the border."""
    import io
    import json

    kp = make_person(seed, jitter=jitter).keypoints
    kp[:, 0] -= 96                       # back to the 512x320 original
    kp[10, 1] = 470.0                    # an ankle near the border
    kp[6, 2] = 0.01                      # a joint below the draw threshold
    for kw in (dict(), dict(img_size=(512, 512), radius=3),
               dict(draw_limbs=False)):
        ka, kb = kp.copy(), kp.copy()
        got, ref = pose.draw_pose(ka, **kw), jpose.draw_pose(kb, **kw)
        _equal(got[0], ref[0], "draw_pose image")
        _equal(ka, kb, "draw_pose mutated keypoints")
        assert got[1] is ka and got[0].any()
    doc = json.dumps({"people": [{"pose_keypoints_2d":
                                  kp.reshape(-1).tolist()}]})
    path = tmp_path / "k_keypoints.json"
    path.write_text(doc)
    for source in (lambda: str(path), lambda: io.StringIO(doc)):
        _equal(pose.load_keypoints(source()), jpose.load_keypoints(source()),
               "load_keypoints")
    empty = json.dumps({"people": []})
    _equal(pose.load_keypoints(io.StringIO(empty)),
           jpose.load_keypoints(io.StringIO(empty)), "load_keypoints[none]")


@pytest.mark.parametrize("center,radius,shape", [
    ((10, 12), 5, (40, 40)), ((0, 0), 5, (40, 40)), ((39.5, 3.2), 4, (40, 20)),
    ((100, 100), 5, (40, 40)), ((20, 20), 0.5, (40, 40))])
def test_disk_coords(center, radius, shape):
    _equal(pose._disk_coords(*center, radius, shape),
           jpose._disk_coords(*center, radius, shape), "_disk_coords")


@pytest.mark.parametrize("seed,jitter", PAIRS)
def test_flip_keypoints_and_pose_params(seed, jitter):
    assert pose.OPENPOSE_FLIP == jpose.OPENPOSE_FLIP
    rec = make_person(seed, jitter=jitter)
    kp = rec.keypoints.copy()
    kp[4, 2] = 0.01                      # an invalid joint keeps its place
    _equal(pose.flip_keypoints(kp, 512), jpose.flip_keypoints(kp, 512),
           "flip_keypoints")
    _equal(host.flip_pose_params(rec.pose_params, 512),
           jcond.flip_pose_params(rec.pose_params, 512), "flip_pose_params")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_perspective_transform_and_crop_matrices(seed):
    rng = np.random.RandomState(seed)
    src = rng.rand(4, 2) * 100
    dst = src + rng.rand(4, 2) * 20
    _equal(geometry.get_perspective_transform(src, dst),
           jgeometry.get_perspective_transform(src, dst),
           "get_perspective_transform")
    kp = make_person(seed, jitter=30.0).keypoints
    kp[[9, 12], 2] = 0.0                 # fallback chains, a part lost
    for part in range(10):
        _equal(geometry.get_crop_matrices(kp, part, 128, 128, 512, 512),
               jgeometry.get_crop_matrices(kp, part, 128, 128, 512, 512),
               f"get_crop_matrices[{part}]")


def test_pad_helpers():
    rng = np.random.RandomState(3)
    for h, w in ((512, 320), (512, 321), (64, 64)):
        assert pp._pad_width(h, w) == jpp._pad_width(h, w)
        left, right = pp._pad_width(h, w)
        for arr in (rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
                    rng.randint(0, 20, (h, w, 1)).astype(np.uint8)):
            _equal(pp._pad_lr(arr, left, right, 255),
                   jpp._pad_lr(arr, left, right, 255), "_pad_lr")
    assert (pp.RES, pp.PATCH) == (jpp.RES, jpp.PATCH)


@pytest.mark.parametrize("k", [5, 8])
def test_erode_and_warp_cv2_branches(k, monkeypatch):
    """`_warp` and `_erode_mask_255` in their cv2 branches, which both
    packages take unless PASTA_USE_NATIVE=1 (tests/test_torch_native.py
    holds the native branches)."""
    monkeypatch.setattr(jpp, "_USE_NATIVE", False)
    monkeypatch.setattr(pp, "_USE_NATIVE", False)
    rng = np.random.RandomState(k)
    mask = (rng.rand(96, 96, 1) > 0.2).astype(np.uint8) * 255
    _equal(pp._erode_mask_255(mask, k), jpp._erode_mask_255(mask, k),
           "_erode_mask_255")
    _equal(pp._erode_mask_255(mask[..., 0], k),
           jpp._erode_mask_255(mask[..., 0], k), "_erode_mask_255[2d]")
    img = rng.randint(0, 255, (96, 96, 3)).astype(np.uint8)
    m = np.array([[1.1, 0.1, -4.0], [-0.05, 0.9, 3.0], [1e-4, 2e-4, 1.0]])
    _equal(pp._warp(img, m, (48, 32)), jpp._warp(img, m, (48, 32)), "_warp")


@pytest.mark.parametrize("seed,jitter", PAIRS[:2])
@pytest.mark.parametrize("mode", ["upper", "lower", "full"])
def test_preprocess_pair_equals_original(seed, jitter, mode):
    """The host-side conditioning of the test modes (the parity path of
    cli/test.py), with and without the sleeve mask: every array equal."""
    person = make_person(seed, jitter=jitter, garment=(mode == "lower"))
    clothes = make_garment(100 + seed, jitter=jitter)
    for sleeve in (True, False):
        got = pp.preprocess_pair(person, clothes, mode,
                                 use_sleeve_mask=sleeve)
        ref = jpp.preprocess_pair(_jax_record(person), _jax_record(clothes),
                                  mode, use_sleeve_mask=sleeve)
        _equal(got, ref, f"preprocess_pair[{mode}, sleeve {sleeve}]")


def test_png_palette_blue():
    """The PLTE walk of _decode_label_plane's palette branch."""
    import io

    import PIL.Image

    idx = np.arange(12, dtype=np.uint8).reshape(3, 4)
    pal = PIL.Image.fromarray(idx, mode="P")
    pal.putpalette([v for i in range(256) for v in (i, 255 - i, i // 3)])
    for img in (pal, PIL.Image.fromarray(idx)):
        buf = io.BytesIO()
        img.save(buf, "PNG")
        _equal(pp._png_palette_blue(buf.getvalue()),
               jpp._png_palette_blue(buf.getvalue()), "_png_palette_blue")
    assert pp._png_palette_blue(b"\x89PNG\r\n\x1a\n") is None
