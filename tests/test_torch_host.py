"""The port's host stage (pasta_tpu_torch/data/host.py) equals the
functions it was carried from, on synthetic records: every output is
`np.array_equal` to the original's."""

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
from pasta_tpu_torch.data.synthetic import make_garment, make_person

# (seed, jitter): small jitter fits the paste tiles, large jitter does not
PAIRS = [(0, 3.0), (2, 30.0), (3, 60.0)]


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
    _equal(got, ref, f"host_prepare[{mode},{cond}]")


def test_host_prepare_without_sleeve_mask():
    person, clothes = make_person(4), make_garment(104)
    _equal(host.host_prepare(person, clothes, "upper", use_sleeve_mask=False,
                             cond="device"),
           jserving.host_prepare(_jax_record(person), _jax_record(clothes),
                                 "upper", use_sleeve_mask=False,
                                 cond="device"),
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


# ---------------------------------------------------------------------------
# the port's own pose / geometry / preprocess modules against the originals

@pytest.mark.parametrize("mod,orig,name", [
    (pose, jpose, "LIMB_SEQ"), (pose, jpose, "KPT_COLORS"),
    (pose, jpose, "JOINT_ORDER"), (geometry, jgeometry, "BODY_PARTS"),
    (geometry, jgeometry, "LOWER_PARTS"),
    (geometry, jgeometry, "SLEEVE_PARTS"), (pp, jpp, "_RETAIN_LUT"),
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
