"""The port's training dataset and its two device assemblers
(pasta_tpu_torch/data/trainsets.py, preprocess.py::normalize_patches)
against pasta_tpu's, on one synthetic root written under tmp_path.

Host side (numpy and cv2 in both packages, the same draws from equally
seeded RandomStates): every array is `np.array_equal`. The JAX package's
compiled `native` decoder is switched off (`pasta_tpu.native.available`
patched to False), so both decode with PIL / cv2.

`assemble_train_batch` on a uint8 raw batch: exact against the host
stacker, 2 ulp against the jitted JAX assembler. `assemble_train_batch_
lean` at 512 px against the JAX one (`warp_impl="gather"`, the port's only
warp): masks, gt parsing, the label and bound planes and `real_img` exact;
the float planes that go through the bilinear warps and the pose raster
within 1e-3 of the 0..255 scale (2/127.5 * 1e-3 after the scaling to
[-1, 1]) on all but 1e-4 of the pixels, the budget
tests/test_torch_device_warp.py grants the same warps (an eroded mask's
edge pixel can land on either side of its threshold).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pasta_tpu.native as jnative
from pasta_tpu.data import preprocess as jpp
from pasta_tpu.data import trainsets as jts
from pasta_tpu_torch.data import preprocess as pp
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import write_dataset_root

N = 4
SEED = 60


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trainsets") / "root")
    names = write_dataset_root(path, N, SEED)
    return path, names


class _FakeRng:
    """Deterministic stand-in for np.random.RandomState (as in
    tests/test_train_lean.py): rand() pops from a queue (then repeats the
    last value), randint likewise."""

    def __init__(self, rands, randints=(5,)):
        self._rands = list(rands)
        self._randints = list(randints)

    def rand(self):
        return self._rands.pop(0) if len(self._rands) > 1 else self._rands[0]

    def randint(self, a, b=None, size=None):
        return (self._randints.pop(0) if len(self._randints) > 1
                else self._randints[0])


def _equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, str):
            assert x == y, f"{what}[{k}]"
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}[{k}]"
        assert np.array_equal(x, y), f"{what}[{k}]"


def _load(path, name, **kw):
    return (pp.load_person(path, name, with_garment_parsing=True, **kw),
            jpp.load_person(path, name, with_garment_parsing=True, **kw))


def _garment_streams(mod, rec):
    cls = mod.garment_class_masks(rec.parsing)
    upper = cls["tops"] + cls["dresses"]
    lower = cls["skirt"] + cls["pants"]
    return (upper * rec.image, lower * rec.image,
            np.repeat(upper, 3, axis=2) * 255,
            np.repeat(lower, 3, axis=2) * 255, mod.sleeve_mask_from(rec))


@pytest.mark.parametrize("erasure", [None, "a", "b", "off"])
def test_normalize_patches_equals_original(root, erasure):
    path, names = root
    rec, jrec = _load(path, names[0])
    draws = {None: None, "a": ([0.1, 0.1, 0.1], [5]),
             "b": ([0.1, 0.7], [100]), "off": ([0.9], [5])}[erasure]
    kw = dict(erode_k=5, return_transforms=True)
    out = []
    for mod, r in ((pp, rec), (jpp, jrec)):
        rng = _FakeRng(*draws) if draws else None
        out.append(mod.normalize_patches(
            *_garment_streams(mod, r), upper_cut_kps=r.keypoints,
            lower_cut_kps=r.keypoints, paste_kps=r.keypoints,
            train_erasure_rng=rng, **kw))
    got, ref = out
    _equal(got, ref, f"normalize_patches[{erasure}]")
    assert got["norm_img"].shape == (128, 128, 30)
    assert got["Ms"].shape == (10, 3, 3)
    assert ("norm_img_lower_for_train" in got) == (erasure is not None)
    if erasure == "a":        # the torso patch and 5 rows of two more go
        erased = got["norm_img_lower_for_train"]
        assert not erased[..., 0:3].any()
        assert not erased[:5, :, 3:6].any() and not erased[:5, :, 9:12].any()
    if erasure == "off":
        assert np.array_equal(got["norm_img_lower_for_train"],
                              got["norm_img_lower"])


def test_normalize_patches_test_mode_options(root):
    """`track_wo_sleeve` and `zero_lower_under_upper` (the serving modes'
    options) with clothes' keypoints for the cuts, sleeve mask absent."""
    path, names = root
    (a, ja), (b, jb) = _load(path, names[0]), _load(path, names[1])
    out = []
    for mod, person, clothes in ((pp, a, b), (jpp, ja, jb)):
        streams = _garment_streams(mod, clothes)[:4] + (None,)
        out.append(mod.normalize_patches(
            *streams, upper_cut_kps=clothes.keypoints,
            lower_cut_kps=person.keypoints, paste_kps=person.keypoints,
            erode_k=8, track_wo_sleeve=True, zero_lower_under_upper=True))
    _equal(out[0], out[1], "normalize_patches[upper mode]")
    assert "denorm_upper_img_wo_sleeve" in out[0]


def test_garment_masks_skin_map_and_crop_matrices(root):
    path, names = root
    from pasta_tpu.data import geometry as jgeometry
    from pasta_tpu_torch.data import geometry
    for name in names[:2]:
        rec, jrec = _load(path, name)
        _equal(pp.garment_class_masks(rec.parsing),
               jpp.garment_class_masks(jrec.parsing), "garment_class_masks")
        got = pp.skin_average_map(rec.image, rec.parsing)
        ref = jpp.skin_average_map(jrec.image, jrec.parsing)
        assert got.shape == (512, 512, 3) and np.array_equal(got, ref)
        for part in range(10):
            g = geometry.get_crop_matrices(rec.keypoints, part, 128, 128,
                                           512, 512)
            r = jgeometry.get_crop_matrices(jrec.keypoints, part, 128, 128,
                                            512, 512)
            for x, y in zip(g, r):
                assert (x is None and y is None) or (
                    x.dtype == y.dtype and np.array_equal(x, y)), part


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_person_train_equals_original(root, seed):
    path, names = root
    rec, jrec = _load(path, names[seed % N])
    got = ts.preprocess_person_train(rec, np.random.RandomState(seed))
    ref = jts.preprocess_person_train(jrec, np.random.RandomState(seed))
    _equal(got, ref, "preprocess_person_train")
    small, jsmall = ts._resize_item(got, 64), jts._resize_item(ref, 64)
    _equal(small, jsmall, "_resize_item")
    assert small["image"].shape == (64, 64, 3)
    assert small["norm_img"].shape == (16, 16, 30)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_person_train_lean_equals_original(root, seed):
    path, names = root
    rec, jrec = _load(path, names[seed % N], pose_raster="device")
    got = ts.preprocess_person_train_lean(rec, np.random.RandomState(seed))
    ref = jts.preprocess_person_train_lean(jrec, np.random.RandomState(seed))
    _equal(got, ref, "preprocess_person_train_lean")
    with pytest.raises(AssertionError, match="pose_raster"):
        ts.preprocess_person_train_lean(_load(path, names[0])[0],
                                        np.random.RandomState(0))


def test_occlusion_masks_equal_original():
    for seed in range(6):
        a = ts.draw_occlusion_mask(np.random.RandomState(seed))
        b = jts.draw_occlusion_mask(np.random.RandomState(seed))
        assert a.dtype == b.dtype and np.array_equal(a, b)
        c = ts.synthesize_occlusion_mask(np.random.RandomState(seed), 256)
        d = jts.synthesize_occlusion_mask(np.random.RandomState(seed), 256)
        assert c.shape == (256, 256, 1) and np.array_equal(c, d)


@pytest.fixture(scope="module")
def datasets(root):
    path, names = root
    mk = lambda mod, **kw: mod.TryonTrainDataset(path, seed=3, **kw)
    return {kind: (mk(ts, **kw), mk(jts, **kw)) for kind, kw in dict(
        host={}, small=dict(resolution=64),
        lean=dict(loader_impl="device")).items()}


def test_dataset_items_equal_original(datasets):
    for kind in ("host", "small"):
        ds, jds = datasets[kind]
        assert len(ds) == len(jds) == N
        assert ds.image_names == jds.image_names
        for i in (2, 0):
            _equal(ds[i], jds[i], f"dataset[{kind}][{i}]")
    ds, jds = datasets["lean"]
    for i in (1, 3):
        _equal(ds.lean_item(i), jds.lean_item(i), f"lean_item[{i}]")
    with pytest.raises(AssertionError):
        ts.TryonTrainDataset(datasets["host"][0].root, resolution=64,
                             loader_impl="device")


def test_infinite_batches_equal_original(root):
    path, _ = root
    ds = ts.TryonTrainDataset(path, seed=9, resolution=64)
    jds = jts.TryonTrainDataset(path, seed=9, resolution=64)
    for _, got, ref in zip(range(2), ds.infinite_batches(2),
                           jds.infinite_batches(2)):
        assert [g["person_name"] for g in got] == \
            [r["person_name"] for r in ref]
        for g, r in zip(got, ref):
            _equal(g, r, "infinite_batches")


def test_batch_stackers_equal_original(datasets):
    ds, jds = datasets["small"]
    items = [ds[i] for i in range(2)]
    jitems = [jds[i] for i in range(2)]
    _equal(ts.batch_to_train_inputs(items),
           jts.batch_to_train_inputs(jitems), "batch_to_train_inputs")
    _equal(ts.batch_to_raw_inputs(items), jts.batch_to_raw_inputs(jitems),
           "batch_to_raw_inputs")
    lean, jlean = datasets["lean"]
    got = ts.batch_to_lean_inputs([lean.lean_item(i) for i in range(2)])
    ref = jts.batch_to_lean_inputs([jlean.lean_item(i) for i in range(2)])
    _equal(got[0], ref[0], "batch_to_lean_inputs")
    assert got[1:] == ref[1:]
    assert isinstance(got[1], bool) and isinstance(got[2], bool)


@pytest.mark.parametrize("kind", ["host", "small"])
def test_assemble_train_batch_exact(datasets, kind):
    """uint8 raw batch -> step inputs: bit for bit the host stacker's
    numbers at 512 px (where nothing is resized through float; numpy and
    torch both divide), and the jitted JAX assembler's to 2 ulp of 1.0
    (XLA multiplies by the reciprocal of 127.5 where the others divide)."""
    ds, _ = datasets[kind]
    items = [ds[i] for i in range(2)]
    raw = ts.batch_to_raw_inputs(items)
    got = ts.assemble_train_batch(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    ref = jax.jit(jts.assemble_train_batch)(
        {k: jnp.asarray(v) for k, v in raw.items()})
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=2.4e-7, err_msg=k)
    if kind == "host":
        host = ts.batch_to_train_inputs(items)
        for k in host:
            np.testing.assert_array_equal(got[k].numpy(), host[k], k)


# erasure branch -> the five draws of the lean loader (gate, branch, strip
# gate, the strip's uniform, then the occlusion gate: 0.95 = none)
LEAN_DRAWS = {
    "none": ([0.9], [5]),
    "a": ([0.1, 0.1, 0.1, 0.5, 0.95], [5]),
    "b": ([0.1, 0.7, 0.5, 0.03, 0.95], [5]),
    "occluded": ([0.9, 0.9, 0.9, 0.9, 0.5, 0.3], [2, 200, 300, 60, 90]),
}

_EXACT = ("real_img", "gt_parsing", "denorm_upper_mask", "denorm_lower_mask")
_jax_lean = jax.jit(jts.assemble_train_batch_lean,
                    static_argnames=("tiled", "cut_windowed", "warp_impl"))


@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("branch", sorted(LEAN_DRAWS))
def test_assemble_train_batch_lean_vs_jax(root, branch, tiled):
    path, names = root
    if branch == "occluded":
        rng = np.random.RandomState(4)      # real draws, occlusion blobs
    else:
        rng = _FakeRng(*LEAN_DRAWS[branch])
    items = []
    for i, name in enumerate(names[:2]):
        rec = pp.load_person(path, name, with_garment_parsing=(i == 0),
                             pose_raster="device")
        if i == 1:
            rec = pp.flip_person(rec)
        items.append(ts.preprocess_person_train_lean(rec, rng))
    batch, fits, windowed = ts.batch_to_lean_inputs(items)
    assert fits, "the synthetic figures fit the paste tiles"
    got = ts.assemble_train_batch_lean(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tiled=tiled)
    ref = _jax_lean({k: jnp.asarray(v) for k, v in batch.items()},
                    tiled=tiled, cut_windowed=False, warp_impl="gather")
    assert sorted(got) == sorted(ref)
    tol = 2 / 127.5 * 1e-3
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        bad = np.mean(np.any(np.abs(g - r) > tol, axis=-1))
        if k in _EXACT:
            # the masks follow the composites' edge pixels
            assert bad <= (1e-4 if k.endswith("_mask") else 0), (k, bad)
        else:
            assert bad <= 1e-4, (k, bad)
    np.testing.assert_array_equal(got["pose"][..., 3:].numpy(),
                                  np.asarray(ref["pose"][..., 3:]))
    style = got["style_input"].numpy()
    if branch == "a":          # the rigged draws reach the first item
        assert np.all(style[0, ..., 30:33] == -1.0)
        assert np.all(style[0, :5, :, 33:36] == -1.0)
    elif branch == "none":
        assert np.any(style[..., 30:33] > -1.0)
    elif branch == "b":
        rows = np.all(style[0, :, :, 30:33] == -1.0, axis=(1, 2))
        assert rows.any() and not rows.all()
    else:
        occ = batch["occlusion"].astype(bool)[..., 0]
        assert occ.any()
        assert np.all(got["denorm_upper_input"].numpy()[occ] == -1.0)


def test_lean_against_host_loader_with_equal_draws(root):
    """The device assembler against the host loader's batch of the same
    person with the draws held equal (nothing erased, nothing occluded):
    the budgets of tests/test_train_lean.py::_compare."""
    path, names = root
    rec, _ = _load(path, names[2])
    lean_rec, _ = _load(path, names[2], pose_raster="device")
    host_item = ts.preprocess_person_train(rec, _FakeRng([0.9]))
    lean_item = ts.preprocess_person_train_lean(lean_rec, _FakeRng([0.9]))
    host_out = {k: v.numpy() for k, v in ts.assemble_train_batch({
        k: torch.from_numpy(v)
        for k, v in ts.batch_to_raw_inputs([host_item]).items()}).items()}
    batch, tiled, _ = ts.batch_to_lean_inputs([lean_item])
    lean_out = {k: v.numpy() for k, v in ts.assemble_train_batch_lean(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tiled=tiled).items()}
    assert set(host_out) == set(lean_out)
    for k in ("real_img", "gt_parsing"):
        np.testing.assert_allclose(lean_out[k], host_out[k], atol=1e-5)
    np.testing.assert_allclose(lean_out["pose"][..., 3:],
                               host_out["pose"][..., 3:], atol=1e-5)
    assert np.mean(np.abs(lean_out["pose"][..., :3]
                          - host_out["pose"][..., :3]) > 1e-3) < 2e-3
    assert np.mean(np.abs(lean_out["retain"] - host_out["retain"])
                   > 1e-3) < 1e-3
    for k in ("style_input", "denorm_upper_input", "denorm_lower_input"):
        assert np.mean(np.abs(lean_out[k] - host_out[k]) > 0.02) < 0.03, k
    for k in ("denorm_upper_mask", "denorm_lower_mask"):
        assert np.mean(np.abs(lean_out[k] - host_out[k]) > 0) < 0.005, k


def test_max_size_and_xflip_bookkeeping(root):
    path, names = root
    for kw in (dict(max_size=2), dict(max_size=3, random_seed=5),
               dict(xflip=True), dict(max_size=2, xflip=True),
               dict(max_size=10)):
        ds = ts.TryonTrainDataset(path, **kw)
        jds = jts.TryonTrainDataset(path, **kw)
        assert len(ds) == len(jds)
        assert np.array_equal(ds._raw_idx, jds._raw_idx), kw
        assert np.array_equal(ds._xflip, jds._xflip), kw
    sub = ts.TryonTrainDataset(path, max_size=2)
    assert len(sub) == 2
    assert sorted(sub._raw_idx.tolist()) == sub._raw_idx.tolist()
    mir = ts.TryonTrainDataset(path, image_names=names[:3], xflip=True)
    jmir = jts.TryonTrainDataset(path, image_names=names[:3], xflip=True)
    assert len(mir) == 6
    item, flipped = mir[0], mir[3]
    assert np.array_equal(item["image"][:, ::-1], flipped["image"])
    assert flipped["person_name"] == names[0] + "_xflip"
    jmir[0]
    _equal(flipped, jmir[3], "xflip item")
    lean = ts.TryonTrainDataset(path, image_names=names[:3], xflip=True,
                                loader_impl="device")
    assert np.array_equal(lean.lean_item(0)["image"][:, ::-1],
                          lean.lean_item(3)["image"])
