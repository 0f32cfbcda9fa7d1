"""The port's dataset roots, file loaders, sampler and CIHP helpers
(pasta_tpu_torch/data/roots.py, preprocess.py::load_person / flip_person,
sampler.py, cihp.py, synthetic.py::write_dataset_root) against pasta_tpu's
on one synthetic root written under tmp_path, as a directory and as a zip.

Everything here is integer or file work, so every comparison is exact
(`np.array_equal`), apart from `cords_to_map` (float32 exponentials of the
same numpy expression: equal too). Both packages decode through their
compiled `native` plugins where those are built; the tests switch both
plugins off (`available` patched to return False), so that both packages
take their PIL / cv2 branches here. tests/test_torch_native.py holds the
plugins' branches.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

import pasta_tpu.native as jnative
import pasta_tpu_torch.native as pnative
from pasta_tpu.data import cihp as jcihp
from pasta_tpu.data import preprocess as jpp
from pasta_tpu.data import roots as jroots
from pasta_tpu.data.sampler import infinite_sampler as jsampler
from pasta_tpu_torch.data import cihp, roots
from pasta_tpu_torch.data import preprocess as pp
from pasta_tpu_torch.data.sampler import infinite_sampler
from pasta_tpu_torch.data.synthetic import (LEFT, ORIG_W, make_garment,
                                            write_dataset_root)

N = 3
SEED = 40


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    d, z = str(base / "root"), str(base / "root.zip")
    names = write_dataset_root(d, N, SEED)
    assert write_dataset_root(z, N, SEED, as_zip=True) == names
    return {"dir": d, "zip": z}, names


def _records_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f"{what}.{f.name}"
        elif isinstance(x, dict):
            assert sorted(x) == sorted(y), f"{what}.{f.name}"
            for k in x:
                assert np.array_equal(x[k], y[k]), f"{what}.{f.name}[{k}]"
        elif isinstance(x, str):
            assert x == y, f"{what}.{f.name}"
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                f"{what}.{f.name}"


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_root_list_exists_read_decode(written, kind):
    paths, names = written
    root, jroot = roots.as_root(paths[kind]), jroots.as_root(paths[kind])
    assert root.is_zip == jroot.is_zip == (kind == "zip")
    for sub in ("image", "keypoints", "parsing", "garment_parsing", "nope"):
        assert root.list(sub) == jroot.list(sub), sub
    assert root.list("image") == names
    stem = names[0][:-4]
    for rel in (f"image/{names[0]}", f"keypoints/{stem}_keypoints.json",
                f"parsing/{stem}.png", "dataset.json"):
        assert root.exists(rel) and jroot.exists(rel), rel
        assert root.read(rel) == jroot.read(rel), rel
        assert root.open(rel).read() == root.read(rel)
    assert not root.exists("image/missing.png")
    assert not jroot.exists("image/missing.png")
    with pytest.raises(FileNotFoundError):
        root.read("image/missing.png")
    img = root.decode_image(f"image/{names[0]}")
    assert img.shape == (512, ORIG_W, 3) and img.dtype == np.uint8
    assert np.array_equal(img, jroot.decode_image(f"image/{names[0]}"))
    assert np.array_equal(root.decode_cv2(f"image/{names[0]}"),
                          jroot.decode_cv2(f"image/{names[0]}"))
    manifest = json.loads(root.read("dataset.json"))
    assert manifest["count"] == N
    assert [m["name"] for m in manifest["images"]] == names
    assert roots.as_root(root) is root
    assert repr(root) == repr(jroot).replace("pasta_tpu.", "pasta_tpu_torch.")


def test_missing_zip_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        roots.DataRoot(str(tmp_path / "absent.zip"))


@pytest.mark.parametrize("kind", ["dir", "zip"])
@pytest.mark.parametrize("pose_raster", ["host", "device"])
@pytest.mark.parametrize("garment", [True, False])
def test_load_person_equals_original(written, kind, pose_raster, garment):
    paths, names = written
    for name in names:
        got = pp.load_person(paths[kind], name, with_garment_parsing=garment,
                             pose_raster=pose_raster)
        ref = jpp.load_person(paths[kind], name,
                              with_garment_parsing=garment,
                              pose_raster=pose_raster)
        _records_equal(got, ref, f"load_person[{name}]")
        assert (got.pose_img is None) == (pose_raster == "device")
        assert (got.garment_parsing is None) == (not garment)


def test_load_person_gives_back_the_written_record(written):
    """The files hold the records `make_garment` draws: the device-raster
    loader returns them field for field (the PNG decode is exact)."""
    paths, names = written
    for i, name in enumerate(names):
        drawn = make_garment(SEED + i)
        for kind in ("dir", "zip"):
            got = pp.load_person(paths[kind], name,
                                 with_garment_parsing=True,
                                 pose_raster="device")
            assert got.name == name
            _records_equal(dataclasses.replace(got, name=drawn.name), drawn,
                           f"written[{name},{kind}]")
    assert LEFT == (512 - ORIG_W) // 2


@pytest.mark.parametrize("pose_raster", ["host", "device"])
def test_flip_person_equals_original(written, pose_raster):
    paths, names = written
    for name in names:
        rec = pp.load_person(paths["dir"], name, with_garment_parsing=True,
                             pose_raster=pose_raster)
        jrec = jpp.load_person(paths["dir"], name, with_garment_parsing=True,
                               pose_raster=pose_raster)
        got, ref = pp.flip_person(rec), jpp.flip_person(jrec)
        _records_equal(got, ref, f"flip_person[{name}]")
        assert got.name == name + "_xflip"
        assert np.array_equal(got.image, rec.image[:, ::-1])


@pytest.mark.parametrize("seed,rank,num_replicas,skip_first", [
    (0, 0, 1, 0), (3, 1, 2, 0), (7, 2, 4, 5)])
def test_sampler_stream_equals_original(seed, rank, num_replicas, skip_first):
    kw = dict(rank=rank, num_replicas=num_replicas, seed=seed,
              skip_first=skip_first)
    got = list(itertools.islice(infinite_sampler(37, **kw), 200))
    ref = list(itertools.islice(jsampler(37, **kw), 200))
    assert got == ref
    assert min(got) >= skip_first and max(got) < 37
    plain = list(itertools.islice(
        infinite_sampler(5, shuffle=False), 12))
    assert plain == [0, 1, 2, 3, 4] * 2 + [0, 1]


def test_cihp_helpers_equal_original():
    rng = np.random.RandomState(6)
    parsing = rng.randint(0, 20, (2, 24, 16))
    assert np.array_equal(cihp.CIHP_COLORMAP, jcihp.CIHP_COLORMAP)
    assert np.array_equal(cihp.flip_cihp(parsing), jcihp.flip_cihp(parsing))
    assert np.array_equal(cihp.parsing2im(parsing[0]),
                          jcihp.parsing2im(parsing[0]))
    wide = rng.randint(-3, 30, (24, 16))          # clipped into the palette
    assert np.array_equal(cihp.parsing2im(wide), jcihp.parsing2im(wide))
    onehot = cihp.label2onehot(parsing)
    assert tuple(onehot.shape) == (2, 24, 16, 20)
    assert np.array_equal(onehot.numpy(),
                          np.asarray(jcihp.label2onehot(parsing)))
    cords = np.array([[8.0, 10.0, 0.9], [3.0, 4.0, 0.05], [-1.0, 5.0, 0.9]])
    for fn, jfn in ((cihp.cords_to_map, jcihp.cords_to_map),
                    (cihp.get_pose_heatmaps, jcihp.get_pose_heatmaps)):
        got, ref = fn(cords, (24, 16), 3), jfn(cords, (24, 16), 3)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
