"""The serving path's device-resident constants (`data/device_cond.py::
resident`): the colour tables of `draw_pose_device`, the warps' source
selectors and the lower-part index, each made once a device and the same
tensor at every later call, each equal to what the code uploaded at every
call before, and `draw_pose_device` and `normalize_patches_device(_tiled)`
giving on fixed inputs exactly what they give with a fresh upload of each
constant at every call and the lower parts taken by list indexing (two
synthetic persons, the normalize geometry at a quarter of its size). Their
values against the JAX package are `test_torch_device_cond.py`'s and
`test_torch_device_warp.py`'s."""

import numpy as np
import pytest
import torch

from pasta_tpu_torch import serving
from pasta_tpu_torch.data import device_cond as dc
from pasta_tpu_torch.data import device_warp as dw
from pasta_tpu_torch.data.geometry import LOWER_PARTS
from pasta_tpu_torch.data.host import PASTE_TILE, host_prepare
from pasta_tpu_torch.data.synthetic import make_garment, make_person

SHRINK = 4
ARGS = ("upper_img", "lower_img", "upper_mask", "lower_mask", "sleeve",
        "upper_cut_m", "lower_cut_m", "paste_m_inv", "part_valid")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    items = [host_prepare(make_person(s, jitter=j), make_garment(100 + s),
                          "upper", cond="device")
             for s, j in ((0, 3.0), (1, 10.0))]
    return {k: torch.from_numpy(np.stack([it[k] for it in items]))
            for k in items[0] if k != "tiles_fit"}


@pytest.fixture(scope="module")
def shrunk(batch):
    """The ingested batch's geometry at a quarter of its size: 128 px
    canvases, 32 px patches, 64 px paste tiles, each homography conjugated
    by the scale."""
    ing = serving.ingest_device(batch)
    out = dict(ing)
    for k in ("upper_img", "lower_img", "upper_mask", "lower_mask",
              "sleeve"):
        out[k] = ing[k][:, 1::SHRINK, 1::SHRINK].contiguous()
    d = torch.diag(torch.tensor([1.0 / SHRINK, 1.0 / SHRINK, 1.0],
                                dtype=torch.float64))
    u = torch.diag(torch.tensor([float(SHRINK), float(SHRINK), 1.0],
                                dtype=torch.float64))
    for k in ("upper_cut_m", "lower_cut_m", "paste_m_inv"):
        out[k] = (d @ ing[k].double() @ u).float()
    out["tile_offsets"] = torch.div(ing["tile_offsets"], SHRINK,
                                    rounding_mode="floor").int()
    return out


def _normalize(small, path):
    args = [small[k] for k in ARGS]
    kw = dict(erode_k=3, track_wo_sleeve=True, patch=128 // SHRINK,
              sleeve_valid=small["sleeve_valid"])
    if path == "full":
        return dw.normalize_patches_device(*args, **kw)
    return dw.normalize_patches_device_tiled(
        *args, small["tile_offsets"], tile=PASTE_TILE // SHRINK, **kw)


def test_a_constant_is_made_once_a_device():
    """`resident` calls `make` once for a (name, device) and hands back
    that tensor after, a normal one even when first made under
    inference_mode (autograd may save it)."""
    made = []

    def make():
        made.append(1)
        return torch.arange(3)

    with torch.inference_mode():
        first = dc.resident("made_once", "cpu", make)
    assert dc.resident("made_once", torch.device("cpu"), make) is first
    assert len(made) == 1 and not first.is_inference()
    assert torch.equal(first, torch.arange(3))


@pytest.fixture
def uploads(monkeypatch):
    """Inside the block the device helpers run as they did when each call
    uploaded its constants: `resident` makes a fresh tensor every time and
    the lower parts are taken with the list of their indices."""
    def fresh(name, device, make):
        return make().to(device)

    monkeypatch.setattr(dc, "resident", fresh)
    monkeypatch.setattr(dw, "resident", fresh)
    monkeypatch.setattr(dw, "_lower", lambda x: x[:, list(LOWER_PARTS)])


@pytest.mark.parametrize("shape", [(2, 15, 3, 3), (3, 15, 3)])
def test_lower_parts_by_index_as_by_list(shape):
    """`_lower` picks LOWER_PARTS along dim 1 as the list indexing did,
    through one index tensor kept for the device."""
    x = torch.randn(shape)
    assert torch.equal(dw._lower(x), x[:, list(LOWER_PARTS)])
    kept = dc._RESIDENT[("lower_parts", torch.device("cpu"))]
    assert torch.equal(kept, torch.tensor(LOWER_PARTS))
    assert torch.equal(dw._lower(x[:1]), x[:1, list(LOWER_PARTS)])
    assert dc._RESIDENT[("lower_parts", torch.device("cpu"))] is kept


def test_pose_as_with_fresh_tables_and_its_tables_kept(batch, request):
    """draw_pose_device's raster equals the one drawn with its colour
    tables uploaded anew, and the kept tables are those colours; the
    second call makes no table."""
    args = [batch[k] for k in ("limb_pts", "limb_valid", "joint_pts",
                               "joint_valid", "pose_xlim")]
    pose = dc.draw_pose_device(*args)
    cpu = torch.device("cpu")
    tables = {name: dc._RESIDENT[(name, cpu)]
              for name in ("limb_colors", "joint_colors")}
    assert torch.equal(tables["limb_colors"],
                       torch.from_numpy(dc._LIMB_COLORS))
    assert torch.equal(tables["joint_colors"],
                       torch.from_numpy(dc._JOINT_COLORS))
    kept = {k: id(v) for k, v in dc._RESIDENT.items()}
    assert torch.equal(dc.draw_pose_device(*args), pose)
    assert {k: id(v) for k, v in dc._RESIDENT.items()} == kept
    request.getfixturevalue("uploads")
    assert torch.equal(dc.draw_pose_device(*args), pose)


@pytest.mark.parametrize("path", ["full", "tiled"])
def test_normalize_as_with_fresh_indices_and_they_are_kept(
        shrunk, path, request):
    """normalize_patches_device(_tiled)'s outputs, bit for bit, as with
    every index uploaded anew and the lower parts taken by list; the
    lower-part index and the cut and paste selectors stay from the first
    call on, each the array it stands for: a second call makes none."""
    got = _normalize(shrunk, path)
    cpu = torch.device("cpu")
    assert ("lower_parts", cpu) in dc._RESIDENT
    selectors = {name: t for (name, dev), t in dc._RESIDENT.items()
                 if name[0] == "src_idx" and dev == cpu}
    assert len(selectors) >= 2
    assert all(torch.equal(t, torch.as_tensor(np.asarray(name[1:])))
               for name, t in selectors.items())
    kept = {k: id(v) for k, v in dc._RESIDENT.items()}
    again = _normalize(shrunk, path)
    assert {k: id(v) for k, v in dc._RESIDENT.items()} == kept
    assert all(torch.equal(again[k], got[k]) for k in got)
    request.getfixturevalue("uploads")
    before = _normalize(shrunk, path)
    assert got.keys() == before.keys()
    assert all(torch.equal(got[k], before[k]) for k in got)
