"""The matmul warps on the port's device paths against pasta_tpu's, on the
CPU: `normalize_patches_device[_tiled]` with warp_impl "matmul" and
"matmul_bf16", with and without the cut windows; the impl resolution and
the mask thresholds (`TryonPipeline.run_batch` and
`assemble_train_batch_lean` with "matmul" at 512 px:
tests/test_torch_matmul_paths.py).

Inputs: the synthetic records of `pasta_tpu_torch.data.synthetic` (two
persons whose quads fit the paste tiles and the cut windows), prepared by
the port's `host_prepare` (cond="device") for both packages; the
normalize tests shrink their geometry to a quarter (`_shrunk`). The JAX
side is jitted but for "matmul_bf16", which runs op by op (`_run_jax`).

Tolerances. The warped images (the cut patches and the composites) within
1e-3 of the 0..255 range on every pixel but those of the composite masks
that flip; the masks equal on all but 0.1% of the pixels (an eroded warped
mask's edge pixel can land on either side of its threshold when the
products sum in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.data import device_warp as jdw
from pasta_tpu_torch import serving
from pasta_tpu_torch.data import device_warp as tdw
from pasta_tpu_torch.data.host import (CUT_WINDOW, PASTE_TILE,
                                      host_prepare)
from pasta_tpu_torch.data.preprocess import PATCH
from pasta_tpu_torch.data.synthetic import make_garment, make_person

IMG_TOL = 1e-3 * 255.0
MASK_BUDGET = 1e-3
SHRINK = 4
ARGS = ("upper_img", "lower_img", "upper_mask", "lower_mask", "sleeve",
        "upper_cut_m", "lower_cut_m", "paste_m_inv", "part_valid")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _items(mode="upper"):
    return [host_prepare(make_person(s, jitter=j), make_garment(100 + s),
                         mode, cond="device")
            for s, j in ((0, 3.0), (1, 10.0))]


@pytest.fixture(scope="module")
def ingested():
    items = _items()
    assert all(bool(it["tiles_fit"]) and bool(it["cut_fits"])
               for it in items)
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in items[0] if k not in ("tiles_fit", "cut_fits")}
    return {k: v.numpy() for k, v in serving.ingest_device(batch).items()}


def _shrunk(ing):
    """The batch's geometry at a quarter of its size: 128 px canvases,
    32 px patches, 64 px paste tiles and 80 px cut windows. Every
    homography is conjugated by the scale, so that each quad keeps its
    place (the one-hot weights grow with the cube of the size; the warps'
    arithmetic does not change with it)."""
    out = dict(ing)
    for k in ("upper_img", "lower_img", "upper_mask", "lower_mask",
              "sleeve"):
        out[k] = np.ascontiguousarray(ing[k][:, 1::SHRINK, 1::SHRINK])
    d = np.diag([1.0 / SHRINK, 1.0 / SHRINK, 1.0])
    u = np.diag([float(SHRINK), float(SHRINK), 1.0])
    for k in ("upper_cut_m", "lower_cut_m", "paste_m_inv"):
        out[k] = (d @ ing[k].astype(np.float64) @ u).astype(np.float32)
    for k in ("tile_offsets", "cut_window_offsets"):
        out[k] = (ing[k] // SHRINK).astype(np.int32)
    return out


def _run_jax(impl, fn, *args):
    """The JAX function of `impl`: jitted for "matmul"; op by op for
    "matmul_bf16", whose einsum then rounds the one-hot weights to bf16 and
    multiplies in fp32, as the port does (jitted, XLA's CPU dot takes the
    bf16 operand as it is and rounds the image too: 1e-3 of its values)."""
    return (fn if impl == "matmul_bf16" else jax.jit(fn))(*args)


def _compare(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        bad = np.any(np.abs(g - r) > IMG_TOL, axis=-1)
        if k.startswith("norm_img"):         # the cuts: no threshold
            assert not bad.any(), (k, np.abs(g - r).max())
        else:
            assert np.mean(bad) <= MASK_BUDGET, (k, np.mean(bad))


@pytest.mark.parametrize("impl,path", [
    ("matmul", "full"), ("matmul", "tiled"), ("matmul", "windowed"),
    # the tiled path without windows is the matmul case's; op-by-op JAX
    # (see _run_jax) costs seconds a case
    ("matmul_bf16", "full"), ("matmul_bf16", "windowed")])
def test_normalize_patches(ingested, impl, path):
    small = _shrunk(ingested)
    args = [small[k] for k in ARGS]
    kw = dict(erode_k=3, track_wo_sleeve=True, warp_impl=impl,
              patch=PATCH // SHRINK)
    sv = small["sleeve_valid"]
    if path == "full":
        got = tdw.normalize_patches_device(
            *map(torch.from_numpy, args), **kw,
            sleeve_valid=torch.from_numpy(sv))
        ref = _run_jax(impl, lambda a, sv: jdw.normalize_patches_device(
            *a, **kw, sleeve_valid=sv), list(map(jnp.asarray, args)),
            jnp.asarray(sv))
    else:
        extra = dict(tile=PASTE_TILE // SHRINK)
        if path == "windowed":
            extra.update(cut_window_offsets=small["cut_window_offsets"],
                         cut_window=CUT_WINDOW // SHRINK)
        got = tdw.normalize_patches_device_tiled(
            *map(torch.from_numpy, args),
            torch.from_numpy(small["tile_offsets"]), **kw,
            sleeve_valid=torch.from_numpy(sv),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in extra.items()})
        arrays = {k: jnp.asarray(v) for k, v in extra.items()
                  if isinstance(v, np.ndarray)}
        static = {k: v for k, v in extra.items() if k not in arrays}
        ref = _run_jax(
            impl, lambda a, sv, arr: jdw.normalize_patches_device_tiled(
                *a, **kw, **static, sleeve_valid=sv, **arr),
            list(map(jnp.asarray, args + [small["tile_offsets"]])),
            jnp.asarray(sv), arrays)
    assert float(got["denorm_upper_img"].sum()) > 0
    _compare(got, ref)


def test_impl_resolution_and_thresholds():
    """'auto' is the gather off the TPU, in both packages; the threshold
    follows the resolved impl; a windowed gather equals the plain one."""
    for impl in ("auto", "gather", "matmul", "matmul_bf16"):
        assert tdw.resolve_warp_impl(impl) == jdw.resolve_warp_impl(impl)
        r = tdw.resolve_warp_impl(impl)
        assert tdw._mask_thresh(r) == jdw._mask_thresh(r)
    with pytest.raises(ValueError, match="warp_impl"):
        tdw.resolve_warp_impl("nearest")


def test_gather_ignores_the_windows(ingested):
    args = [torch.from_numpy(ingested[k]) for k in ARGS]
    tiles = torch.from_numpy(ingested["tile_offsets"])
    plain = tdw.normalize_patches_device_tiled(*args, tiles, erode_k=5)
    windowed = tdw.normalize_patches_device_tiled(
        *args, tiles, erode_k=5, warp_impl="gather",
        cut_window_offsets=torch.from_numpy(ingested["cut_window_offsets"]),
        cut_window=CUT_WINDOW)
    for k in plain:
        assert torch.equal(plain[k], windowed[k]), k
