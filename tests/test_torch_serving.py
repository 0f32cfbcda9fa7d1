"""The whole serving slice on the CPU: synthetic records -> host_prepare
(cond="device") -> ingest_device -> assemble_inputs_device -> Generator at
img_resolution=512, against the JAX package's TryonPipeline on the same
weights.

The generator is the narrow 512px config (channel_base=2048,
channel_max=128), fp32, noise_mode="const". Its weights are made on the
port side from a seed and carried into JAX with `import_generator_state`
(JAX's own init of this config costs ~30 s here; tests/test_torch_weights.py
covers that direction).

Tolerances: the assembled generator inputs match to 1e-4 (exact masks and
rasters; bilinear warps agree to float rounding). The finetune image
routes its SPADE branch on an argmax of parsing logits that can flip where
two logits tie within fp32 conv noise, so it is held to a budget: 2% of
values off by more than 1e-2 of the image's range, and a mean absolute
difference under 1e-3 of that range.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu import serving as jserving
from pasta_tpu.data import device_warp as jwarp
from pasta_tpu.data.preprocess import PersonRecord as JaxPersonRecord
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch import serving
from pasta_tpu_torch.data.synthetic import make_garment, make_person
from pasta_tpu_torch.models import Generator

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_record(rec):
    """The port's PersonRecord as the JAX package's own class, field by
    field, for the calls that cross to `pasta_tpu`."""
    return JaxPersonRecord(**{f.name: getattr(rec, f.name)
                              for f in dataclasses.fields(rec)})


def _items(mode, specs):
    return [serving.host_prepare(
        make_person(s, jitter=j, garment=(mode == "lower")),
        make_garment(100 + s, jitter=j), mode, cond="device")
        for s, j in specs]


def _stack(items, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(np.stack([it[k] for it in items])) for k in items[0]
            if k != "tiles_fit"}


def _jax_cut_windows(items):
    """The cut windows of the JAX package's windowed path, which the port's
    items do not carry, from its own layout function: the [B, 15, 2]
    offsets and whether every item's cut quads fit."""
    layouts = [jwarp.part_layouts_for_pair(
        it["upper_cut_m"], it["lower_cut_m"], it["paste_m_inv"],
        it["part_valid"]) for it in items]
    return (jnp.asarray(np.stack([lay[2] for lay in layouts])),
            all(lay[3] for lay in layouts))


@pytest.mark.parametrize("mode,specs,cut_windowed", [
    ("upper", [(0, 3.0)], False),                # tiled paste path
    ("upper", [(0, 3.0), (2, 30.0)], False),     # one quad misfits: full path
    ("lower", [(1, 3.0)], False),
    ("full", [(3, 3.0)], False),
    # what the JAX run_batch selects when every cut quad also fits: its
    # gather warps ignore the cut windows, so the port's one tiled path
    # must still match
    ("upper", [(0, 3.0)], True),
    ("lower", [(1, 3.0)], True),
])
def test_assemble_matches_jax(mode, specs, cut_windowed):
    items = _items(mode, specs)
    tiled = all(bool(it["tiles_fit"]) for it in items)
    assert tiled == (len(specs) == 1)
    jbatch = _stack(items, "jax")
    if cut_windowed:
        jbatch["cut_window_offsets"], fits = _jax_cut_windows(items)
        assert fits
    got = serving.assemble_inputs_device(
        serving.ingest_device(_stack(items, "torch")), mode, tiled=tiled)
    ref = jax.jit(lambda b: jserving.assemble_inputs_device(
        jserving.ingest_device(b), mode, tiled=tiled,
        cut_windowed=cut_windowed))(jbatch)
    assert sorted(got) == sorted(ref)
    assert float(got["denorm_upper_mask"].sum()) > 0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_pipeline_matches_jax():
    torch.manual_seed(0)
    model = Generator(seed=0, **NARROW).eval()
    variables = import_generator_state(state_dict_to_numpy(model))
    items = _items("upper", [(0, 3.0)])

    pipe = serving.TryonPipeline(model, mode="upper")
    got = pipe.run_batch(items).numpy()
    assert pipe.last_tiled
    ref = np.asarray(jserving.TryonPipeline(
        variables, mode="upper", model=JaxGenerator(**NARROW),
        noise_mode="const", cond="device").run_batch(items))

    assert got.shape == ref.shape == (1, 512, 512, 3)
    assert np.all(np.isfinite(got))
    span = ref.max() - ref.min()
    diff = np.abs(got - ref)
    assert np.mean(diff > 1e-2 * span) <= 2e-2
    assert diff.mean() <= 1e-3 * span, diff.mean()


def test_pipeline_scope():
    """The pipeline prepares cond="device" items: raw parsing planes and
    pose scalars for the device, not host-drawn conditioning rasters."""
    model = Generator(seed=0, img_resolution=64, channel_base=256,
                      channel_max=16)
    pipe = serving.TryonPipeline(model, mode="upper")
    got = pipe.prepare(make_person(0, jitter=3.0),
                       make_garment(100, jitter=3.0))
    ref = jserving.host_prepare(
        _jax_record(make_person(0, jitter=3.0)),
        _jax_record(make_garment(100, jitter=3.0)), "upper", cond="device")
    # the JAX item's cut windows serve only its matmul warps
    assert sorted(got) == sorted(set(ref) - {"cut_window_offsets",
                                             "cut_fits"})
    assert "parsing" in got and "pose" not in got


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import pasta_tpu_torch.serving, pasta_tpu_torch.models\n"
            "import pasta_tpu_torch.io.from_jax, pasta_tpu_torch.data.synthetic\n"
            "import pasta_tpu_torch.cli.profile_serving\n"
            "import pasta_tpu_torch.cli.bench_train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'pasta_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_profile_busy_union():
    """The profile tool's device-busy time is the union of kernel
    intervals: overlaps count once, gaps not at all."""
    from pasta_tpu_torch.cli.profile_serving import busy_us

    assert busy_us([]) == 0
    assert busy_us([(10, 20), (0, 5), (15, 30), (30, 31), (40, 41)]) == 27
