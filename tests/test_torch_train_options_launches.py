"""The launches of K1, K2 and K3 that chip_smoke.py expects of one step of
each training configuration (`STEP_LAUNCHES`, `SYNTHESIS_RUNS`), counted
on the CPU.

Each kernel wrapper counts a launch only on the card; here the wrappers
are made to take their CUDA route with the plain versions in the kernels'
place, so that they count what the card would launch. The step runs at
32 px with channel_base 2048 (the fashion preset otherwise, batch 4):
there the image D's and G's top two resolutions have 64 and 128 channels,
as at 512 px with channel_base 32768, so the same convs lie in K1's scope
(the default preset's counts are those measured on the card, 69 / 37 / 4 /
2 a step). Exact.
"""

import importlib.util
import pathlib

import pytest
import torch

from pasta_tpu_torch.cli import bench_train
from pasta_tpu_torch.ops import affine_warp, conv3x3
from pasta_tpu_torch.train.config import fashion_config

_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def counted_on_the_cpu(monkeypatch):
    """The wrappers' CUDA route, with the plain versions in the kernels'
    place; one torch thread."""
    monkeypatch.setattr(conv3x3, "_plain_route", lambda x: False)
    monkeypatch.setattr(conv3x3, "_kernel",
                        lambda x, w, out_w, pad=0:
                        conv3x3.conv3x3_valid_plain(x, w, out_w, pad))

    def shift(name, a, q, start, f, v_dim, out_w):
        if name == "shift_fwd":
            return affine_warp.shift_fwd_plain(a, q, out_w)
        return affine_warp.shift_bwd_plain(a, q, v_dim)

    monkeypatch.setattr(affine_warp, "_plain_route", lambda x: False)
    monkeypatch.setattr(affine_warp, "_kernel", shift)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    bench_train.reset_kernel_counts()


LAZY = {"regular": {}, "r1": dict(do_r1_d=True, do_r1_dp=True),
        "pl": dict(do_pl=True),
        "pl_r1": dict(do_pl=True, do_r1_d=True, do_r1_dp=True)}


@pytest.mark.parametrize("name", ["default", "A", "B", "B reuse", "C"])
def test_step_launches(smoke, name):
    cfg = fashion_config(resolution=32, channel_base=2048,
                         batch_size=smoke.TRAIN_BATCH,
                         **smoke.OPTIONS.get(name, {}))
    state, step, batch, gen = bench_train.setup(cfg, "cpu")
    runs = []
    state.g.synthesis.register_forward_hook(lambda *_: runs.append(1))
    kinds = [kind for (cfg_name, kind) in smoke.STEP_LAUNCHES
             if cfg_name == name]
    assert kinds
    for kind in kinds:
        bench_train.reset_kernel_counts()
        runs.clear()
        step(state, batch, gen, **LAZY[kind])
        got = bench_train.kernel_counts() + (
            conv3x3.conv3x3_valid.launches_fp32,)
        assert got == smoke.STEP_LAUNCHES[name, kind], kind
        if kind == "regular" and name in smoke.SYNTHESIS_RUNS:
            assert len(runs) == smoke.SYNTHESIS_RUNS[name]
