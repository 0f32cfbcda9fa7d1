"""The port's training loop against pasta_tpu's with ADA on, on the CPU.

As tests/test_torch_loop.py (one crossed state, one synthetic root, the
smoke config, no noise, one loader thread, one tick a step), but with
`augment_p_init = 1` and both packages' `augment_pipe` given the
reference's `debug_percentile` (0.35: a quarter turn, an integer and a
fractional translation, a scale, a rotation by -0.3 pi, brightness,
contrast, hue and saturation), so every draw is the same constant in both
and the two-pass geometric stage shifts rows by real offsets inside the
steps. `d_reg_interval = 1`: both steps carry the lazy R1 phases, whose
double backward goes through the augment. The JAX side runs
`ada_impl="twopass"`, the port's only warp.

Tolerances as in test_torch_loop.py: the first row 1e-2 relative or 2e-3
absolute, the second 5e-2 relative or 5e-2 absolute (measured worst:
d_loss 1.0e-2, real_scores 8.1e-3 apart); G's final parameters to 1e-4 of
their norm (measured 2.5e-6).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax

import pasta_tpu.native as jnative
from pasta_tpu.data import trainsets as jts
from pasta_tpu.io import npz_ckpt as jnpz
from pasta_tpu.train import augment as jaugment
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loop as jloop
from pasta_tpu.train import loss_terms as jloss_terms
from pasta_tpu.train import state as jstate
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.io import from_jax
from pasta_tpu_torch.train import augment as paugment
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import loop as ploop
from pasta_tpu_torch.train import loss_terms as ploss_terms

OVERRIDES = dict(use_noise=False, augment_p_init=1.0, d_reg_interval=1)
STEPS = 2
PERCENTILE = 0.35


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    base = tmp_path_factory.mktemp("runs_ada")
    root = str(base / "root")
    write_dataset_root(root, 6, 80)
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **OVERRIDES)
    pcfg = pconfig.smoke_config(1, **OVERRIDES)
    npz = str(base / "init.npz")
    jnpz.save_npz_variables(npz, jax.device_get(
        jstate.init_state(jcfg, jax.random.PRNGKey(0))))
    kw = dict(resume_path=npz, total_steps=STEPS, tick_interval=1,
              snapshot_ticks=100, num_workers=1, seed=0)
    jdir, pdir = str(base / "jax"), str(base / "port")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(jloss_terms, "augment_pipe", functools.partial(
            jaugment.augment_pipe, debug_percentile=PERCENTILE))
        mp.setattr(ploss_terms, "augment_pipe", functools.partial(
            paugment.augment_pipe, debug_percentile=PERCENTILE))
        jfinal = jloop.training_loop(
            jcfg, jts.TryonTrainDataset(root, seed=0, resolution=64), jdir,
            **kw)
        pfinal = ploop.training_loop(
            pcfg, ts.TryonTrainDataset(root, seed=0, resolution=64), pdir,
            device="cpu", **kw)
    torch.set_num_threads(n_threads)
    return jax.device_get(jfinal), pfinal, jdir, pdir


def _rows(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_stats_rows_agree_with_ada_on(loops):
    _, _, jdir, pdir = loops
    jrows, prows = _rows(jdir), _rows(pdir)
    assert len(jrows) == len(prows) == STEPS
    for i, (jr, pr) in enumerate(zip(jrows, prows)):
        assert set(jr) <= set(pr) and pr["step"] == jr["step"] == i + 1
        tol = dict(rtol=1e-2, atol=2e-3) if i == 0 else dict(rtol=5e-2,
                                                             atol=5e-2)
        for name, val in jr.items():
            if isinstance(val, dict):
                assert np.isfinite(pr[name]["mean"]), name
                np.testing.assert_allclose(
                    pr[name]["mean"], val["mean"],
                    err_msg=f"step {i + 1} {name}", **tol)
        assert pr["r1_penalty"]["mean"] > 0 and pr["dp_r1_penalty"]["mean"] > 0
    # the controller holds p at 1 (real_signs above the target) in both
    assert [r["ada_p"]["mean"] for r in prows] == \
        [r["ada_p"]["mean"] for r in jrows] == [1.0, 1.0]


def test_final_generator_agrees_with_ada_on(loops):
    jfinal, pfinal, _, _ = loops
    assert pfinal.step == int(jfinal.step) == STEPS
    assert float(pfinal.ada_p) == float(jfinal.ada_p)
    ref = from_jax.jax_to_state_dict(jax.tree.map(
        np.asarray, {"params": jfinal.g_params,
                     "buffers": jfinal.g_buffers}))
    sd = pfinal.g.state_dict()
    num = sum(float((sd[k] - v).square().sum()) for k, v in ref.items())
    den = sum(float(v.square().sum()) for v in ref.values())
    assert (num / den) ** 0.5 <= 1e-4, (num / den) ** 0.5


def test_debug_percentile_really_warps():
    """At p = 1 with the percentile the augment is far from the identity
    (so the loops above did run the geometric stage on real offsets)."""
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    out = paugment.augment_pipe(x, 1.0, torch.Generator().manual_seed(0),
                                paugment.AugmentConfig.bgc(),
                                debug_percentile=PERCENTILE)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float((out - x).abs().mean()) > 0.1
    # and a tensor p on the images' device is read without a host sync
    same = paugment.augment_pipe(x, torch.tensor(1.0),
                                 torch.Generator().manual_seed(0),
                                 paugment.AugmentConfig.bgc(),
                                 debug_percentile=PERCENTILE)
    assert torch.equal(out, same)
