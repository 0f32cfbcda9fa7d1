"""Parts of the port's training options against pasta_tpu's, on the CPU:
the contextual loss (losses/contextual.py) on seeded features and seeded
VGG19 weights, and the training loop's lazy-phase cadence -- which steps
run the R1 phases and which run Gpl -- with both loops driven by a stub
step, so that no step is compiled.

Tolerances. The contextual distance and loss, fp32 in both packages:
values 1e-5 relative, gradients 1e-4 of their norm. The cadence: exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.losses import contextual as jctx
from pasta_tpu.losses import vgg as jvgg
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loop as jloop
from pasta_tpu.train import state as jstate
from pasta_tpu_torch.io.from_jax import vgg19_jax_to_state_dict
from pasta_tpu_torch.losses import contextual as pctx
from pasta_tpu_torch.losses.vgg import VGG19Features
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import loop as ploop


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("shape,h", [((2, 6, 5, 16), 0.5),
                                     ((1, 8, 8, 32), 0.1)])
def test_contextual_distance(shape, h):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    y = (x + 2.0 * rng.randn(*shape)).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda a: jctx.contextual_distance(a, jnp.asarray(y), h=h))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    val = pctx.contextual_distance(xt, torch.from_numpy(y), h=h)
    (grad,) = torch.autograd.grad(val, xt)
    assert float(jval) > 0
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert _rel(grad.numpy(), np.asarray(jgrad)) <= 1e-4


@pytest.mark.parametrize("max_spatial", [64, 4])
def test_contextual_loss(max_spatial):
    """relu3_1 and relu4_1 of a seeded VGG19 at 32 px (8 x 8 and 4 x 4
    maps); max_spatial 4 pools relu3_1 once. The target carries no
    gradient."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jvgg.VGG19Features().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    jval, (jgx, jgy) = jax.value_and_grad(
        lambda a, b: jctx.contextual_loss(params, a, b,
                                          max_spatial=max_spatial),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    vgg = VGG19Features(seed=3).requires_grad_(False)
    vgg.load_state_dict(vgg19_jax_to_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    val = pctx.contextual_loss(vgg, xt, yt, max_spatial=max_spatial)
    gx, gy = torch.autograd.grad(val, (xt, yt), allow_unused=True)
    assert not np.any(np.asarray(jgy)) and gy is None
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert _rel(gx.numpy(), np.asarray(jgx)) <= 1e-4


class _StubLoader:
    """Yields the same tiny batch forever."""

    def __init__(self, *args, **kw):
        self.batch = {"real_img": np.zeros((2, 4, 4, 3), np.float32)}

    def __iter__(self):
        while True:
            yield dict(self.batch)

    def close(self):
        pass


def _jax_cadence(cfg, steps, run_dir, mp):
    """(do_r1_d, do_pl) of each step of pasta_tpu's training_loop."""
    seen = []

    def make_step(cfg, **kw):
        def step(state, batch, key, do_r1_d=False, do_r1_dp=False,
                 do_pl=False):
            assert do_r1_dp == do_r1_d
            seen.append((do_r1_d, do_pl))
            return state, {"g_loss": 0.0, "d_loss": 0.0, "ada_p": 0.0}
        return step

    zero = jnp.zeros((), jnp.int32)
    state = jstate.TrainState(
        step=zero, cur_nimg=zero, g_params={}, g_buffers={}, d_params={},
        dp_params={}, g_ema_params={}, g_ema_buffers={}, g_opt=None,
        d_opt=None, dp_opt=None, ada_p=jnp.zeros(()))
    mp.setattr(jloop, "init_state", lambda cfg, key: state)
    mp.setattr(jloop, "make_train_step", make_step)
    mp.setattr(jloop, "ParallelLoader", _StubLoader)
    mp.setattr(jloop, "assemble_train_batch", lambda b: b)
    mp.setattr(jloop, "_save_snapshot", lambda *a, **k: None)
    mp.setattr("pasta_tpu.summary.summarize_state", lambda s: None)
    jloop.training_loop(cfg, object(), run_dir, total_steps=steps,
                        tick_interval=steps, num_workers=1)
    return seen


def _port_cadence(cfg, steps, run_dir, mp):
    """(do_r1_d, do_pl) of each step of the port's training_loop."""
    seen = []

    def make_step(cfg, vgg=None):
        def step(state, batch, generator, do_r1_d=False, do_r1_dp=False,
                 do_pl=False):
            assert do_r1_dp == do_r1_d
            seen.append((do_r1_d, do_pl))
            state.step += 1
            return state, {"g_loss": torch.zeros(()),
                           "d_loss": torch.zeros(()), "ada_p": 0.0}
        return step

    mp.setattr(ploop, "make_train_step", make_step)
    mp.setattr(ploop, "ParallelLoader", _StubLoader)
    mp.setattr(ploop, "assemble_train_batch", lambda b: b)
    mp.setattr(ploop, "_save_snapshot", lambda *a, **k: None)
    ploop.training_loop(cfg, object(), run_dir, total_steps=steps,
                        tick_interval=steps, num_workers=1, device="cpu")
    return seen


@pytest.mark.parametrize("opts", [
    dict(pl_weight=2.0, d_reg_interval=3),
    dict(pl_weight=2.0, g_reg_interval=3, r1_gamma=0.0),
    dict(d_reg_interval=2)])
def test_lazy_phase_cadence(opts, tmp_path):
    """Eight steps: both loops run R1 every d_reg_interval steps and Gpl
    every g_reg_interval steps from step 0, each only where its weight is
    not 0, as the JAX loop's formula says."""
    steps = 8
    with pytest.MonkeyPatch.context() as mp:
        got = _port_cadence(pconfig.smoke_config(1, **opts), steps,
                            str(tmp_path / "port"), mp)
    with pytest.MonkeyPatch.context() as mp:
        ref = _jax_cadence(jconfig.smoke_config(1, **opts), steps,
                           str(tmp_path / "jax"), mp)
    cfg = pconfig.smoke_config(1, **opts)
    formula = [(cfg.r1_gamma != 0 and s % cfg.d_reg_interval == 0,
                cfg.pl_weight != 0 and s % cfg.g_reg_interval == 0)
               for s in range(steps)]
    assert got == ref == formula
    assert got == [ploop.lazy_phases(cfg, s) for s in range(steps)]
    assert any(pl for _, pl in got) == (cfg.pl_weight != 0)
