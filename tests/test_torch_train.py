"""The port's training step (train/steps.py, loss_terms.py, state.py)
against pasta_tpu's, at the smoke config on the CPU.

Smoke config: 64px, channel_base 2048, channel_max 128, batch 2, mbstd
group 2, fp32 D, VGG19 on (weight 20, fp32, seeded random weights),
`use_noise=False` and `augment_p_init=0`: random draws cannot match
between JAX keys and a torch.Generator, and with no noise and every ADA
gate closed (p = 0: the warp matrix is the identity whatever is drawn)
both steps draw nothing that matters. The JAX side runs its two-pass ADA
warp (`ada_impl="twopass"`), the port's only path. The weights are
pasta_tpu's `init_state`, carried into the port by `io/from_jax`.

Tolerances. Losses 1e-3 relative. Gradients 1e-2 of each module's
gradient norm (measured: 2.4e-3 for G, below 3e-4 for the others): the
bf16 two-pass augment rounds at different points in the two frameworks.
(A bf16 VGG input, the preset's, puts G's gradient 1.8e-2 apart, all of
it in the style encoder behind the first VGG conv's bf16 rounding;
tests/test_torch_losses.py holds the bf16 VGG features.) The update rule
(Adam with the lazy-reg scaling, sanitize, EMA, the ADA controller) is
compared on identical gradients at 1e-6. One whole step's metrics (each
phase after the phase before it updated) agree to 1e-2 relative or 2e-3
absolute: the first Adam step with beta1 = 0 moves each weight by about
lr * sign(g), so a gradient near zero turns rounding noise into weight
differences of lr (5e-4), and D's logits see G's updated style code
(measured: real_scores 7e-4 apart).
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from pasta_tpu.losses import vgg as jvgg
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loss_terms as jlt
from pasta_tpu.train import state as jstate
from pasta_tpu.train import steps as jsteps
from pasta_tpu_torch.io.from_jax import (discriminator_jax_to_state_dict,
                                         jax_to_state_dict,
                                         vgg19_jax_to_state_dict)
from pasta_tpu_torch.losses.vgg import VGG19Features
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train import steps as psteps

OVERRIDES = dict(use_noise=False, augment_p_init=0.0, vgg_weight=20.0,
                 vgg_bf16=False)

LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-2
PHASES = ("g", "d", "dp", "d_r1", "dp_r1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers to a machine,
    and their many small ops only wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named_grads(module, grads):
    return {n: g for (n, _), g in zip(module.named_parameters(), grads)}


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **OVERRIDES)
    pcfg = pconfig.smoke_config(1, **OVERRIDES)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    vgg_params = _np_tree(jvgg.VGG19Features().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    return jcfg, pcfg, jst, batch, vgg_params


def _port_state(pcfg, jst, vgg_params):
    """The port's TrainState and VGG19 holding the JAX state's weights."""
    st = pstate.init_state(pcfg, seed=0, device="cpu")
    g_sd = jax_to_state_dict(_np_tree({"params": jst.g_params,
                                       "buffers": jst.g_buffers}))
    st.g.load_state_dict(g_sd, strict=True)
    st.g_ema.load_state_dict(g_sd, strict=True)
    st.d.load_state_dict(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.d_params})), strict=True)
    st.dp.load_state_dict(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.dp_params})), strict=True)
    vgg = VGG19Features(seed=3).requires_grad_(False)
    vgg.load_state_dict(vgg19_jax_to_state_dict(vgg_params), strict=True)
    return st, vgg


@pytest.fixture(scope="module")
def phase_pair(setup):
    """Each phase's (loss, metrics, {name: grad}) from one state, in both
    packages."""
    jcfg, pcfg, jst, batch, vgg_params = setup
    g, d, dp = jstate.make_models(jcfg)
    cores = jlt.build_loss_cores(jcfg, d, dp, vgg_params)
    key = jax.random.PRNGKey(7)
    keys = dict(noise=key, aug1=key, aug2=key, aug3=key)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def g_loss(gp):
        img, ft, pp, gen_c, _ = jsteps._run_g(g, gp, jst.g_buffers, jb, key,
                                              update_w_avg=False)
        return cores["g"]((img, ft, pp, gen_c), jst.d_params, jst.dp_params,
                          jst.ada_p, jb, keys)

    img, ft, pp, gen_c, _ = jax.jit(lambda gp: jsteps._run_g(
        g, gp, jst.g_buffers, jb, key, update_w_avg=False))(jst.g_params)
    soft = jax.nn.softmax(pp, axis=-1)
    fns = dict(
        g=(g_loss, jst.g_params),
        d=(lambda p: cores["d"](p, img, ft, gen_c, jst.ada_p, jb, keys,
                                False), jst.d_params),
        dp=(lambda p: cores["dp"](p, soft, gen_c, jb, False), jst.dp_params),
        d_r1=(lambda p: cores["d_r1"](p, gen_c, jst.ada_p, jb, keys),
              jst.d_params),
        dp_r1=(lambda p: cores["dp_r1"](p, gen_c, jb), jst.dp_params))
    ref = {}
    for name, (fn, params) in fns.items():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
        to_sd = (jax_to_state_dict if name == "g"
                 else discriminator_jax_to_state_dict)
        ref[name] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     {k: v.numpy() for k, v in to_sd(
                         _np_tree({"params": grads})).items()})

    st, vgg = _port_state(pcfg, jst, vgg_params)
    tb = pstate.batch_to(batch, "cpu")
    out = psteps.phase_losses(pcfg, st, tb, torch.Generator().manual_seed(0),
                              vgg)
    modules = dict(g=st.g, d=st.d, dp=st.dp, d_r1=st.d, dp_r1=st.dp)
    got = {name: (float(loss), {k: float(v) for k, v in metrics.items()},
                  {k: v.numpy() for k, v in _named_grads(
                      modules[name], grads).items()})
           for name, (loss, metrics, grads) in out.items()}
    return got, ref


@pytest.mark.parametrize("phase", PHASES)
def test_phase_loss_and_metrics(phase_pair, phase):
    got, ref = phase_pair
    (loss, metrics, _), (jloss, jmetrics, _) = got[phase], ref[phase]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_gradients(phase_pair, phase):
    """Every parameter's gradient is there, and the module's gradient
    agrees in relative L2 norm."""
    got, ref = phase_pair
    grads, jgrads = got[phase][2], ref[phase][2]
    assert set(jgrads) <= set(grads)
    num = sum(float(np.sum((grads[k] - v) ** 2)) for k, v in jgrads.items())
    den = sum(float(np.sum(v ** 2)) for v in jgrads.values())
    assert den > 0
    rel = (num / den) ** 0.5
    assert rel <= GRAD_RTOL, rel
    for k in set(grads) - set(jgrads):      # unused by this phase in both
        assert not np.any(grads[k]), k


def test_update_rule_on_identical_grads(setup):
    """Adam (lazy-reg scaled for D, plain for G), sanitize, EMA and the ADA
    controller against the JAX package on the same gradients: two Adam
    steps, gradients holding nan and +-inf."""
    jcfg, pcfg, _, _, _ = setup
    rng = np.random.RandomState(11)
    shapes = dict(a=(3, 4), b=(5,))
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    grads[0]["a"][0, :3] = [np.nan, np.inf, -np.inf]
    g_tx, d_tx, _ = jstate.make_optimizers(jcfg)
    sanitize = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.nan_to_num(x, nan=0.0, posinf=1e5, neginf=-1e5), t)
    for tx, which in ((g_tx, 0), (d_tx, 1)):
        jp, js = params, tx.init(params)
        module = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params.items()})
        opt = pstate.make_optimizers(pcfg, module, module, module)[which]
        for gr in grads:
            upd, js = tx.update(sanitize(gr), js, jp)
            jp = optax.apply_updates(jp, upd)
            tg = psteps._sanitize([torch.from_numpy(gr[k])
                                   for k in module.keys()])
            psteps.apply_grads(opt, module, tg)
        for k in shapes:
            np.testing.assert_allclose(module[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)

    # EMA and the ADA controller: the JAX phase steps' `post`
    g_new = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def module(tree):
        return torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in tree.items()})

    for rampup in (None, 0.05):
        cfg_j = jconfig.smoke_config(1, ema_rampup=rampup)
        cfg_p = pconfig.smoke_config(1, ema_rampup=rampup)
        post = jsteps._build_phase_fns(cfg_j)["post"]
        for cur_nimg, ada_p, signs in ((0, 0.0, 0.1), (4000, 0.3, 0.9),
                                       (8, 0.3, 0.2), (8, 0.0, 0.6)):
            jst = jstate.TrainState(
                step=jnp.zeros((), jnp.int32),
                cur_nimg=jnp.asarray(cur_nimg, jnp.int32), g_params=g_new,
                g_buffers={}, d_params={}, dp_params={},
                g_ema_params=params, g_ema_buffers={}, g_opt=None,
                d_opt=None, dp_opt=None,
                ada_p=jnp.asarray(ada_p, jnp.float32))
            out = post(jst, jnp.asarray(signs, jnp.float32))
            st = types.SimpleNamespace(g=module(g_new), g_ema=module(params),
                                       cur_nimg=cur_nimg)
            psteps.ema_update(cfg_p, st)
            for k in shapes:
                np.testing.assert_allclose(
                    st.g_ema[k].detach().numpy(),
                    np.asarray(out.g_ema_params[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                psteps.ada_update(cfg_p, ada_p, signs), float(out.ada_p),
                rtol=0, atol=1e-7)


@pytest.mark.parametrize("ranks,batch", [(2, 32), (8, 32), (4, 16)])
def test_data_axis_size_is_accepted(ranks, batch):
    """More than one GPU: the config carries the ranks and each rank's
    rows, as the JAX config's batch_per_device."""
    cfg = pconfig.fashion_config(data_axis_size=ranks, batch_size=batch)
    ref = jconfig.TrainConfig(data_axis_size=ranks, batch_size=batch)
    assert cfg.batch_per_device == ref.batch_per_device == batch // ranks


@pytest.mark.parametrize("ranks,batch", [(3, 32), (8, 4), (0, 4)])
def test_batch_that_does_not_divide_raises(ranks, batch):
    with pytest.raises(ValueError, match="data_axis_size"):
        pconfig.fashion_config(data_axis_size=ranks, batch_size=batch)


@pytest.mark.parametrize("option,value", [
    ("grad_accum", 2), ("reuse_g_fakes", True), ("pl_weight", 2.0),
    ("double_d_parsing", True), ("freeze_d_layers", 1),
    ("contextual_weight", 1.0), ("strict_phase_noise", False)])
def test_ported_options_are_accepted(option, value):
    """The training options are accepted, and the config carries them
    (tests/test_torch_train_options*.py hold each against the JAX step)."""
    cfg = pconfig.fashion_config(**{option: value})
    assert getattr(cfg, option) == value
    assert getattr(pconfig.fashion_config(), option) != value


@pytest.fixture(scope="module")
def step_pair(setup):
    """One whole train_step with both lazy R1 phases, in both packages,
    from the same state and batch."""
    jcfg, pcfg, jst, batch, vgg_params = setup
    jstep = jsteps.make_train_step(jcfg, vgg_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jm = jstep(jst, jb, jax.random.PRNGKey(3), do_r1_d=True,
                     do_r1_dp=True)
    jm = {k: float(v) for k, v in jm.items()}
    st, vgg = _port_state(pcfg, jst, vgg_params)
    step = psteps.make_train_step(pcfg, vgg)
    st, pm = step(st, pstate.batch_to(batch, "cpu"),
                  torch.Generator().manual_seed(3), do_r1_d=True,
                  do_r1_dp=True)
    return st, pm, jnew, jm


def test_train_step_metrics(step_pair):
    st, pm, jnew, jm = step_pair
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], v, rtol=1e-2, atol=2e-3,
                                   err_msg=k)
    assert st.step == int(jnew.step) == 1
    assert st.cur_nimg == int(jnew.cur_nimg)
    np.testing.assert_allclose(st.ada_p, float(jnew.ada_p), atol=1e-9)
