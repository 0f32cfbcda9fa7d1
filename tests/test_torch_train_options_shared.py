"""The shared fakes of the port's train step (strict_phase_noise=False,
with and without reuse_g_fakes) against pasta_tpu's, on the CPU.

Configuration B: one no-grad forward of the updated G feeds Dmain and the
parsing D (here with the doubled parsing-D phase, so both DPmain phases
see the same fakes); B with reuse: Gmain's own detached fakes feed them,
and no further forward runs. Each runs one whole step with both lazy R1
phases in both packages from one state, at the setup and the tolerances
of tests/test_torch_train_options.py. The R1 phases take the conditioning
of the fakes the D phases saw: with reuse that of the pre-update G.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.losses import vgg as jvgg
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import state as jstate
from pasta_tpu.train import steps as jsteps
from pasta_tpu_torch.io.from_jax import (discriminator_jax_to_state_dict,
                                         jax_to_state_dict)
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train import steps as psteps
from test_torch_train_options import (COMMON, PARAM_RTOL, _np_tree,
                                      port_state, rel_err)

CONFIGS = {
    "shared": dict(strict_phase_noise=False, double_d_parsing=True),
    "reuse": dict(strict_phase_noise=False, reuse_g_fakes=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg_params():
    return _np_tree(jvgg.VGG19Features().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))


def _spy_cores(monkeypatch, seen):
    """Record the conditioning each lazy R1 core is handed."""
    build = psteps.build_loss_cores

    def spied(*args, **kw):
        cores = build(*args, **kw)
        d_r1, dp_r1 = cores["d_r1"], cores["dp_r1"]

        def d_r1_spy(gen_c, *rest):
            seen["d_r1"] = gen_c.clone()
            return d_r1(gen_c, *rest)

        def dp_r1_spy(gen_c, *rest):
            seen["dp_r1"] = gen_c.clone()
            return dp_r1(gen_c, *rest)

        return dict(cores, d_r1=d_r1_spy, dp_r1=dp_r1_spy)

    monkeypatch.setattr(psteps, "build_loss_cores", spied)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, vgg_params):
    """One whole step of the configuration with both lazy R1 phases, in
    both packages; the port's with the G draws counted (each run of the
    synthesis network) and the R1 phases' conditioning recorded, beside
    the style codes of G before and after the step."""
    opts = CONFIGS[request.param]
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **COMMON, **opts)
    pcfg = pconfig.smoke_config(1, **COMMON, **opts)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jm = jsteps.make_train_step(jcfg, vgg_params)(
        jst, jb, jax.random.PRNGKey(3), do_r1_d=True, do_r1_dp=True)
    st, vgg = port_state(pcfg, jst, vgg_params)
    tb = pstate.batch_to(batch, "cpu")
    code = lambda: st.g.style_code(tb["style_input"], tb["retain"]).detach()
    pre = code()
    draws, seen = [], {}
    hook = st.g.synthesis.register_forward_hook(
        lambda *_: draws.append(1))
    with pytest.MonkeyPatch.context() as mp:
        _spy_cores(mp, seen)
        st, pm = psteps.make_train_step(pcfg, vgg)(
            st, tb, torch.Generator().manual_seed(3), do_r1_d=True,
            do_r1_dp=True)
    hook.remove()
    return dict(name=request.param, st=st, jnew=jax.device_get(jnew),
                pm=psteps.fetch_metrics([pm])[0], draws=len(draws),
                jm={k: float(v) for k, v in jm.items()}, seen=seen,
                pre=pre, post=code())


def test_step_metrics(pair):
    pm, jm = pair["pm"], pair["jm"]
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], v, rtol=1e-2, atol=2e-3,
                                   err_msg=k)


def test_step_parameters_and_scalars(pair):
    st, jnew = pair["st"], pair["jnew"]
    for module, params in (("g", jnew.g_params), ("g_ema",
                                                  jnew.g_ema_params),
                           ("d", jnew.d_params), ("dp", jnew.dp_params)):
        to_sd = (jax_to_state_dict if module in ("g", "g_ema")
                 else discriminator_jax_to_state_dict)
        ref = {k: v.numpy() for k, v in to_sd(
            _np_tree({"params": params})).items()}
        got = {k: v.detach().numpy() for k, v in
               getattr(st, module).state_dict().items()}
        assert rel_err(got, ref) <= PARAM_RTOL, (module, rel_err(got, ref))
    w_avg = {"w": np.asarray(jnew.g_buffers["mapping"]["w_avg"])}
    assert rel_err({"w": st.g.mapping.w_avg.numpy()}, w_avg) <= 1e-4
    np.testing.assert_allclose(float(st.ada_p), float(jnew.ada_p), atol=1e-9)
    assert st.step == int(jnew.step) == 1


def test_g_draws_per_step(pair):
    """Runs of the synthesis network in one step: Gmain's, and the shared
    forward unless Gmain's fakes are reused (the strict path draws three:
    Gmain, Dmain's forward, DPmain's style branch)."""
    assert pair["draws"] == {"shared": 2, "reuse": 1}[pair["name"]]


def test_r1_conditioning(pair):
    """With reuse the R1 phases take the style code of the pre-update G
    (Gmain's fakes); with the shared forward that of the updated G."""
    want = pair["pre"] if pair["name"] == "reuse" else pair["post"]
    other = pair["post"] if pair["name"] == "reuse" else pair["pre"]
    assert not torch.equal(pair["pre"], pair["post"])
    for phase in ("d_r1", "dp_r1"):
        got = pair["seen"][phase]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not torch.equal(got, other), phase
