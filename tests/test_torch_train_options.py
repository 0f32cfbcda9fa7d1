"""The training options of the port (train/config.py, state.py, steps.py,
losses/contextual.py, io/) against pasta_tpu's, on the CPU: configuration
A -- grad_accum 2, Gpl (pl_weight 2, g_reg_interval 4, pl_batch_shrink 2),
the contextual loss (weight 1), the doubled parsing-D phase and freeze-D
(5 layers) -- in one whole step with Gpl and both lazy R1 phases; the Gpl
phase alone; the flat .npz both ways with a real pl_mean and freeze-D's
optimizer state; the .pt resume. tests/test_torch_train_options_shared.py
holds the shared fakes (strict_phase_noise=False, reuse_g_fakes).

Setup as tests/test_torch_train.py: 64 px smoke widths, batch 4, mbstd
group 2, fp32 VGG19 (weight 20) on seeded random weights, use_noise=False
and ADA p = 0 (nothing random matters), the JAX side with
ada_impl="twopass". (At 32 px the style encoder's last maps are 1 x 1,
its instance norms zero them, and the D conditioning degenerates to 0,
where both packages' gradients are rounding noise.) Gpl's directions are
the JAX step's own draw (`jax.random.normal` of its key), handed to the
port as `pl_noise`.

Tolerances. Metrics as tests/test_torch_train.py's whole step: 1e-2
relative or 2e-3 absolute. Parameters after the step: 1e-4 of each
module's norm (test_torch_loop.py's budget for G after three steps; Adam
with beta1 = 0 moves a weight by about lr * sign(g), so a gradient near
zero turns rounding into weight differences of lr). The frozen D layers
and their (absent) moments: exactly. w_avg: 1e-4 of its norm (its 512
entries are means of the fp32 style codes); ada_p 1e-9; pl_mean 1e-3
relative, the phase budget of a loss (it is a mean of Gpl's path lengths). The Gpl phase alone: loss and pl_mean 1e-3 relative, gradient
1e-2 of its norm (tests/test_torch_train.py's phase budgets).
"""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.io import npz_ckpt as jnpz
from pasta_tpu.losses import vgg as jvgg
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import state as jstate
from pasta_tpu.train import steps as jsteps
from pasta_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pasta_tpu_torch.io.from_jax import (discriminator_jax_to_state_dict,
                                         jax_to_state_dict,
                                         vgg19_jax_to_state_dict)
from pasta_tpu_torch.io.npz_ckpt import load_npz_state, save_npz_state
from pasta_tpu_torch.losses.vgg import VGG19Features
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train import steps as psteps

COMMON = dict(resolution=64, batch_size=4, use_noise=False,
              augment_p_init=0.0, vgg_weight=20.0, vgg_bf16=False)
OPTIONS_A = dict(grad_accum=2, pl_weight=2.0, contextual_weight=1.0,
                 double_d_parsing=True, freeze_d_layers=5)
PARAM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_state(pcfg, jst, vgg_params):
    """The port's TrainState and VGG19 holding the JAX state's weights and
    pl_mean."""
    st = pstate.init_state(pcfg, seed=0, device="cpu")
    g_sd = jax_to_state_dict(_np_tree({"params": jst.g_params,
                                       "buffers": jst.g_buffers}))
    st.g.load_state_dict(g_sd, strict=True)
    st.g_ema.load_state_dict(g_sd, strict=True)
    st.d.load_state_dict(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.d_params})), strict=True)
    st.dp.load_state_dict(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.dp_params})), strict=True)
    st.pl_mean = torch.tensor(float(jst.pl_mean))
    vgg = VGG19Features(seed=3).requires_grad_(False)
    vgg.load_state_dict(vgg19_jax_to_state_dict(vgg_params), strict=True)
    return st, vgg


def rel_err(got, ref):
    """Relative L2 distance of two {name: array} dicts over ref's keys."""
    num = sum(float(np.sum((np.asarray(got[k]) - v) ** 2))
              for k, v in ref.items())
    den = sum(float(np.sum(np.asarray(v) ** 2)) for v in ref.values())
    return (num / den) ** 0.5


def jax_pl_noise(key, cfg):
    """The directions the JAX step's Gpl phase draws from its step key."""
    bs = cfg.batch_size // cfg.pl_batch_shrink
    ks = jax.random.split(key, 12)
    return np.array(jax.random.normal(
        ks[10], (bs, cfg.resolution, cfg.resolution, 3)))


def pl_loss_fn_of(jstep):
    """The JAX step's own `pl_loss_fn` (a closure of its main step)."""
    main_step = inspect.getclosurevars(jstep).nonlocals["main_step"]
    return inspect.getclosurevars(main_step.__wrapped__).nonlocals[
        "pl_loss_fn"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **COMMON,
                                **OPTIONS_A)
    pcfg = pconfig.smoke_config(1, **COMMON, **OPTIONS_A)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    vgg_params = _np_tree(jvgg.VGG19Features().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    return jcfg, pcfg, jst, batch, vgg_params


@pytest.fixture(scope="module")
def step_a(setup):
    """One whole step of A with Gpl and both lazy R1 phases, in both
    packages, from the same state and batch."""
    jcfg, pcfg, jst, batch, vgg_params = setup
    jstep = jsteps.make_train_step(jcfg, vgg_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    jnew, jm = jstep(jst, jb, key, do_r1_d=True, do_r1_dp=True, do_pl=True)
    st, vgg = port_state(pcfg, jst, vgg_params)
    before = {k: v.clone() for k, v in st.d.state_dict().items()}
    step = psteps.make_train_step(pcfg, vgg)
    st, pm = step(st, pstate.batch_to(batch, "cpu"),
                  torch.Generator().manual_seed(3), do_r1_d=True,
                  do_r1_dp=True, do_pl=True,
                  pl_noise=torch.from_numpy(jax_pl_noise(key, jcfg)))
    return dict(st=st, pm=psteps.fetch_metrics([pm])[0], step=step,
                jnew=jax.device_get(jnew), jstep=jstep, before=before,
                jm={k: float(v) for k, v in jm.items()})


def test_step_metrics(step_a):
    pm, jm = step_a["pm"], step_a["jm"]
    assert {"pl_penalty", "r1_penalty", "dp_r1_penalty"} <= set(jm)
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], v, rtol=1e-2, atol=2e-3,
                                   err_msg=k)
    assert pm["pl_penalty"] > 0


@pytest.mark.parametrize("module", ["g", "d", "dp", "g_ema"])
def test_step_parameters(step_a, module):
    """Every module's parameters after the step (G after Gmain and Gpl, D
    after Dmain and Dr1 with its first layers frozen, the parsing D after
    two DPmain phases and DPr1)."""
    st, jnew = step_a["st"], step_a["jnew"]
    params = {"g": jnew.g_params, "d": jnew.d_params, "dp": jnew.dp_params,
              "g_ema": jnew.g_ema_params}[module]
    to_sd = (jax_to_state_dict if module in ("g", "g_ema")
             else discriminator_jax_to_state_dict)
    ref = {k: v.numpy() for k, v in to_sd(
        _np_tree({"params": params})).items()}
    got = {k: v.detach().numpy() for k, v in
           getattr(st, module).state_dict().items()}
    assert rel_err(got, ref) <= PARAM_RTOL, rel_err(got, ref)


def test_step_scalars_and_w_avg(step_a):
    """w_avg after two microbatches equals the JAX step's mean of the
    updates from the pre-step buffers; ada_p and pl_mean too."""
    st, jnew = step_a["st"], step_a["jnew"]
    w_avg = {"w": np.asarray(jnew.g_buffers["mapping"]["w_avg"])}
    assert np.any(w_avg["w"] != 0)
    for g in (st.g, st.g_ema):
        got = {"w": g.mapping.w_avg.numpy()}
        assert rel_err(got, w_avg) <= 1e-4, rel_err(got, w_avg)
    assert float(jnew.pl_mean) != 0
    np.testing.assert_allclose(float(st.pl_mean), float(jnew.pl_mean),
                               rtol=1e-3)
    np.testing.assert_allclose(float(st.ada_p), float(jnew.ada_p), atol=1e-9)
    assert st.step == int(jnew.step) == 1
    assert st.cur_nimg == int(jnew.cur_nimg) == 4


def test_w_avg_is_not_compounded(setup):
    """grad_accum=2: each microbatch's w_avg update is taken from the
    step's starting value, so w_avg moves as one update from the full
    batch's mean w would move it (the update is linear in that mean)."""
    _, pcfg, jst, batch, vgg_params = setup
    st, vgg = port_state(pcfg, jst, vgg_params)
    tb = pstate.batch_to(batch, "cpu")
    w0 = st.g.mapping.w_avg.clone()
    with torch.no_grad():
        _, _, ws = st.g.style_and_ws(torch.zeros((4, 0)), tb["style_input"],
                                     tb["retain"])
    beta = st.g.mapping.w_avg_beta
    want = ws[:, 0].mean(0) * (1 - beta) + w0 * beta
    psteps.make_train_step(pcfg, vgg)(st, tb, torch.Generator().manual_seed(0))
    torch.testing.assert_close(st.g.mapping.w_avg, want, rtol=1e-5,
                               atol=1e-8)


def test_frozen_layers_untouched(step_a, setup):
    """freeze-D: the first 5 layers of the image D (b64 fromrgb, conv0,
    conv1, skip; b32 conv0) keep their values bit for bit in both packages
    and have no Adam moments; every other parameter moved."""
    jcfg, pcfg, jst, _, _ = setup
    st, before, jnew = step_a["st"], step_a["before"], step_a["jnew"]
    mask = pstate.freeze_d_mask(pcfg, st.d)
    frozen = sorted(k for k, trained in mask.items() if not trained)
    assert {k.rsplit(".", 1)[0] for k in frozen} == {
        "b64.fromrgb", "b64.conv0", "b64.conv1", "b64.skip", "b32.conv0"}
    held = {id(p) for g in st.d_opt.param_groups for p in g["params"]}
    jd = discriminator_jax_to_state_dict(_np_tree({"params": jnew.d_params}))
    jd0 = discriminator_jax_to_state_dict(_np_tree({"params": jst.d_params}))
    for name, p in st.d.named_parameters():
        if mask[name]:
            assert id(p) in held and len(st.d_opt.state[p]) == 3, name
            assert not torch.equal(p.detach(), before[name]), name
        else:
            assert id(p) not in held and p not in st.d_opt.state, name
            assert torch.equal(p.detach(), before[name]), name
            assert torch.equal(jd[name], jd0[name]), name


def test_freeze_mask_equals_jax(setup):
    """The port's mask by name against pasta_tpu's `_freeze_d_mask`, for
    every count of frozen layers up to past the last block."""
    jcfg, pcfg, jst, _, _ = setup
    d = pstate.init_state(pcfg, device="cpu").d
    for n in range(0, 15):
        jmask = jstate._freeze_d_mask(
            jconfig.smoke_config(1, resolution=64, freeze_d_layers=n),
            jst.d_params)
        want = {".".join(str(getattr(k, "key", k)) for k in path): bool(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jmask)[0]}
        got = pstate.freeze_d_mask(
            pconfig.smoke_config(1, resolution=64, freeze_d_layers=n), d)
        assert got == want, n


def test_pl_phase_alone(setup, step_a):
    """Gpl's loss, new pl_mean and gradient from one state with the same
    directions and a pl_mean that is not 0, against the JAX step's own
    pl_loss_fn."""
    jcfg, pcfg, jst, batch, vgg_params = setup
    jst = jst.replace(pl_mean=jnp.asarray(0.37, jnp.float32))
    pl_fn = pl_loss_fn_of(step_a["jstep"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(11)
    (jloss, (jmean, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: pl_fn(p, jst, jb, key, key), has_aux=True))(jst.g_params)
    jgrads = {k: v.numpy() for k, v in jax_to_state_dict(
        _np_tree({"params": jgrads})).items()}
    bs = jcfg.batch_size // jcfg.pl_batch_shrink
    noise = np.array(jax.random.normal(key, (bs, 64, 64, 3)))
    st, vgg = port_state(pcfg, jst, vgg_params)
    out = psteps.phase_losses(pcfg, st, pstate.batch_to(batch, "cpu"),
                              torch.Generator().manual_seed(0), vgg,
                              pl_noise=torch.from_numpy(noise))
    loss, metrics, grads = out["pl"]
    assert float(jloss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    np.testing.assert_allclose(float(metrics["pl_penalty"]),
                               float(jmetrics["pl_penalty"]), rtol=1e-3)
    np.testing.assert_allclose(float(metrics["pl_mean"]), float(jmean),
                               rtol=1e-3)
    got = {n: g.numpy() for (n, _), g in zip(st.g.named_parameters(), grads)}
    assert rel_err(got, jgrads) <= 1e-2, rel_err(got, jgrads)
    # the gradient reaches the mapping (through ws) and the synthesis
    # (through the double backward), and nothing of the texture branch
    assert np.any(got["mapping.fc0.weight"])
    assert np.any(got["synthesis.b64.conv1.weight"])
    assert not np.any(got["synthesis.texture_b512.conv1.weight"])


def test_npz_crosses_with_pl_mean_and_freeze_d(step_a, setup, tmp_path):
    """After the step: the JAX state's flat .npz (multi_transform layout
    for the image D's Adam) loads into the port exactly, and the port's
    written back loads into the JAX state's structure, every leaf equal."""
    jcfg, pcfg, _, _, _ = setup
    jnew = step_a["jnew"]
    path, back = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jnpz.save_npz_variables(path, jnew)
    keys = np.load(path).files
    lead = ".d_opt||.inner_states||train||.inner_state||[0]||"
    assert lead + ".count" in keys
    assert not any(k.startswith(lead + ".mu||b64||") for k in keys)
    fresh = pstate.init_state(pcfg, seed=4, device="cpu")
    load_npz_state(path, fresh)
    assert float(fresh.pl_mean) == float(jnew.pl_mean) != 0
    mu = discriminator_jax_to_state_dict(_np_tree(
        {"params": jnew.d_opt.inner_states["train"].inner_state[0].mu}))
    # optax's masked-out leaves (MaskedNode) convert to empty arrays
    mu = {k: v for k, v in mu.items() if v.numel()}
    assert len(mu) == len(list(fresh.d.parameters())) - 9
    for name, p in fresh.d.named_parameters():
        if name in mu:
            assert torch.equal(fresh.d_opt.state[p]["exp_avg"], mu[name])
            assert float(fresh.d_opt.state[p]["step"]) == 2   # Dmain, Dr1
        else:
            assert p not in fresh.d_opt.state, name
    save_npz_state(back, fresh)
    a, b = np.load(path), np.load(back)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    template = jax.tree.map(np.asarray, jnew)
    restored = jnpz.load_npz_into(back, template)
    for (kp, x), y in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                          jax.tree.leaves(template)):
        assert np.array_equal(np.asarray(x), y), jax.tree_util.keystr(kp)


def test_npz_of_the_stepped_port_state(step_a, setup, tmp_path):
    """The port's own state after the step goes to the JAX layout and
    comes back bit-equal; its moments and counts are the JAX step's."""
    jcfg, pcfg, _, _, _ = setup
    st, jnew = step_a["st"], step_a["jnew"]
    path = str(tmp_path / "port.npz")
    save_npz_state(path, st)
    data = np.load(path)
    assert sorted(data.files) == sorted(
        np.load(_jax_npz(jnew, tmp_path)).files)
    assert float(data[".pl_mean"]) == float(st.pl_mean)
    lead = ".d_opt||.inner_states||train||.inner_state||[0]||"
    assert int(data[lead + ".count"]) == 2
    assert int(data[".g_opt||[0]||.count"]) == 2              # Gmain, Gpl
    assert int(data[".dp_opt||[0]||.count"]) == 3         # DPmain x2, DPr1
    other = pstate.init_state(pcfg, seed=6, device="cpu")
    load_npz_state(path, other)
    _assert_states_equal(other, st)


def _jax_npz(jst, tmp_path):
    path = str(tmp_path / "ref.npz")
    jnpz.save_npz_variables(path, jst)
    return path


def _tensors(state):
    out = {}
    for name in ("g", "d", "dp", "g_ema"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v
    for name, module in (("g_opt", state.g), ("d_opt", state.d),
                         ("dp_opt", state.dp)):
        opt = getattr(state, name)
        for pname, p in module.named_parameters():
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{pname}.{k}"] = v
    out.update(ada_p=state.ada_p, pl_mean=state.pl_mean)
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert (a.step, a.cur_nimg) == (b.step, b.cur_nimg)


def test_pt_resume_with_gpl_is_bit_equal(step_a, setup, tmp_path):
    """A .pt of the stepped state restores it bit for bit, pl_mean and
    freeze-D's Adam included, and the next Gpl step of the restored state
    is the unbroken run's."""
    _, pcfg, _, batch, _ = setup
    st, step = step_a["st"], step_a["step"]
    path = str(tmp_path / "ckpt-000001.pt")
    save_checkpoint(path, st)
    other = pstate.init_state(pcfg, seed=8, device="cpu")
    load_checkpoint(path, other)
    _assert_states_equal(other, st)
    tb = pstate.batch_to(batch, "cpu")
    outs = [step(s, tb, torch.Generator().manual_seed(1), do_pl=True)[1]
            for s in (other, st)]
    _assert_states_equal(other, st)
    a, b = psteps.fetch_metrics(outs)
    assert a == b and a["pl_penalty"] > 0
