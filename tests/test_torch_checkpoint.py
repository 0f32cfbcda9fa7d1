"""The port's checkpoints (pasta_tpu_torch/io/checkpoint.py, npz_ckpt.py
and the way back in io/from_jax.py), on the CPU at the smoke config with
`use_noise=False` and ADA's p at 0 (nothing random matters).

* `.pt`: save -> load into a differently seeded state is bit-equal in every
  parameter, buffer, Adam moment and scalar, and the next step from the
  loaded state equals the unbroken run's bit for bit (one torch thread).
* Flat `.npz`, the JAX package's `TrainState` keys: a JAX state after two
  steps, written by `pasta_tpu.io.npz_ckpt.save_npz_variables`, goes into
  the port (`load_npz_state`), back out (`save_npz_state`) and into JAX
  again (`load_npz_into`) with every leaf unchanged (exact: the crossing
  only renames, transposes and permutes). One further step of each package
  from that state agrees in its metrics to tests/test_torch_train.py's
  step tolerance (1e-2 relative or 2e-3 absolute), and G's parameters
  after it to 1e-3 of their norm (measured: 2e-5).
* `state_dict_to_jax` / `discriminator_state_dict_to_jax` are held equal to
  `pasta_tpu/io/torch_import.py`, which they copy.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.io import npz_ckpt as jnpz
from pasta_tpu.io import torch_import as jimport
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import state as jstate
from pasta_tpu.train import steps as jsteps
from pasta_tpu_torch.io import from_jax
from pasta_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pasta_tpu_torch.io.npz_ckpt import load_npz_state, save_npz_state
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train import steps as psteps

OVERRIDES = dict(use_noise=False, augment_p_init=0.0, d_reg_interval=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(state):
    """Every tensor a TrainState holds, by name."""
    out = {}
    for name in ("g", "d", "dp", "g_ema"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v
    for name, module in (("g_opt", state.g), ("d_opt", state.d),
                         ("dp_opt", state.dp)):
        opt = getattr(state, name)
        for pname, p in module.named_parameters():
            for k, v in opt.state[p].items():
                out[f"{name}.{pname}.{k}"] = v
    out["ada_p"] = state.ada_p
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.cur_nimg) == (b.step, b.cur_nimg)


@pytest.fixture(scope="module")
def stepped():
    """A port state two steps in (R1 on the first), and its batch."""
    cfg = pconfig.smoke_config(1, **OVERRIDES)
    state = pstate.init_state(cfg, seed=0, device="cpu")
    batch = pstate.batch_to(
        pstate.example_batch(cfg, np.random.RandomState(5)), "cpu")
    step = psteps.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        step(state, batch, gen, do_r1_d=i == 0, do_r1_dp=i == 0)
    return cfg, state, batch, step


def test_pt_roundtrip_is_bit_equal_and_resumes_exactly(stepped, tmp_path):
    cfg, state, batch, step = stepped
    path = str(tmp_path / "ckpt-000002.pt")
    save_checkpoint(path, state)
    assert not (tmp_path / "ckpt-000002.pt.tmp").exists()
    other = pstate.init_state(cfg, seed=7, device="cpu")
    assert not torch.equal(other.d.state_dict()["b4.fc.weight"],
                           state.d.state_dict()["b4.fc.weight"])
    assert load_checkpoint(path, other) is other
    assert other.step == 2 and other.cur_nimg == 2 * cfg.batch_size
    _assert_states_equal(other, state)
    # Adam's step counters: one per parameter, D's count its R1 update too
    g_steps = {int(s["step"]) for s in other.g_opt.state.values()}
    d_steps = {int(s["step"]) for s in other.d_opt.state.values()}
    assert g_steps == {2} and d_steps == {3}
    # the next step of the loaded state is the unbroken run's
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    _, m_a = step(state, batch, gens[0])
    _, m_b = psteps.make_train_step(cfg)(other, batch, gens[1])
    _assert_states_equal(other, state)
    m_a, m_b = psteps.fetch_metrics([m_a, m_b])
    assert m_a == m_b


def test_pt_load_is_strict(stepped, tmp_path):
    cfg, state, _, _ = stepped
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state)
    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == sorted(
        ["g", "d", "dp", "g_ema", "g_opt", "d_opt", "dp_opt", "step",
         "cur_nimg", "ada_p"])
    del payload["g"]["mapping.w_avg"]
    torch.save(payload, path)
    with pytest.raises(RuntimeError, match="w_avg"):
        load_checkpoint(path, pstate.init_state(cfg, seed=1, device="cpu"))


@pytest.mark.parametrize("which", ["g", "d"])
def test_way_back_equals_torch_import(which):
    """state dict -> JAX trees by the port's copy of the rules equals
    `pasta_tpu.io.torch_import`, and comes back unchanged."""
    cfg = pconfig.smoke_config(1)
    g, d, _ = pstate.make_models(cfg, seed=4)
    module = g if which == "g" else d
    sd = module.state_dict()
    ref = (jimport.import_generator_state if which == "g"
           else jimport.import_discriminator_state)(
               jimport.state_dict_to_numpy(module))
    got = (from_jax.state_dict_to_jax if which == "g"
           else from_jax.discriminator_state_dict_to_jax)(sd)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got_flat = flat({k: v for k, v in got.items() if v})
    ref_flat = flat(ref)
    assert sorted(got_flat) == sorted(ref_flat)
    for k, v in ref_flat.items():
        assert got_flat[k].shape == v.shape, k
        assert np.array_equal(got_flat[k], v), k
    back = (from_jax.jax_to_state_dict if which == "g"
            else from_jax.discriminator_jax_to_state_dict)(got)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """A JAX TrainState after two steps (both lazy phases on, so that one
    program serves all three steps), its flat npz, the port state loaded
    from it, and the third step of each."""
    base = tmp_path_factory.mktemp("npz")
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **OVERRIDES)
    pcfg = pconfig.smoke_config(1, **OVERRIDES)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jsteps.make_train_step(jcfg, None)
    for i in range(2):
        jst, _ = jstep(jst, jb, jax.random.PRNGKey(i), do_r1_d=True,
                       do_r1_dp=True)
    jst = jax.device_get(jst)
    path = str(base / "jax_state.npz")
    jnpz.save_npz_variables(path, jst)
    pst = pstate.init_state(pcfg, seed=3, device="cpu")
    load_npz_state(path, pst)
    back = str(base / "port_state.npz")
    save_npz_state(back, pst)
    jnext, jm = jstep(jst, jb, jax.random.PRNGKey(2), do_r1_d=True,
                      do_r1_dp=True)
    _, pm = psteps.make_train_step(pcfg)(
        pst, pstate.batch_to(batch, "cpu"), torch.Generator().manual_seed(2),
        do_r1_d=True, do_r1_dp=True)
    return dict(jst=jst, path=path, back=back, pst=pst,
                jnext=jax.device_get(jnext),
                jm={k: float(v) for k, v in jm.items()},
                pm=psteps.fetch_metrics([pm])[0])


def test_npz_crosses_both_ways_with_every_leaf(crossed):
    a, b = np.load(crossed["path"]), np.load(crossed["back"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k == ".pl_mean":        # written as 0 until Gpl is ported
            assert float(b[k]) == 0.0
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k
    template = jax.tree.map(np.asarray, crossed["jst"])
    restored = jnpz.load_npz_into(crossed["back"], template)
    assert isinstance(restored, jstate.TrainState)
    for (kp, x), y in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                          jax.tree.leaves(template)):
        assert np.array_equal(np.asarray(x), y), jax.tree_util.keystr(kp)
    assert int(restored.step) == 2
    assert int(restored.g_opt[0].count) == 2
    assert int(restored.d_opt[0].count) == 4      # two mains, two R1s


def test_npz_adam_moments_reach_torch(crossed):
    """optax's (count, mu, nu) become torch's (step, exp_avg, exp_avg_sq)
    in the port's layouts."""
    jst = crossed["jst"]
    cfg = pconfig.smoke_config(1, **OVERRIDES)
    fresh = pstate.init_state(cfg, seed=3, device="cpu")
    load_npz_state(crossed["path"], fresh)
    for opt, module, jopt, to_sd in (
            (fresh.g_opt, fresh.g, jst.g_opt, from_jax.jax_to_state_dict),
            (fresh.d_opt, fresh.d, jst.d_opt,
             from_jax.discriminator_jax_to_state_dict),
            (fresh.dp_opt, fresh.dp, jst.dp_opt,
             from_jax.discriminator_jax_to_state_dict)):
        mu = to_sd({"params": jax.tree.map(np.asarray, jopt[0].mu)})
        nu = to_sd({"params": jax.tree.map(np.asarray, jopt[0].nu)})
        for name, p in module.named_parameters():
            st = opt.state[p]
            assert float(st["step"]) == float(jopt[0].count), name
            assert st["exp_avg"].shape == p.shape, name
            assert torch.equal(st["exp_avg"], mu[name]), name
            assert torch.equal(st["exp_avg_sq"], nu[name]), name
    assert fresh.step == 2 and fresh.cur_nimg == int(jst.cur_nimg)
    assert float(fresh.ada_p) == float(jst.ada_p)
    g_sd = from_jax.jax_to_state_dict(jax.tree.map(
        np.asarray, {"params": jst.g_ema_params,
                     "buffers": jst.g_ema_buffers}))
    for k, v in fresh.g_ema.state_dict().items():
        assert torch.equal(v, g_sd[k]), k


def test_one_further_step_agrees_after_the_crossing(crossed):
    jm, pm = crossed["jm"], crossed["pm"]
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], v, rtol=1e-2, atol=2e-3, err_msg=k)
    pst, jnext = crossed["pst"], crossed["jnext"]
    assert pst.step == int(jnext.step) == 3
    ref = from_jax.jax_to_state_dict(jax.tree.map(
        np.asarray, {"params": jnext.g_params, "buffers": jnext.g_buffers}))
    got = pst.g.state_dict()
    num = sum(float((got[k] - v).square().sum()) for k, v in ref.items())
    den = sum(float(v.square().sum()) for v in ref.values())
    assert (num / den) ** 0.5 <= 1e-3, (num / den) ** 0.5


def test_npz_written_before_any_step(tmp_path):
    """A state that has taken no step has no Adam state in torch: zeros and
    count 0 are written, and loading them back steps as a fresh state."""
    cfg = pconfig.smoke_config(1, **OVERRIDES)
    state = pstate.init_state(cfg, seed=2, device="cpu")
    path = str(tmp_path / "fresh.npz")
    save_npz_state(path, state)
    data = np.load(path)
    assert int(data[".g_opt||[0]||.count"]) == 0
    assert not any(np.any(data[k]) for k in data.files if "||.mu||" in k)
    other = pstate.init_state(cfg, seed=9, device="cpu")
    load_npz_state(path, other)
    for k, v in state.g.state_dict().items():
        assert torch.equal(other.g.state_dict()[k], v), k
    assert all(float(s["step"]) == 0 for s in other.d_opt.state.values())
