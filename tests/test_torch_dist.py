"""Data-parallel training in the port (train/entry.py, train/dist.py and the
global reductions of the step) against pasta_tpu's step on an n-device
CPU mesh, on the CPU: the ranks are gloo processes spawned by
tests/torch_dist_ranks.py (a `file://` rendezvous under `tmp_path`).

(a) One whole step with both lazy R1 phases at 2 ranks, global batch 4
    (2 a rank, mbstd group 2: a group pairs a sample of rank 0 with one of
    rank 1), against `make_train_step(cfg, mesh=make_mesh(2))` on the same
    global batch; every rank ends bit-equal to the others. Setup and
    tolerances as tests/test_torch_train.py's whole step (metrics 1e-2
    relative or 2e-3 absolute); parameters, w_avg: 1e-4 of each module's
    norm (tests/test_torch_train_options.py's budget after a step; Adam
    with beta1 = 0 moves a weight by about lr * sign(g)); ada_p 1e-9.
(b) MinibatchStdLayer over 2 and 4 ranks: output, gradient and gradient of
    the gradient (R1's second order through the gather) against the
    one-process layer on the global batch and the JAX layer, 1e-6.
(c) Sites 2-4 (Gpl's pl_mean, the parsing CE's denominator, the contextual
    loss's target mean) at 2 ranks, each rank with another mask weight sum,
    against one process on the global batch: the ranks' mean loss and
    each rank's gradient (over the world size: the step means the ranks'
    gradients), 1e-6 relative.
(f) `dryrun(2)` over gloo.

tests/test_torch_dist_options.py holds grad_accum and Gpl (site 8);
tests/test_torch_dist_loop.py the command line's run over 2 ranks.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_dist_ranks as ranks
from pasta_tpu.losses import vgg as jvgg
from pasta_tpu.nn import layers as jlayers
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import entry as jentry
from pasta_tpu.train import state as jstate
from pasta_tpu.train import steps as jsteps
from pasta_tpu_torch.io.from_jax import (discriminator_jax_to_state_dict,
                                         jax_to_state_dict,
                                         vgg19_jax_to_state_dict)
from pasta_tpu_torch.nn.layers import MinibatchStdLayer
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import dist as tdist
from pasta_tpu_torch.train.entry import dryrun, shard_batch

OVERRIDES = dict(use_noise=False, augment_p_init=0.0, vgg_weight=20.0,
                 vgg_bf16=False)
PARAM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def port_state_dicts(jst):
    """The JAX state's modules as the port's state dicts (numpy)."""
    g = _numpy_sd(jax_to_state_dict(_np_tree(
        {"params": jst.g_params, "buffers": jst.g_buffers})))
    g_ema = _numpy_sd(jax_to_state_dict(_np_tree(
        {"params": jst.g_ema_params, "buffers": jst.g_ema_buffers})))
    d = _numpy_sd(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.d_params})))
    dp = _numpy_sd(discriminator_jax_to_state_dict(
        _np_tree({"params": jst.dp_params})))
    return dict(g=g, d=d, dp=dp, g_ema=g_ema)


def rel_err(got, ref):
    num = sum(float(np.sum((np.asarray(got[k]) - v) ** 2))
              for k, v in ref.items())
    den = sum(float(np.sum(np.asarray(v) ** 2)) for v in ref.values())
    return (num / den) ** 0.5


def jax_mesh_step(jcfg, jst, batches, vgg_params, key, **kw):
    """The JAX step on a jcfg.data_axis_size-device mesh from `jst` on each
    of `batches`: state replicated, batch sharded over the `data` axis;
    [(new state, metrics)]."""
    mesh = jentry.make_mesh(jcfg.data_axis_size)
    step = jsteps.make_train_step(jcfg, vgg_params, mesh=mesh)
    out = []
    for batch in batches:
        jnew, jm = step(jentry.replicate(jst, mesh),
                        jentry.shard_batch(batch, mesh), key, **kw)
        out.append((jnew, {k: float(v) for k, v in jm.items()}))
    return out


def check_step(results, jnew, jm):
    """The ranks' step against the JAX step: metrics, the four modules,
    w_avg, ada_p, pl_mean; every rank bit-equal to rank 0."""
    ref = port_state_dicts(jnew)
    first = results[0]
    for other in results[1:]:
        for name in ("g", "d", "dp", "g_ema"):
            for k, v in first[name].items():
                assert np.array_equal(v, other[name][k]), (name, k)
        assert other["metrics"] == first["metrics"]
        assert other["ada_p"] == first["ada_p"]
        assert other["pl_mean"] == first["pl_mean"]
    pm = first["metrics"]
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], v, rtol=1e-2, atol=2e-3,
                                   err_msg=k)
    for name in ("g", "d", "dp", "g_ema"):
        err = rel_err(first[name], ref[name])
        assert err <= PARAM_RTOL, (name, err)
    w_avg = ref["g"]["mapping.w_avg"]
    assert np.linalg.norm(first["g"]["mapping.w_avg"] - w_avg) \
        <= PARAM_RTOL * np.linalg.norm(w_avg)
    np.testing.assert_allclose(first["ada_p"], float(jnew.ada_p), atol=1e-9)
    assert first["step"] == int(jnew.step) == 1
    assert first["cur_nimg"] == int(jnew.cur_nimg)


@pytest.fixture(scope="module")
def step_pair(tmp_path_factory):
    """(a): the 2-rank step and the JAX step on a 2-device mesh."""
    jcfg = jconfig.smoke_config(2, ada_impl="twopass", **OVERRIDES)
    pcfg = pconfig.smoke_config(2, **OVERRIDES)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    vgg_params = _np_tree(jvgg.VGG19Features().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    kw = dict(do_r1_d=True, do_r1_dp=True)
    results = ranks.run(2, "step", dict(
        cfg=pcfg, state=port_state_dicts(jst), batch=batch,
        vgg={k: v.numpy() for k, v in vgg19_jax_to_state_dict(
            vgg_params).items()}, kw=kw), tmp_path_factory.mktemp("a"))
    ((jnew, jm),) = jax_mesh_step(jcfg, jst, [batch], vgg_params,
                                  jax.random.PRNGKey(3), **kw)
    return results, jnew, jm


def test_step_over_two_ranks_matches_the_jax_mesh_step(step_pair):
    check_step(*step_pair)


def test_ranks_hold_the_global_batch_rows():
    """The batch the JAX mesh step saw, cut as the ranks cut it."""
    cfg = pconfig.smoke_config(2)
    batch = jstate.example_batch(jconfig.smoke_config(2),
                                 np.random.RandomState(5))
    parts = [shard_batch(batch, r, 2) for r in range(2)]
    for k, v in batch.items():
        assert all(p[k].shape[0] == cfg.batch_per_device for p in parts)
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      v)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch, 0, 3)


# (b) the minibatch-std groups over the global batch -----------------------

GROUPS = (2, 4)


@pytest.fixture(scope="module")
def mbstd_inputs():
    rng = np.random.RandomState(0)
    n = 8
    return dict(x=rng.randn(n, 4, 4, 6).astype(np.float32),
                wy=rng.randn(n, 4, 4, 8).astype(np.float32),
                v=rng.randn(n, 4, 4, 6).astype(np.float32),
                groups=GROUPS, channels=2)


def _jax_mbstd(p, g):
    layer = jlayers.MinibatchStdLayer(group_size=g, num_channels=p["channels"])
    fn = lambda x: layer.apply({}, x)
    gx = jax.grad(lambda x: jnp.sum(fn(x) * p["wy"]))
    ggx = jax.grad(lambda x: jnp.sum(gx(x) * p["v"]))
    x = jnp.asarray(p["x"])
    return np.asarray(fn(x)), np.asarray(gx(x)), np.asarray(ggx(x))


@pytest.mark.parametrize("world", [2, 4])
def test_mbstd_groups_over_the_global_batch(world, mbstd_inputs, tmp_path):
    p = mbstd_inputs
    got = ranks.run(world, "mbstd", p, tmp_path)
    for g in GROUPS:
        one = ranks._grads(MinibatchStdLayer(g, p["channels"]),
                           *(torch.from_numpy(p[k]) for k in ("x", "wy",
                                                               "v")))
        ref = _jax_mbstd(p, g)
        for i, what in enumerate(("output", "gradient", "grad of grad")):
            mine = np.concatenate([got[r][g][i] for r in range(world)])
            np.testing.assert_allclose(mine, one[i], rtol=1e-6, atol=1e-6,
                                       err_msg=f"group {g} {what}")
            np.testing.assert_allclose(mine, ref[i], rtol=1e-6, atol=1e-6,
                                       err_msg=f"group {g} {what} vs JAX")
        # the groups span the ranks: per-rank groups would give another
        # statistic
        local = MinibatchStdLayer(g, p["channels"])(
            torch.from_numpy(p["x"][:8 // world])).numpy()
        assert not np.allclose(local, got[0][g][0], atol=1e-3)


def test_collectives_are_the_identity_without_a_group():
    x = torch.randn(3, 2, requires_grad=True)
    assert tdist.world_size() == 1 and tdist.rank() == 0
    for fn in (tdist.all_gather_batch, tdist.all_reduce_sum,
               tdist.all_reduce_mean):
        assert fn(x) is x
    grads, metrics = [x], {"a": x.sum(), "b": 0.0}
    assert tdist.reduce_phase(grads, metrics) == (grads, metrics)


# (c) sites 2-4: global reductions -----------------------------------------

@pytest.fixture(scope="module")
def site_inputs():
    rng = np.random.RandomState(1)
    targets = rng.randint(0, 7, (4, 8, 8))
    targets[2:][rng.rand(2, 8, 8) < 0.6] = 255   # rank 1: many ignored
    targets[2:][targets[2:] == 1] = 0            # and another class mix
    return dict(pl_lengths=rng.rand(4).astype(np.float32) + 0.5,
                pl_mean=0.3,
                logits=rng.randn(4, 8, 8, 7).astype(np.float32),
                targets=targets,
                x_feat=rng.randn(4, 8, 8, 16).astype(np.float32),
                y_feat=rng.randn(4, 8, 8, 16).astype(np.float32))


def test_global_reductions_over_two_ranks(site_inputs, tmp_path):
    p = site_inputs
    got = ranks.run(2, "reductions", p, tmp_path)
    one = ranks.reductions(p)
    # each rank holds another weight sum of the parsing CE
    from pasta_tpu_torch.losses.parsing import PARSING_CLASS_WEIGHTS
    cw = np.asarray(PARSING_CLASS_WEIGHTS + (0.0,) * 249)
    w = [cw[np.minimum(p["targets"][r * 2:(r + 1) * 2], 255)].sum()
         for r in range(2)]
    assert abs(w[0] - w[1]) > 0.2 * max(w)
    for site in ("pl", "ce", "cx"):
        value = np.mean([got[r][site][0] for r in range(2)])
        np.testing.assert_allclose(value, one[site][0], rtol=1e-6,
                                   err_msg=site)
        grad = np.concatenate([got[r][site][-1] for r in range(2)]) / 2
        np.testing.assert_allclose(grad, one[site][-1], rtol=1e-5,
                                   atol=1e-7 * np.abs(one[site][-1]).max(),
                                   err_msg=f"{site} gradient")
    for r in range(2):       # pl_mean moved by the global batch's lengths
        np.testing.assert_allclose(got[r]["pl"][1], one["pl"][1], rtol=1e-6)
    # a rank's own rows alone would give another value at every site
    own = ranks.reductions(dict(p, **shard_batch(
        {k: p[k] for k in ("pl_lengths", "logits", "targets", "x_feat",
                           "y_feat")}, 0, 2)))
    for site in ("pl", "ce", "cx"):
        assert not np.isclose(own[site][0], one[site][0], rtol=1e-3), site


# (f) ----------------------------------------------------------------------

def test_dryrun_over_two_gloo_ranks(capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # each rank one thread
    dryrun(2, device="cpu")
    assert "dryrun(2) OK" in capfd.readouterr().out
