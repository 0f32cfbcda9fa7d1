"""Site 8 of data-parallel training: grad_accum microbatches and the Gpl
prefix at 2 gloo ranks against pasta_tpu's step on a 2-device CPU mesh, on
the CPU (ranks spawned by tests/torch_dist_ranks.py).

The port takes each rank's microbatches and prefixes (train/config.py);
the JAX step takes them from the global batch. So the JAX step gets the
global batch in another order: the one in which its microbatch k is the
ranks' microbatches k one after the other, and its Gpl prefix the ranks'
prefixes one after the other. The two coincide here (grad_accum 2,
pl_batch_shrink 2: each is the ranks' first rows, then their second), and
inside each microbatch the order is the port's gathered order, so the
minibatch-std groups (group 2, two samples a microbatch, one a rank) are
the same samples. Gpl's directions are the JAX step's own draw, each rank
given its rows. R1 stays out of this step: it runs on the whole batch, whose
groups the reordering changes (tests/test_torch_dist.py holds R1).

Setup and tolerances as tests/test_torch_dist.py's step, but without the
VGG loss (rank-local, as in tests/test_torch_dist.py's step); pl_mean 1e-3
relative (tests/test_torch_train_options.py's).
"""

import numpy as np
import pytest
import torch
import jax

import torch_dist_ranks as ranks
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import state as jstate
from pasta_tpu_torch.train import config as pconfig
from test_torch_dist import check_step, jax_mesh_step, port_state_dicts
from test_torch_train_options import jax_pl_noise

SITE8 = dict(use_noise=False, augment_p_init=0.0, vgg_weight=0.0,
             grad_accum=2, pl_weight=2.0, pl_batch_shrink=2)


def jax_order(batch_size, world, accum, shrink):
    """perm with jax_batch = port_batch[perm]: JAX position k * B/a + r *
    b/a + j holds rank r's row k * b/a + j (microbatch k); checked to give
    the Gpl prefix too."""
    b = batch_size // world
    m = b // accum
    perm = [r * b + k * m + j for k in range(accum) for r in range(world)
            for j in range(m)]
    s = b // shrink
    prefix = [r * b + j for r in range(world) for j in range(s)]
    assert perm[:len(prefix)] == prefix
    return np.asarray(perm)


def test_jax_order_is_a_permutation():
    assert list(jax_order(4, 2, 2, 2)) == [0, 2, 1, 3]
    assert sorted(jax_order(16, 4, 2, 2)) == list(range(16))


@pytest.fixture(scope="module")
def site8_pair(tmp_path_factory):
    jcfg = jconfig.smoke_config(2, ada_impl="twopass", **SITE8)
    pcfg = pconfig.smoke_config(2, **SITE8)
    jst = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jstate.example_batch(jcfg, np.random.RandomState(5))
    perm = jax_order(jcfg.batch_size, 2, jcfg.grad_accum,
                     jcfg.pl_batch_shrink)
    key = jax.random.PRNGKey(3)
    kw = dict(do_pl=True)
    results = ranks.run(2, "step", dict(
        cfg=pcfg, state=port_state_dicts(jst), batch=batch, kw=kw,
        pl_noise=jax_pl_noise(key, jcfg).astype(np.float32)),
        tmp_path_factory.mktemp("d"))
    (jnew, jm), (jglobal, _) = jax_mesh_step(
        jcfg, jst, [{k: v[perm] for k, v in batch.items()}, batch], None,
        key, **kw)
    return results, jnew, jm, jglobal


def test_grad_accum_and_gpl_over_two_ranks_match_the_jax_mesh_step(
        site8_pair):
    results, jnew, jm, _ = site8_pair
    check_step(results, jnew, jm)
    assert jm["pl_penalty"] > 0
    assert results[0]["pl_mean"] != 0
    np.testing.assert_allclose(results[0]["pl_mean"], float(jnew.pl_mean),
                               rtol=1e-3)


def test_site8_selects_other_samples_than_the_global_batch(site8_pair):
    """On the global batch in its own order the JAX step's Gpl prefix is
    rows 0 and 1, not the ranks' rows 0 and 2: pl_mean, a mean over the
    prefix's path lengths, moves elsewhere (the decision train/config.py
    states)."""
    results, jnew, _, jglobal = site8_pair
    assert abs(float(jglobal.pl_mean) - float(jnew.pl_mean)) \
        > 1e-2 * abs(float(jnew.pl_mean))
