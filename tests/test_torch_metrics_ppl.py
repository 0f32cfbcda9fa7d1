"""The try-on PPL of the port against pasta_tpu's on the CPU, at the narrow
512 px generator of tests/test_torch_inference.py (channel_base=2048,
channel_max=128), over the first pair (`--ppl-items 1`) of a synthetic
root written under tmp_path, one generator `.npz` (the port's seeded
weights, carried by `state_dict_to_jax` and written with the JAX package's
`save_npz_variables`), one seeded Inception `.npz`.

The port runs as users run it, `cli.calc_metrics --metrics ppl` with the
narrow generator patched into `models.Generator` (the CLI looks it up at
call time). The JAX side is the path its CLI takes,
`build_tryon_ppl_ctx` on the variables of the same `.npz`; its CLI's own
run also assembles a batch of example inputs for a random init, which
costs another ~30 s of eager XLA compiles on a CPU and serves no `--network`
run, so it is left out.

Held: the endpoint style codes of both contexts within 1e-4 of their
scale (fp32 encoders); the synthesized images within the generator tests'
budget (0.5% of values off by more than 1e-2 of the range: the SPADE
routing's argmax may flip where two parsing logits tie within fp32
noise); `compute_ppl` of both contexts at one t with one feature map (the
images' column means; the detectors are held in
tests/test_torch_metrics*.py) at 5e-2 relative, with epsilon 1e-2: at the
default 1e-4 the two images differ by less than the pixels where the
routing argmax flips between packages, and the two values part by 17%
(one path position: no mean averages anything away).
"""

import json

import numpy as np
import pytest
import torch
import jax

from pasta_tpu.io.npz_ckpt import load_npz_variables, save_npz_variables
from pasta_tpu.metrics import ppl as jppl
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch import models
from pasta_tpu_torch.cli import calc_metrics as cli
from pasta_tpu_torch.data.synthetic import write_tryon_root
from pasta_tpu_torch.io.from_jax import state_dict_to_jax
from pasta_tpu_torch.metrics import ppl
from pasta_tpu_torch.metrics.inception import random_inception_state

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_ppl_matches_jax(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "root")
    write_tryon_root(root, 3, seed=81)
    save_npz_variables(str(tmp_path / "g.npz"), state_dict_to_jax(
        models.Generator(seed=0, **NARROW).state_dict()))
    np.savez(tmp_path / "inception.npz", **{
        k: v.numpy() for k, v in random_inception_state(0).items()})
    port_g = models.Generator

    class Narrow(port_g):
        def __init__(self, **kw):
            super().__init__(**{**kw, **NARROW, "seed": 1})

    built = []
    build = cli.build_ppl_ctx
    monkeypatch.setattr(models, "Generator", Narrow)
    monkeypatch.setattr(cli, "build_ppl_ctx",
                        lambda *a: built.append(build(*a)) or built[-1])
    (record,) = cli.main([
        "--metrics", "ppl", "--network", str(tmp_path / "g.npz"),
        "--dataroot", root, "--ppl-items", "1", "--detector",
        str(tmp_path / "inception.npz"), "--device", "cpu", "--run-dir",
        str(tmp_path / "run")])
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    got = record["results"]["ppl"]
    assert line == record["results"] and np.isfinite(got) and got > 0
    assert (tmp_path / "run" / "metric-ppl.jsonl").exists()

    (ctx,) = built
    with open(f"{root}/test_pairs.txt") as f:
        pairs = [ln.split() for ln in f if ln.strip()][:1]
    jctx = jppl.build_tryon_ppl_ctx(
        JaxGenerator(**NARROW), load_npz_variables(str(tmp_path / "g.npz")),
        root, pairs, "upper")
    for k in ("codes_a", "codes_b"):
        a, b = ctx[k].numpy(), np.asarray(jctx[k])
        assert a.shape == b.shape == (1, 512)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), k

    key = jax.random.PRNGKey(3)
    t = np.array(jax.random.uniform(key, (1, 1)))

    def cols(store):
        def feature_fn(x):
            store.setdefault("imgs", []).append(np.asarray(x))
            return x.mean(1).reshape(x.shape[0], -1)
        return feature_fn

    jstore, store = {}, {}
    ref = jppl.compute_ppl(jctx["synth_from_code"], cols(jstore),
                           jctx["codes_a"], jctx["codes_b"], key,
                           epsilon=1e-2)
    mine = ppl.compute_ppl(ctx["synth_from_code"], cols(store),
                           ctx["codes_a"], ctx["codes_b"], epsilon=1e-2,
                           t=torch.from_numpy(t))
    for a, b in zip(store["imgs"], jstore["imgs"]):
        assert a.shape == b.shape == (1, 512, 512, 3)
        span = b.max() - b.min()
        assert np.mean(np.abs(a - b) > 1e-2 * span) <= 5e-3
    np.testing.assert_allclose(mine, ref, rtol=5e-2)
