"""The port's metric runner and CLI against pasta_tpu's on the CPU:
`DetectorRunner.folder_stats` over folders of PNGs written under tmp_path
(with and without a crop), `calc_metric`'s record and jsonl, both
`cli.calc_metrics` on the same folders and a seeded `.npz` detector
(fid, kid, inception_score, pr), the CLI's refusal
without a card, and `compute_ppl` / `calc_metric("ppl")` with lerp and
slerp (over the images' column means) on the 64 px narrow generator of
tests/test_metrics.py::test_ppl_metric_registered_small_config, the JAX
draw of t handed to the port through `compute_ppl`'s `t`.

Tolerances: detector features and FID's statistics fp32, 1e-4 of their
largest magnitude; KID 1e-3 relative and IS 1e-5 (smooth in the
features); precision / recall equal; PPL 1e-3 relative at epsilon 1e-2
(at the default 1e-4, d(I_t, I_t+eps) / eps^2 differences images 1e-4
apart, and the two packages' fp32 noise parts the values by 1.4%).
"""

import json
import os

import numpy as np
import PIL.Image
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu.cli import calc_metrics as jcli
from pasta_tpu.metrics import metric_main as jmm
from pasta_tpu.metrics import ppl as jppl
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch.cli import calc_metrics as cli
from pasta_tpu_torch.io.from_jax import state_dict_to_jax
from pasta_tpu_torch.metrics import metric_main as mm
from pasta_tpu_torch.metrics import ppl
from pasta_tpu_torch.metrics.inception import random_inception_state
from pasta_tpu_torch.models import Generator

N_IMAGES = 4
G_CFG = dict(img_resolution=64, channel_base=2048, channel_max=128,
             conv_clamp=256)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Real images (96x80), 512x960 composites whose generated third is a
    noisy upscale of a real image, and the Inception detector as a flat
    .npz of its torchvision-keyed state dict."""
    root = tmp_path_factory.mktemp("metrics")
    rng = np.random.RandomState(0)
    os.makedirs(root / "real")
    os.makedirs(root / "gen")
    for i in range(N_IMAGES):
        real = rng.randint(0, 256, (96, 80, 3)).astype(np.uint8)
        PIL.Image.fromarray(real).save(root / "real" / f"{i:03d}.png")
        comp = rng.randint(0, 256, (512, 960, 3)).astype(np.uint8)
        up = np.asarray(PIL.Image.fromarray(real).resize((320, 512)))
        comp[:, 640:] = np.clip(up + rng.randint(-20, 21, up.shape), 0, 255)
        PIL.Image.fromarray(comp).save(root / "gen" / f"{i:03d}.png")
    inc_state = random_inception_state(0)
    np.savez(root / "inception.npz",
             **{k: v.numpy() for k, v in inc_state.items()})
    return root


class FidSpy:
    """Stands in for a package's compute_fid: records the statistics it
    is given and returns the FID without its sqrtm term (scipy's sqrtm of
    a 2048 x 2048 product takes ~10 s on a CPU; compute_fid itself is
    the same numpy code in both packages, held equal in
    tests/test_torch_metrics.py)."""

    def __init__(self):
        self.calls = []

    def __call__(self, mu_r, sig_r, mu_g, sig_g):
        self.calls.append((mu_r, sig_r, mu_g, sig_g))
        return float(np.square(mu_g - mu_r).sum() + np.trace(sig_g)
                     + np.trace(sig_r))


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("crop", [None, (100, 400, 660, 940)])
def test_folder_stats_and_calc_metric(data, crop, tmp_path):
    path = str(data / "inception.npz")
    runner = mm.DetectorRunner(mm.load_detector(path, "cpu"), batch_size=4)
    jrunner = jmm.DetectorRunner(jmm.load_detector(path), batch_size=4)
    gen = str(data / "gen")
    got = runner.folder_stats(gen, capture_all=True, capture_probs=True,
                              crop=crop)
    ref = jrunner.folder_stats(gen, capture_all=True, capture_probs=True,
                               crop=crop)
    assert got.num_items == ref.num_items == N_IMAGES
    _close(got.get_all(), ref.get_all())
    _close(got.probs, ref.probs, 1e-5)
    for a, b in zip(got.get_mean_cov(), ref.get_mean_cov()):
        _close(a, b)
    if crop is None:
        # the cache written by one package is read by the other
        cache = str(tmp_path / "cache")
        jrunner.folder_stats(gen, cache_dir=cache)
        (name,) = os.listdir(cache)
        hit = runner.folder_stats(gen, cache_dir=cache)
        assert hit.num_items == N_IMAGES and os.listdir(cache) == [name]
        return
    run = str(tmp_path / "run")
    rec = mm.calc_metric("kid", runner, str(data / "real"), gen,
                         run_dir=run, crop=crop)
    jrec = jmm.calc_metric("kid", jrunner, str(data / "real"), gen,
                           crop=crop)
    assert sorted(rec) == sorted(jrec)
    np.testing.assert_allclose(rec["results"]["kid"],
                               jrec["results"]["kid"], rtol=1e-3)
    lines = open(os.path.join(run, "metric-kid.jsonl")).read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["results"] == \
        rec["results"]
    with pytest.raises(ValueError, match="no images"):
        mm.calc_metric("fid", runner, str(tmp_path), gen)


def test_cli_matches_jax_cli(data, tmp_path, capsys, monkeypatch):
    """fid, kid, inception_score and pr (on Inception features; VGG16's
    fc7 runner is held in tests/test_torch_metrics.py) over the same
    folders, --crop-generated, one .npz detector. FID's statistics are
    held (FidSpy)."""
    spies = FidSpy(), FidSpy()
    monkeypatch.setattr(mm, "compute_fid", spies[0])
    monkeypatch.setattr(jmm, "compute_fid", spies[1])
    argv = ["--metrics", "fid,kid,inception_score,pr", "--real",
            str(data / "real"), "--gen", str(data / "gen"), "--detector",
            str(data / "inception.npz"), "--crop-generated", "--batch", "4"]
    records = cli.main(argv + ["--device", "cpu", "--run-dir",
                               str(tmp_path / "run")])
    got = [json.loads(line) for line in
           capsys.readouterr().out.splitlines() if line.startswith("{")]
    jcli.main(argv)
    ref = [json.loads(line) for line in
           capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert got == [r["results"] for r in records] and len(ref) == 4
    (stats,), (jstats,) = spies[0].calls, spies[1].calls
    for a, b in zip(stats, jstats):
        _close(a, b)
    np.testing.assert_allclose(got[0]["fid"], ref[0]["fid"], rtol=1e-4)
    np.testing.assert_allclose(got[1]["kid"], ref[1]["kid"], rtol=1e-3)
    for k in ("is_mean", "is_std"):
        np.testing.assert_allclose(got[2][k], ref[2][k], rtol=1e-5)
    assert got[3] == ref[3]
    assert sorted(os.listdir(tmp_path / "run")) == [
        f"metric-{m}.jsonl" for m in ("fid", "inception_score", "kid", "pr")]


def test_cli_refuses_without_a_card(data, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--real", str(data / "real"), "--gen", str(data / "gen"),
                  "--detector", str(data / "inception.npz"), "--run-dir",
                  str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")


# ------------------------------------------------------------------ ppl ----

@pytest.fixture(scope="module")
def small_g():
    """The 64 px narrow generator, weights from the port's seed (biases and
    noise strengths made live), both packages' synthesis from a style code
    over the same conditioning, and two endpoint codes."""
    port = Generator(seed=0, **G_CFG).eval()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("bias", "m_bias1", "noise_strength")):
                p.copy_(torch.from_numpy(
                    np.asarray(rng.randn(*p.shape) * 0.2, np.float32)))
    variables = state_dict_to_jax(port.state_dict())
    jmodel = JaxGenerator(**G_CFG)
    rng = np.random.RandomState(0)
    f = np.float32
    cond = dict(c=rng.randn(2, 16, 16, 45).astype(f),
                retain=rng.randn(2, 64, 64, 6).astype(f),
                pose=rng.randn(2, 64, 64, 5).astype(f),
                denorm_upper_input=rng.randn(2, 64, 64, 3).astype(f),
                denorm_lower_input=rng.randn(2, 64, 64, 3).astype(f),
                denorm_upper_mask=(rng.rand(2, 64, 64, 1) > .5).astype(f),
                denorm_lower_mask=(rng.rand(2, 64, 64, 1) > .5).astype(f))
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}

    @jax.jit
    def jsynth(code):
        def run(m, code_):
            n = code_.shape[0]      # static: the conditioning cut to match
            c = {k: v[:n] for k, v in jcond.items()}
            ws = m.mapping(jnp.zeros((n, 0)), code_)
            _, feats = m.encode_style(c["c"], c["retain"])
            _, fin, _ = m.synthesis(
                ws, m.encode_pose(c["pose"]),
                {str(x.shape[1]): x for x in feats},
                c["denorm_upper_input"], c["denorm_lower_input"],
                c["denorm_upper_mask"], c["denorm_lower_mask"],
                None, noise_mode="const")
            return fin
        return jmodel.apply(variables, code, method=run)

    def synth(code):
        n = code.shape[0]
        c = {k: v[:n] for k, v in tcond.items()}
        with torch.no_grad():
            ws = port.mapping(torch.zeros((n, 0)), code)
            _, feats = port.style_encoding(c["c"], c["retain"])
            return port.synthesis(
                ws, port.const_encoding(c["pose"]),
                {str(x.shape[1]): x for x in feats},
                c["denorm_upper_input"], c["denorm_lower_input"],
                c["denorm_upper_mask"], c["denorm_lower_mask"],
                None, noise_mode="const")[1]

    with torch.no_grad():
        codes_a = port.style_code(tcond["c"], tcond["retain"])
    codes_b = codes_a + 0.1 * torch.from_numpy(
        np.random.RandomState(3).randn(*codes_a.shape).astype(f))
    return dict(synth=synth, jsynth=jsynth, codes_a=codes_a,
                codes_b=codes_b)


def _columns(images):
    """A cheap feature map (the images' column means, as
    tests/test_metrics.py's PPL test uses); the LPIPS one is held in
    tests/test_torch_metrics.py."""
    return images.mean(1).reshape(images.shape[0], -1)


@pytest.mark.parametrize("interp", ["lerp", "slerp"])
def test_compute_ppl_matches_jax(small_g, interp):
    g = small_g
    key = jax.random.PRNGKey(5)
    t = np.array(jax.random.uniform(key, (2, 1)))
    ref = jppl.compute_ppl(
        g["jsynth"], _columns, jnp.asarray(g["codes_a"].numpy()),
        jnp.asarray(g["codes_b"].numpy()), key, epsilon=1e-2,
        interp=interp, crop=(4, 60, 8, 56))
    got = ppl.compute_ppl(
        g["synth"], _columns, g["codes_a"], g["codes_b"], epsilon=1e-2,
        interp=interp, crop=(4, 60, 8, 56), t=torch.from_numpy(t))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    np.testing.assert_allclose(ppl.slerp(g["codes_a"], g["codes_b"],
                                         torch.from_numpy(t)).numpy(),
                               jppl.slerp(jnp.asarray(g["codes_a"].numpy()),
                                          jnp.asarray(g["codes_b"].numpy()),
                                          jnp.asarray(t)), rtol=1e-5,
                               atol=1e-6)


def test_calc_metric_ppl_matches_jax(small_g, tmp_path):
    """The registered metric, t from the JAX draw of seed 0, the context's
    own feature map; --max-items cuts the codes to 1 (the n = 2 fallback of
    the trimmed mean is the 2-code case above). One path position alone
    has no mean to damp the fp32 noise of the image difference, so epsilon
    is 1e-2 here and the tolerance 1e-3."""
    g = small_g
    t = np.array(jax.random.uniform(jax.random.PRNGKey(0), (1, 1)))
    jctx = dict(synth_from_code=g["jsynth"], feature_fn=_columns,
                codes_a=jnp.asarray(g["codes_a"].numpy()),
                codes_b=jnp.asarray(g["codes_b"].numpy()))
    ref = jmm.calc_metric("ppl", None, None, None, ppl_ctx=jctx,
                          max_items=1, epsilon=1e-2)
    ctx = dict(synth_from_code=g["synth"], feature_fn=_columns,
               codes_a=g["codes_a"], codes_b=g["codes_b"])
    got = mm.calc_metric("ppl", None, None, None, run_dir=str(tmp_path),
                         ppl_ctx=ctx, max_items=1, epsilon=1e-2,
                         t=torch.from_numpy(t))
    np.testing.assert_allclose(got["results"]["ppl"], ref["results"]["ppl"],
                               rtol=1e-3)
    drawn = mm.calc_metric("ppl", None, None, None, ppl_ctx=ctx)
    again = mm.calc_metric("ppl", None, None, None, ppl_ctx=ctx)
    assert drawn["results"] == again["results"]      # seeded draw of t
    assert os.listdir(tmp_path) == ["metric-ppl.jsonl"]
    with pytest.raises(ValueError, match="ppl_ctx"):
        mm.calc_metric("ppl", None, None, None)
