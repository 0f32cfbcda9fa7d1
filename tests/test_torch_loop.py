"""The port's training loop and CLI (pasta_tpu_torch/train/loop.py,
stats.py, summary.py, cli/train.py) against pasta_tpu's loop, on the CPU.

Both loops run three steps from ONE state (the JAX `init_state`, written as
a flat .npz and resumed by both), on one synthetic dataset root at the smoke
config (64 px, so through the host loader and `_resize_item`), with
`d_reg_interval=2` (steps 0 and 2 carry the lazy R1 phases, step 1 does
not), `use_noise=False` and ADA off, one loader thread (the only setting
with a repeatable stream of draws) and one tick a step. The JAX package's
compiled `native` decoder is switched off, so both decode alike.
tests/test_torch_loop_ada.py runs the same with ADA on.

Tolerances. The first tick's row agrees to tests/test_torch_train.py's step
tolerance (1e-2 relative or 2e-3 absolute). Later rows to 5e-2 relative or
5e-2 absolute: Adam with beta1 = 0 moves each weight by about lr * sign(g)
a step, so a gradient near zero turns rounding noise into weight
differences of lr (5e-4) that the next steps' logits see (measured worst,
step 3: d_loss 2.5e-2, fake_scores 2.1e-2 apart). G's final parameters
agree to 1e-4 of their norm (measured: 5.3e-6; largest single difference
3.1e-3, a few lr).
"""

import dataclasses
import json
import os

import numpy as np
import PIL.Image
import pytest
import torch
import jax

import pasta_tpu.native as jnative
from pasta_tpu.data import trainsets as jts
from pasta_tpu.io import npz_ckpt as jnpz
from pasta_tpu.train import config as jconfig
from pasta_tpu.train import loop as jloop
from pasta_tpu.train import state as jstate
from pasta_tpu.train import stats as jstats
from pasta_tpu_torch.cli import train as cli
from pasta_tpu_torch.data import trainsets as ts
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.io import from_jax
from pasta_tpu_torch.io.checkpoint import load_checkpoint
from pasta_tpu_torch.summary import summarize_state
from pasta_tpu_torch.train import config as pconfig
from pasta_tpu_torch.train import loop as ploop
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train import stats as pstats

OVERRIDES = dict(use_noise=False, use_ada=False, d_reg_interval=2)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loop") / "root")
    write_dataset_root(path, 6, 80)
    return path


def _rows(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def loops(root, tmp_path_factory):
    """Both loops from one crossed state; (final states, run dirs)."""
    base = tmp_path_factory.mktemp("runs")
    jcfg = jconfig.smoke_config(1, ada_impl="twopass", **OVERRIDES)
    pcfg = pconfig.smoke_config(1, **OVERRIDES)
    npz = str(base / "init.npz")
    jnpz.save_npz_variables(npz, jax.device_get(
        jstate.init_state(jcfg, jax.random.PRNGKey(0))))
    kw = dict(resume_path=npz, total_steps=STEPS, tick_interval=1,
              snapshot_ticks=2, num_workers=1, seed=0)
    jdir, pdir = str(base / "jax"), str(base / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        jfinal = jloop.training_loop(
            jcfg, jts.TryonTrainDataset(root, seed=0, resolution=64), jdir,
            **kw)
    pfinal = ploop.training_loop(
        pcfg, ts.TryonTrainDataset(root, seed=0, resolution=64), pdir,
        device="cpu", **kw)
    return jax.device_get(jfinal), pfinal, jdir, pdir, pcfg


def test_stats_rows_agree(loops):
    _, _, jdir, pdir, _ = loops
    jrows, prows = _rows(jdir), _rows(pdir)
    assert len(jrows) == len(prows) == STEPS
    for i, (jr, pr) in enumerate(zip(jrows, prows)):
        assert set(jr) <= set(pr)
        assert pr["step"] == jr["step"] == i + 1
        assert pr["kimg"] == jr["kimg"]
        assert np.isfinite(pr["sec_per_kimg"]) and pr["sec_per_kimg"] > 0
        tol = dict(rtol=1e-2, atol=2e-3) if i == 0 else dict(rtol=5e-2,
                                                             atol=5e-2)
        for name, val in jr.items():
            if not isinstance(val, dict):
                continue
            got = pr[name]
            assert got["num"] == val["num"] == 1, name
            assert np.isfinite(got["mean"]), name
            np.testing.assert_allclose(got["mean"], val["mean"],
                                       err_msg=f"step {i + 1} {name}", **tol)
    # the lazy R1 phases ran on steps 0 and 2, not on step 1
    penalties = [r["r1_penalty"]["mean"] for r in prows]
    assert penalties[0] > 0 and penalties[2] > 0 and penalties[1] == 0
    assert [r["dp_r1_penalty"]["mean"] > 0 for r in prows] == [
        True, False, True]


def test_final_generator_agrees(loops):
    jfinal, pfinal, _, _, _ = loops
    assert pfinal.step == int(jfinal.step) == STEPS
    assert pfinal.cur_nimg == int(jfinal.cur_nimg)
    for got, params, buffers in (
            (pfinal.g, jfinal.g_params, jfinal.g_buffers),
            (pfinal.g_ema, jfinal.g_ema_params, jfinal.g_ema_buffers)):
        ref = from_jax.jax_to_state_dict(jax.tree.map(
            np.asarray, {"params": params, "buffers": buffers}))
        sd = got.state_dict()
        num = sum(float((sd[k] - v).square().sum()) for k, v in ref.items())
        den = sum(float(v.square().sum()) for v in ref.values())
        assert (num / den) ** 0.5 <= 1e-4, (num / den) ** 0.5


def test_snapshot_files(loops):
    """Snapshots at tick 2 and at the last step: three grids and a
    checkpoint each, the grids the JAX loop's size; log.txt holds the tick
    lines."""
    _, pfinal, jdir, pdir, pcfg = loops
    n_vis, res = pcfg.batch_size, pcfg.resolution
    for step in (2, 3):
        for suffix, rows in (("", 2), ("_parsing", 1), ("_parsing_color", 1)):
            name = f"fakes{step:06d}{suffix}.png"
            img = PIL.Image.open(os.path.join(pdir, name))
            ref = PIL.Image.open(os.path.join(jdir, name))
            assert img.size == ref.size == (n_vis * res, rows * res), name
            assert img.mode == ref.mode == "RGB"
        assert os.path.isfile(os.path.join(pdir, f"ckpt-{step:06d}.pt"))
    assert not os.path.exists(os.path.join(pdir, "fakes000001.png"))
    # the reals' half of the grid is the same picture in both packages
    got = np.asarray(PIL.Image.open(os.path.join(pdir, "fakes000003.png")))
    ref = np.asarray(PIL.Image.open(os.path.join(jdir, "fakes000003.png")))
    assert np.abs(got[:res].astype(int) - ref[:res].astype(int)).max() <= 1
    log = open(os.path.join(pdir, "log.txt")).read()
    assert log.count("tick step") == STEPS and "G params" in log
    assert log.count("snapshot: fakes") == 2
    jlog = open(os.path.join(jdir, "log.txt")).read()
    line = [l for l in log.splitlines() if l.startswith("G params")][0]
    assert line in jlog          # the same parameter accounting
    assert summarize_state(pfinal) == line


def test_resume_restores_the_snapshot_exactly(loops, root, tmp_path):
    """`resume_path` with `total_steps` equal to the checkpoint's step
    takes no step: the state that comes back is the checkpoint, bit for
    bit; one more step continues the numbering."""
    _, _, _, pdir, pcfg = loops
    ckpt = os.path.join(pdir, "ckpt-000002.pt")
    ds = ts.TryonTrainDataset(root, seed=0, resolution=64)
    kw = dict(resume_path=ckpt, tick_interval=1, snapshot_ticks=100,
              num_workers=1, seed=0, device="cpu")
    state = ploop.training_loop(pcfg, ds, str(tmp_path / "r0"),
                                total_steps=2, **kw)
    saved = torch.load(ckpt, weights_only=True)
    assert state.step == saved["step"] == 2
    assert state.cur_nimg == saved["cur_nimg"] == 2 * pcfg.batch_size
    assert float(state.ada_p) == saved["ada_p"]
    for name in ("g", "d", "dp", "g_ema"):
        sd = getattr(state, name).state_dict()
        assert sorted(sd) == sorted(saved[name])
        for k, v in saved[name].items():
            assert torch.equal(sd[k], v), (name, k)
    for name in ("g_opt", "d_opt", "dp_opt"):
        got = getattr(state, name).state_dict()["state"]
        for idx, st in saved[name]["state"].items():
            for k, v in st.items():
                assert torch.equal(got[idx][k], v), (name, idx, k)
    assert not os.path.exists(tmp_path / "r0" / "stats.jsonl") or \
        _rows(str(tmp_path / "r0")) == []
    state = ploop.training_loop(pcfg, ds, str(tmp_path / "r1"),
                                total_steps=3, **kw)
    rows = _rows(str(tmp_path / "r1"))
    assert [r["step"] for r in rows] == [3] and state.step == 3
    assert os.path.isfile(tmp_path / "r1" / "ckpt-000003.pt")
    # the rampup is switched off on resume (the loop's cfg, not the caller's)
    ramped = dataclasses.replace(pcfg, ema_rampup=0.05)
    state = ploop.training_loop(ramped, ds, str(tmp_path / "r2"),
                                total_steps=2, **kw)
    assert ramped.ema_rampup == 0.05 and state.step == 2


def test_abort_and_progress(root, tmp_path):
    pcfg = pconfig.smoke_config(1, **OVERRIDES)
    ds = ts.TryonTrainDataset(root, seed=0, resolution=64,
                              loader_impl="host")
    seen = []
    state = ploop.training_loop(
        pcfg, ds, str(tmp_path / "run"), total_steps=6, tick_interval=2,
        snapshot_ticks=100, num_workers=2, seed=0, device="cpu",
        progress_fn=lambda cur, total: seen.append((cur, total)),
        abort_fn=lambda: len(seen) >= 1)
    assert state.step == 2                      # stopped at the first tick
    assert seen == [(2 * pcfg.batch_size, pcfg.total_kimg * 1000)]
    rows = _rows(str(tmp_path / "run"))
    assert len(rows) == 1 and rows[0]["g_loss"]["num"] == 2
    assert not any(n.startswith("ckpt") for n in os.listdir(tmp_path / "run"))


def test_parallel_loader_stream_equals_original(root):
    """The index stream and the raw batches of the two packages' loaders
    with one worker; the lean loader's tuple."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        for impl in ("host", "device"):
            kw = dict(seed=4, loader_impl=impl)
            loader = ploop.ParallelLoader(ts.TryonTrainDataset(root, **kw),
                                          2, num_workers=1, seed=4)
            jloader = jloop.ParallelLoader(jts.TryonTrainDataset(root, **kw),
                                           2, num_workers=1, seed=4)
            assert loader.lean == jloader.lean == (impl == "device")
            for _, got, ref in zip(range(2), loader, jloader):
                if impl == "device":
                    assert got[1:] == ref[1:]
                    got, ref = got[0], ref[0]
                assert sorted(got) == sorted(ref)
                for k in ref:
                    assert got[k].dtype == ref[k].dtype, k
                    assert np.array_equal(got[k], ref[k]), k
            loader.close()
            jloader.pool.shutdown(wait=True)


def test_upload_batch():
    batch = dict(a=np.arange(6, dtype=np.uint8).reshape(2, 3),
                 m=np.eye(3)[None], f=np.ones((2,), np.float32),
                 b=np.array([True, False]))
    out = ploop.upload_batch(batch, "cpu")
    assert out["a"].dtype == torch.uint8 and out["b"].dtype == torch.bool
    assert out["m"].dtype == torch.float32          # float64 narrows
    for k, v in batch.items():
        assert np.array_equal(out[k].numpy(), v.astype(out[k].numpy().dtype))


def test_save_image_grid_equals_original(tmp_path):
    rng = np.random.RandomState(2)
    imgs = rng.rand(5, 8, 8, 3).astype(np.float32) * 2 - 1
    side, top = imgs[:2] * 0.5, imgs[:3] * 0.25
    for i, kw in enumerate((dict(), dict(grid_cols=3),
                            dict(grid_cols=3, side_images=side,
                                 top_images=top),
                            dict(drange=(0, 1), top_images=top, border=2))):
        a, b = str(tmp_path / f"a{i}.png"), str(tmp_path / f"b{i}.png")
        ploop.save_image_grid(imgs, a, **kw)
        jloop.save_image_grid(imgs, b, **kw)
        assert np.array_equal(np.asarray(PIL.Image.open(a)),
                              np.asarray(PIL.Image.open(b)))


def test_stats_collector_tee_and_logger(tmp_path, capsys):
    c, jc = pstats.Collector(), jstats.Collector()
    for m in (dict(a=1.0, b=2.0), dict(a=3.0), dict(a=torch.tensor(4.5))):
        c.report(m)
        jc.report({k: float(v) for k, v in m.items()})
    assert c.as_dict() == jc.as_dict()
    assert c.mean("a") == jc.mean("a") and c.mean("zz", 7.0) == 7.0
    c.reset()
    assert c.as_dict() == {}
    import sys
    tee = pstats.Tee(sys.stdout, str(tmp_path / "log.txt"))
    tee.write("hello\n")
    tee.flush()
    assert tee.isatty() in (True, False)
    tee.close()
    assert open(tmp_path / "log.txt").read() == "hello\n"
    assert "hello" in capsys.readouterr().out
    log = pstats.JsonlLogger(str(tmp_path / "run"))
    log.write(dict(step=1, x=dict(mean=2.0)))
    log.close()
    (row,) = _rows(str(tmp_path / "run"))
    assert row["step"] == 1 and row["x"] == {"mean": 2.0}
    assert "timestamp" in row


# ---------------------------------------------------------------------------
# cli/train.py

def test_cli_dry_run(tmp_path, capsys):
    out = str(tmp_path / "runs")
    assert cli.main(["--outdir", out, "--data", "nowhere", "--cfg", "smoke",
                     "--batch", "4", "--kimg", "3", "--gamma", "2.5",
                     "--aug", "fixed", "--p", "0.5", "--loader-impl",
                     "device", "--dry-run"]) is None
    assert "dry run: config OK" in capsys.readouterr().out
    (run,) = os.listdir(out)
    assert run == "00000-smoke-b4-d1"
    opts = json.load(open(os.path.join(out, run, "training_options.json")))
    assert opts["batch_size"] == 4 and opts["total_kimg"] == 3
    assert opts["r1_gamma"] == 2.5 and opts["augment_p_init"] == 0.5
    assert opts["loader_impl"] == "device" and opts["use_ada"] is True
    assert opts["args"]["dry_run"] is True
    # the numbering goes on
    cli.main(["--outdir", out, "--data", "nowhere", "--aug", "noaug",
              "--dry-run"])
    assert sorted(os.listdir(out))[1] == "00001-fashion-b32-d1"
    assert cli.next_run_dir(out, "x").endswith("00002-x")


def test_cli_config_follows_the_jax_cli():
    """The fields both configs have get the same values from the same
    flags."""
    from pasta_tpu.cli import train as jcli
    argv = ["--outdir", "o", "--data", "d", "--cfg", "smoke", "--batch", "6",
            "--l1weight", "3", "--vgg_weight", "0", "--mask_weight", "7",
            "--target", "0.7", "--aug", "fixed", "--p", "0.25",
            "--use_noise_const_branch", "false", "--d-bf16-res", "1",
            "--g-bf16-res", "2", "--loader-impl", "device", "--kimg", "9"]
    got = dataclasses.asdict(cli.build_config(cli.parse_args(argv)))
    ref = dataclasses.asdict(jcli.build_config(
        jcli.parse_args(argv + ["--devices", "1"])))
    common = sorted(set(got) & set(ref))
    assert len(common) >= 30
    for k in common:
        assert got[k] == ref[k], k


@pytest.mark.parametrize("flag,value,name", [
    ("--tryon-grid", "3", "--tryon-grid"), ("--trace", "dir", "--trace")])
def test_cli_deferred_flags_raise_by_name(flag, value, name, tmp_path):
    with pytest.raises(NotImplementedError, match=name):
        cli.main(["--outdir", str(tmp_path), "--data", "d", flag, value,
                  "--dry-run"])
    assert os.listdir(tmp_path) == []        # nothing was started


@pytest.mark.parametrize("argv,match", [
    (["--metrics", "fid"], "--inception"),
    (["--metrics", "fid,pr", "--inception", "i.npz"], "'pr'")])
def test_cli_metrics_need_inception_and_known_names(argv, match, tmp_path):
    """--metrics (ported with the evaluator) takes fid, kid and fid_tryon
    and needs --inception; a bad request stops before the run starts."""
    with pytest.raises(ValueError, match=match):
        cli.main(["--outdir", str(tmp_path), "--data", "d", "--dry-run"]
                 + argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flag,value,want", [
    ("--pl_weight", "2", dict(pl_weight=2.0)),
    ("--contextual_weight", "1", dict(contextual_weight=1.0)),
    ("--grad-accum", "2", dict(grad_accum=2)),
    ("--reuse-g-fakes", "true", dict(reuse_g_fakes=True,
                                     strict_phase_noise=False)),
    ("--strict-phase-noise", "false", dict(strict_phase_noise=False))])
def test_cli_ported_flags_are_accepted(flag, value, want, tmp_path):
    """The training options' flags reach the config as the JAX CLI's do
    (--reuse-g-fakes true implies --strict-phase-noise false)."""
    from pasta_tpu.cli import train as jcli
    argv = ["--outdir", str(tmp_path), "--data", "d", flag, value]
    cli.main(argv + ["--dry-run"])
    (run,) = os.listdir(tmp_path)
    opts = json.load(open(os.path.join(tmp_path, run,
                                       "training_options.json")))
    ref = jcli.build_config(jcli.parse_args(argv + ["--devices", "1"]))
    for k, v in want.items():
        assert opts[k] == v == getattr(ref, k), k


@pytest.mark.parametrize("flag,n", [("--devices", 2), ("--gpus", 4)])
def test_cli_devices_set_the_ranks(flag, n, tmp_path):
    """--devices N (--gpus N) asks for N ranks over the global --batch; the
    run directory says so, as the JAX CLI's does."""
    from pasta_tpu.cli import train as jcli
    argv = ["--outdir", str(tmp_path), "--data", "d", flag, str(n)]
    cli.main(argv + ["--dry-run"])
    (run,) = os.listdir(tmp_path)
    assert run.endswith(f"-fashion-b32-d{n}")
    opts = json.load(open(os.path.join(tmp_path, run,
                                       "training_options.json")))
    ref = jcli.build_config(jcli.parse_args(argv))
    assert opts["data_axis_size"] == ref.data_axis_size == n
    assert opts["batch_size"] == ref.batch_size == 32


@pytest.mark.parametrize("argv", [
    ["--devices", "3"], ["--devices", "2", "--batch", "5"],
    ["--coordinator", "h:1", "--num-processes", "3", "--process-id", "0"]])
def test_cli_batch_that_does_not_divide_raises(argv, tmp_path):
    with pytest.raises(ValueError, match="data_axis_size"):
        cli.main(["--outdir", str(tmp_path), "--data", "d", "--dry-run"]
                 + argv)
    assert os.listdir(tmp_path) == []


def test_cli_devices_need_as_many_cards(tmp_path, monkeypatch):
    """--devices N on the card with fewer than N cards refuses before it
    starts anything: no rank is carried on the CPU, none dropped."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--devices 2"):
        cli.main(["--outdir", str(tmp_path), "--data", "d", "--devices",
                  "2"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [
    ["--coordinator", "h:1"],
    ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "2"],
    ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0",
     "--devices", "2"]])
def test_cli_coordinator_needs_its_flags(argv):
    with pytest.raises(ValueError, match="--"):
        cli.build_config(cli.parse_args(["--outdir", "o", "--data", "d"]
                                        + argv))


def test_cli_coordinator_sets_the_ranks():
    """--coordinator with P processes: P ranks, one card each (the JAX
    CLI's multi-host flags)."""
    cfg = cli.build_config(cli.parse_args([
        "--outdir", "o", "--data", "d", "--coordinator", "h:1",
        "--num-processes", "4", "--process-id", "3"]))
    assert cfg.data_axis_size == 4 and cfg.batch_per_device == 8


@pytest.mark.parametrize("flag", ["--step-mode", "--remat", "--ada-impl",
                                  "--d-remat"])
def test_cli_has_no_tpu_only_flags(flag):
    with pytest.raises(SystemExit):
        cli.parse_args(["--outdir", "o", "--data", "d", flag, "x"])


def test_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--outdir", str(tmp_path), "--data", "d"])
    assert os.listdir(tmp_path) == []


def test_cli_trains_from_a_zip_on_the_cpu(tmp_path):
    """The whole entry point: a zip root, the smoke config, two steps, then
    a resume from its checkpoint for one more."""
    data = str(tmp_path / "root.zip")
    write_dataset_root(data, 4, 90, as_zip=True)
    common = ["--outdir", str(tmp_path / "runs"), "--data", data, "--cfg",
              "smoke", "--device", "cpu", "--vgg_weight", "0", "--workers",
              "1", "--tick", "1", "--snap", "100", "--mirror", "1",
              "--subset", "3"]
    run = cli.main(common + ["--max-steps", "2"])
    assert sorted(n for n in os.listdir(run) if not n.startswith("events")) \
        == ["ckpt-000002.pt", "fakes000002.png", "fakes000002_parsing.png",
            "fakes000002_parsing_color.png", "log.txt", "stats.jsonl",
            "training_options.json"]
    assert [r["step"] for r in _rows(run)] == [1, 2]
    again = cli.main(common + ["--max-steps", "3", "--resume",
                               os.path.join(run, "ckpt-000002.pt")])
    assert again != run and [r["step"] for r in _rows(again)] == [3]
    state = pstate.init_state(pconfig.smoke_config(1, vgg_weight=0.0),
                              device="cpu")
    load_checkpoint(os.path.join(again, "ckpt-000003.pt"), state)
    assert state.step == 3


def test_cli_vgg_weights(tmp_path):
    """Without a file: a seeded random VGG19; with a torchvision-keyed file
    (.pth or .npz): those weights."""
    a, b = cli.load_vgg_params(None, seed=1), cli.load_vgg_params(None, seed=1)
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    assert not any(p.requires_grad for p in a.parameters())
    other = {k: v + 1 for k, v in sd.items()}
    torch.save(other, tmp_path / "vgg.pth")
    np.savez(tmp_path / "vgg.npz", **{k: v.numpy() for k, v in other.items()})
    for name in ("vgg.pth", "vgg.npz"):
        got = cli.load_vgg_params(str(tmp_path / name)).state_dict()
        assert all(torch.equal(got[k], v) for k, v in other.items()), name
