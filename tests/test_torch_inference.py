"""The try-on inference run of the port against the JAX package's, on the
CPU: `TryonPairDataset` and `to_model_inputs` over a synthetic root written under tmp_path (the pairs
file inside the root and outside it), and `cli.test.main --device cpu
--pipeline parity` against the JAX `cli.test.main` on the same `.npz`
(written with `pasta_tpu.io.npz_ckpt.save_npz_variables` from the port's
seeded weights, carried by `import_generator_state`; the serving pipeline's
twin is in tests/test_torch_stream.py). Then the weight formats of
`--network`, the entry points' refusal without a card, and the fp32 pin
(TF32 off) in every entry point and spawned rank. tests/test_torch_host.py
holds `preprocess_pair` itself.

Host arrays are `np.array_equal`. Both packages decode through their
native plugins where built (tests/test_torch_native.py holds the two
equal). The generators run the narrow 512px config (channel_base=2048,
channel_max=128) in fp32, patched into both CLIs' `models.Generator`. The
composites' clothes and person columns are equal; the generated column is
held to the serving budget of tests/test_torch_serving.py on its 0..255
values: 2% of values off by more than 1e-2 of the range (2.55), a mean
absolute difference under 1e-3 of it (the SPADE routing's argmax may flip
where two parsing logits tie within fp32 conv noise).
"""

import functools
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import pasta_tpu.models as jmodels
from pasta_tpu.cli import test as jcli_test
from pasta_tpu.data import testsets as jtestsets
from pasta_tpu.io.npz_ckpt import save_npz_variables
from pasta_tpu.io.torch_import import import_generator_state, state_dict_to_numpy
from pasta_tpu_torch import models
from pasta_tpu_torch.cli import bench
from pasta_tpu_torch.cli import test as cli_test
from pasta_tpu_torch.data import testsets
from pasta_tpu_torch.data.synthetic import write_tryon_root

NARROW = dict(img_resolution=512, channel_base=2048, channel_max=128,
              conv_clamp=256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PERSONS = 5


def _equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple, str)):
        assert a == b if isinstance(a, str) else len(a) == len(b), what
        if not isinstance(a, str):
            for i, (x, y) in enumerate(zip(a, b)):
                _equal(x, y, f"{what}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs these files beside others on every core: two
    intra-op threads a worker keep the 512px forwards from thrashing."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("testroot") / "root")
    return path, write_tryon_root(path, N_PERSONS, seed=80)


@pytest.mark.parametrize("mode", ["upper", "lower", "full"])
def test_dataset_and_model_inputs_equal_original(root, mode, tmp_path):
    path, pairs = root
    outside = tmp_path / "pairs_outside.txt"
    outside.write_text("".join(f"{c} {p}\n" for p, c in pairs[:2]))
    for pairs_txt in ("test_pairs.txt", str(outside)):
        got = testsets.TryonPairDataset(path, pairs_txt, mode=mode)
        ref = jtestsets.TryonPairDataset(path, pairs_txt, mode=mode)
        assert got.pairs == ref.pairs
        assert len(got) == (N_PERSONS if pairs_txt == "test_pairs.txt"
                            else 2)
        items, jitems = list(got), list(ref)
        for i, (a, b) in enumerate(zip(items, jitems)):
            _equal(a, b, f"item {i} ({pairs_txt}, {mode})")
        _equal(testsets.to_model_inputs(items),
               jtestsets.to_model_inputs(jitems), "to_model_inputs")


def test_cli_parity_matches_jax(root, tmp_path):
    """Both CLIs over three pairs at batch 2 (a padded tail batch of 1),
    --pipeline parity, one .npz: one composite per pair, the clothes and
    person columns equal, the generated column within the budget."""
    path, pairs = root
    torch.manual_seed(0)
    npz = str(tmp_path / "g.npz")
    save_npz_variables(npz, import_generator_state(state_dict_to_numpy(
        models.Generator(seed=0, **NARROW))))
    (tmp_path / "three.txt").write_text(
        "".join(f"{c} {p}\n" for p, c in pairs[:3]))
    port_g = models.Generator

    class Narrow(port_g):
        def __init__(self, **kw):
            super().__init__(**{**kw, **NARROW, "seed": 1})

    argv = ["--network", npz, "--dataroot", path, "--testtxt",
            str(tmp_path / "three.txt"), "--testpart", "upper",
            "--batchsize", "2", "--pipeline", "parity"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, "Generator", Narrow)
        mp.setattr(jmodels, "Generator",
                   functools.partial(jmodels.Generator, **NARROW))
        assert cli_test.main(argv + ["--outdir", str(tmp_path / "port"),
                                     "--device", "cpu"]) == 3
        jcli_test.main(argv + ["--outdir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"{p[:-4]}___{c[:-4]}.png" for p, c in pairs[:3])
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / name)).astype(np.float64)
        ref = cv2.imread(str(tmp_path / "jax" / name)).astype(np.float64)
        assert got.shape == ref.shape == (512, 960, 3)
        assert np.array_equal(got[:, :640], ref[:, :640]), name
        diff = np.abs(got[:, 640:] - ref[:, 640:])
        assert np.mean(diff > 2.55) <= 2e-2, name
        assert diff.mean() <= 1e-3 * 255, (name, diff.mean())
        assert np.ptp(got[:, 640:]) > 0, name


def test_pt_checkpoint_loads_g_ema(tmp_path):
    """A training snapshot (`io/checkpoint.save_checkpoint`, which
    cli.train's loop writes) gives its G-EMA to --network."""
    from pasta_tpu_torch.io.checkpoint import load_module, save_checkpoint
    from pasta_tpu_torch.train.config import smoke_config
    from pasta_tpu_torch.train.state import init_state, make_models

    cfg = smoke_config(1)
    state = init_state(cfg, seed=3, device="cpu")
    with torch.no_grad():
        for p in state.g_ema.parameters():
            p.add_(0.25)               # the EMA apart from G
    path = str(tmp_path / "ckpt-000004.pt")
    save_checkpoint(path, state)
    g = make_models(cfg, seed=9)[0]
    assert cli_test.load_generator_weights(g, path) is g
    want = state.g_ema.state_dict()
    for k, v in g.state_dict().items():
        assert torch.equal(v, want[k]), k
    g_state = load_module(path, "g")
    assert not all(torch.equal(g_state[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="g_ema"):
        load_module(path, "vgg")


def test_network_formats_that_raise(tmp_path, monkeypatch):
    g = models.Generator(seed=0, img_resolution=64, channel_base=256,
                         channel_max=16)
    # a .pkl is read (io/legacy_pkl.py) but needs the reference tree:
    # without one, the JAX module's error
    monkeypatch.setenv("PASTA_REFERENCE_ROOT", str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="PASTA_REFERENCE_ROOT"):
        cli_test.load_generator_weights(g, str(tmp_path / "network.pkl"))
    with pytest.raises(NotImplementedError, match="orbax"):
        cli_test.load_generator_weights(g, str(tmp_path))
    with pytest.raises(ValueError, match="not a .npz, .pt or .pkl"):
        cli_test.load_generator_weights(g, str(tmp_path / "g.onnx"))
    assert cli_test.load_generator_weights(g, None) is g


def test_entry_points_refuse_without_a_card(root, monkeypatch, tmp_path):
    """On the card unless the caller asks for the CPU: without one, the
    CLIs stop and do not quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_test.main(["--dataroot", root[0], "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code == 2
    assert not os.listdir(tmp_path)


def test_fp32_numerics_pinned_in_every_entry_point(root, tmp_path):
    """TF32 off after cli.train.main --dry-run and after a cli.test run, in
    a fresh process (where PyTorch leaves cuDNN's TF32 on), and in a rank
    that train/entry.py::spawn starts."""
    code = f"""
import functools, sys, torch
from pasta_tpu_torch import models
from pasta_tpu_torch.cli import test, train
flags = lambda: (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
print("default", flags())
train.main(["--device", "cpu", "--dry-run", "--outdir", {str(tmp_path)!r},
            "--data", "unused"])
print("train", flags())
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
models.Generator = functools.partial(models.Generator, **{NARROW!r})
test.main(["--dataroot", {root[0]!r}, "--testtxt", {str(tmp_path / "one.txt")!r},
           "--outdir", {str(tmp_path / "out")!r}, "--device", "cpu"])
print("test", flags())
"""
    (tmp_path / "one.txt").write_text(f"{root[1][1][1]} {root[1][0][0]}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("default", "train", "test"))
    assert lines == {"default": "(True, False)", "train": "(False, False)",
                     "test": "(False, False)"}, res.stdout
    assert len(os.listdir(tmp_path / "out")) == 1

    import torch_dist_ranks as ranks

    torch.backends.cudnn.allow_tf32 = True
    try:
        got = ranks.run(1, "numerics", None, tmp_path)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert got == [dict(cudnn=False, matmul=False)]
