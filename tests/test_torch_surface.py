"""The port's smaller modules against the JAX package's, on the CPU:

* `shapes.py`: `assert_shape` / `assert_batch_shapes` raise the JAX
  package's AssertionError text, word for word, and the Generator, the
  Discriminator and `assemble_inputs_device` check their inputs with it.
* `summary.py::print_module_summary`: the table's parameter and buffer
  totals equal the JAX package's `_count` of the same modules' variables
  (an abstract JAX init, `jax.eval_shape`) for G and D at 64 px.
* `io/fetch.py`: the cases of tests/test_fetch.py, and the same http-gate
  text.
* `cli/dataset_tool.py`: both packages' CLIs on one source root give the
  same member names and file contents (zip and directory), and the port's
  data roots and training dataset read what it wrote.
* `io/legacy_pkl.py`: a persistence-style stand-in snapshot written under
  tmp_path (objects that pickle as their class's source, rebuilt by a
  stand-in `torch_utils/persistence.py` that is importable only from the
  stand-in reference tree at $PASTA_REFERENCE_ROOT) loads into the port's
  Generator and Discriminator strictly and bit for bit, equals the JAX
  importer's variables of the same pickle, and feeds `cli.test
  --network x.pkl`; without the tree, the JAX module's error text.

All comparisons are exact (counts, text, bytes, tensors).
"""

import os
import pickle
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pasta_tpu import serving as jserving
from pasta_tpu import shapes as jshapes
from pasta_tpu import summary as jsummary
from pasta_tpu.cli import dataset_tool as jtool
from pasta_tpu.io import fetch as jfetch
from pasta_tpu.io import legacy_pkl as jlegacy
from pasta_tpu.models import Discriminator as JaxDiscriminator
from pasta_tpu.models import Generator as JaxGenerator
from pasta_tpu_torch import serving, shapes, summary
from pasta_tpu_torch.cli import dataset_tool as tool
from pasta_tpu_torch.cli import test as cli_test
from pasta_tpu_torch.data.roots import as_root
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.data.trainsets import TryonTrainDataset
from pasta_tpu_torch.io import fetch, legacy_pkl
from pasta_tpu_torch.io.from_jax import (discriminator_state_dict_to_jax,
                                         state_dict_to_jax)
from pasta_tpu_torch.models import Discriminator, Generator

SMALL = dict(img_resolution=64, channel_base=2048, channel_max=128,
             conv_clamp=256)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _raised(fn, *args, **kw):
    with pytest.raises(AssertionError) as info:
        fn(*args, **kw)
    return str(info.value)


def _gen_inputs(n, res, lib):
    rng = np.random.RandomState(0)
    arrays = dict(
        z=np.zeros((n, 0), np.float32),
        c=rng.randn(n, res // 4, res // 4, 45),
        retain=rng.randn(n, res, res, 6), pose=rng.randn(n, res, res, 5),
        denorm_upper_input=rng.randn(n, res, res, 3),
        denorm_lower_input=rng.randn(n, res, res, 3),
        denorm_upper_mask=rng.rand(n, res, res, 1) > 0.5,
        denorm_lower_mask=rng.rand(n, res, res, 1) > 0.5)
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return {k: conv(np.asarray(v, np.float32)) for k, v in arrays.items()}


# --- shapes -----------------------------------------------------------------

@pytest.mark.parametrize("shape,ref,name", [
    ((2, 8, 8, 3), (None, 8, 8, 1), "img"),
    ((2, 8, 8, 3), (None, 8, 8), None),
    ((2, 8, 8, 3), (3, None, None, 3), "c")])
def test_assert_shape_text(shape, ref, name):
    got = _raised(shapes.assert_shape, torch.zeros(shape), ref, name=name)
    assert got == _raised(jshapes.assert_shape, jnp.zeros(shape), ref,
                          name=name)
    shapes.assert_shape(torch.zeros(shape), shape)
    batch = {"a": torch.zeros(shape)}
    assert (_raised(shapes.assert_batch_shapes, batch, {"a": ref, "b": ()})
            == _raised(jshapes.assert_batch_shapes,
                       {"a": jnp.zeros(shape)}, {"a": ref, "b": ()}))


def test_models_check_their_inputs():
    """A channels-first mix-up fails at the boundary by name, with the JAX
    models' text (the JAX side traced abstractly)."""
    pin = _gen_inputs(2, 64, "torch")
    jin = _gen_inputs(2, 64, "jax")
    pin["pose"] = pin["pose"].permute(0, 3, 1, 2)
    jin["pose"] = jnp.transpose(jin["pose"], (0, 3, 1, 2))
    got = _raised(Generator(seed=0, **SMALL), **pin)
    jg = JaxGenerator(**SMALL)
    ref = _raised(jax.eval_shape, lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        **jin))
    assert got == ref and "pose" in got
    img = np.zeros((2, 64, 64, 5), np.float32)
    jd = JaxDiscriminator(c_dim=0, img_resolution=64, img_channels=6)
    d = Discriminator(c_dim=0, img_resolution=64, img_channels=6, seed=0)
    got = _raised(d, torch.from_numpy(img), None)
    ref = _raised(jax.eval_shape, lambda: jd.init(
        jax.random.PRNGKey(0), jnp.asarray(img), None))
    assert got == ref and "img" in got


def test_assemble_checks_the_host_batch():
    res = 16
    host = {k: np.zeros((1, res, res, 3 if k in ("upper_img", "lower_img",
                                                  "image") else 1),
                        np.uint8)
            for k in ("upper_img", "lower_img", "upper_mask", "lower_mask",
                      "sleeve", "image", "retain_mask", "bound")}
    host["pose"] = np.zeros((1, 3, res, res), np.uint8)    # channels first
    host["label_cls"] = np.zeros((1,), np.uint8)
    got = _raised(serving.assemble_inputs_device,
                  {k: torch.from_numpy(v) for k, v in host.items()}, "upper")
    ref = _raised(jserving.assemble_inputs_device,
                  {k: jnp.asarray(v) for k, v in host.items()}, "upper")
    assert got == ref and "host[pose]" in got


# --- summary ----------------------------------------------------------------

def test_module_summary_totals(capsys):
    g = Generator(seed=0, **SMALL)
    table = summary.print_module_summary(g, **_gen_inputs(1, 64, "torch"),
                                         noise_mode="const")
    assert table in capsys.readouterr().out
    jg = JaxGenerator(**SMALL)
    jvars = jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        **_gen_inputs(1, 64, "jax")))
    total = table.splitlines()[-1].split()
    assert total[:3] == ["Total", str(jsummary._count(jvars["params"])),
                         str(jsummary._count(jvars["buffers"]))]
    assert "synthesis" in table and "[1, 64, 64, 3]" in table

    d = Discriminator(c_dim=0, img_resolution=64, img_channels=6, seed=0)
    img = np.zeros((2, 64, 64, 6), np.float32)
    table = summary.print_module_summary(d, torch.from_numpy(img), None,
                                         max_depth=1)
    jd = JaxDiscriminator(c_dim=0, img_resolution=64, img_channels=6)
    jvars = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0),
                                           jnp.asarray(img), None))
    assert table.splitlines()[-1].split()[:3] == [
        "Total", str(jsummary._count(jvars["params"])), "0"]
    assert "b4" in table and "[2, 1]" in table


# --- fetch ------------------------------------------------------------------

def test_fetch_local_and_missing(tmp_path):
    p = tmp_path / "weights.npz"
    p.write_bytes(b"abc")
    assert fetch.fetch_path(str(p)) == str(p)
    with pytest.raises(FileNotFoundError):
        fetch.fetch_path(str(tmp_path / "nope.bin"))


def test_fetch_file_url_cached_copy(tmp_path, monkeypatch):
    monkeypatch.setenv("PASTA_CACHE_DIR", str(tmp_path / "cache"))
    src = tmp_path / "detector.bin"
    src.write_bytes(b"\x00\x01\x02")
    url = src.as_uri()
    got = fetch.fetch_path(url)
    assert got != str(src) and os.path.isfile(got)
    assert got.startswith(str(tmp_path / "cache"))
    with fetch.open_url(url) as f:
        assert f.read() == b"\x00\x01\x02"
    src.unlink()                  # the cached copy outlives its source
    assert fetch.fetch_path(url) == got


def test_fetch_http_gated_off(monkeypatch):
    monkeypatch.delenv("PASTA_ALLOW_NETWORK", raising=False)
    url = "https://example.com/weights.pkl"
    texts = []
    for module in (fetch, jfetch):
        with pytest.raises(RuntimeError, match="zero-egress") as info:
            module.fetch_path(url)
        texts.append(str(info.value))
    assert texts[0] == texts[1]


# --- dataset_tool -----------------------------------------------------------

def _members(dest):
    if dest.endswith(".zip"):
        with zipfile.ZipFile(dest) as zf:
            return {n: zf.read(n) for n in zf.namelist()}
    out = {}
    for base, _, files in os.walk(dest):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, dest)] = f.read()
    return out


def test_dataset_tool_matches_jax(tmp_path, capsys):
    src = str(tmp_path / "src")
    names = write_dataset_root(src, 3, 90)
    os.remove(os.path.join(src, "parsing", names[1][:-4] + ".png"))
    with open(tmp_path / "list.txt", "w") as f:
        f.write("".join(f"{n} x\n" for n in names))
    for ext in (".zip", ""):
        dests = [str(tmp_path / f"{pkg}{ext}") for pkg in ("port", "jax")]
        argv = ["--source", src, "--txts", str(tmp_path / "list.txt")]
        tool.main(argv + ["--dest", dests[0]])
        port_log = capsys.readouterr().out
        jtool.main(argv + ["--dest", dests[1]])
        assert port_log.replace(dests[0], "") == \
            capsys.readouterr().out.replace(dests[1], "")
        got, ref = _members(dests[0]), _members(dests[1])
        assert sorted(got) == sorted(ref) and got == ref
        assert "skip" in port_log          # the person without a parsing
    root = as_root(str(tmp_path / "port.zip"))
    assert sorted(root.list("image")) == sorted([names[0], names[2]])
    assert len(TryonTrainDataset(str(tmp_path / "port.zip"), seed=0)) == 2


# --- legacy_pkl -------------------------------------------------------------

_PERSISTENCE = '''
"""Stand-in of the reference's torch_utils/persistence.py: an object
pickles as its class's source, its class name and its state; loading
execs the source into a fresh module (persistence.py:_src_to_module)."""
import sys
import types
import uuid


def _src_to_module(src):
    name = "_imported_module_" + uuid.uuid4().hex
    module = types.ModuleType(name)
    sys.modules[name] = module
    exec(src, module.__dict__)
    return module


def _reconstruct_persistent_obj(meta):
    module = _src_to_module(meta["module_src"])
    return getattr(module, meta["class_name"])(meta["state"])
'''

_NETWORK_SRC = textwrap.dedent('''
    import torch


    class Network(torch.nn.Module):
        """Holds a reference network's tensors under their state-dict
        names."""

        def __init__(self, state):
            super().__init__()
            for key, value in state.items():
                *path, leaf = key.split(".")
                mod = self
                for seg in path:
                    if not hasattr(mod, seg):
                        mod.add_module(seg, torch.nn.Module())
                    mod = getattr(mod, seg)
                mod.register_buffer(leaf, value.clone())
''')


@pytest.fixture
def reference_tree(tmp_path, monkeypatch):
    root = tmp_path / "reference"
    (root / "torch_utils").mkdir(parents=True)
    (root / "torch_utils" / "__init__.py").write_text("")
    (root / "torch_utils" / "persistence.py").write_text(_PERSISTENCE)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [n for n in sys.modules if n.startswith("torch_utils")]:
        monkeypatch.delitem(sys.modules, name)
    yield str(root)
    for name in [n for n in sys.modules if n.startswith("torch_utils")]:
        del sys.modules[name]


def _snapshot(root, path, modules):
    """Pickle {name: stand-in network} with the stand-in persistence
    importable for the dump only."""
    sys.path.insert(0, root)
    try:
        from torch_utils import persistence

        class Persistent:
            def __init__(self, state):
                self.state = state

            def __reduce__(self):
                return (persistence._reconstruct_persistent_obj, (dict(
                    module_src=_NETWORK_SRC, class_name="Network",
                    state=self.state),))

        snap = {k: Persistent(v) for k, v in modules.items()}
        snap.update(augment_pipe=None, training_set_kwargs={})
        with open(path, "wb") as f:
            pickle.dump(snap, f)
    finally:
        sys.path.remove(root)
        for name in [n for n in sys.modules if n.startswith("torch_utils")]:
            del sys.modules[name]


def test_legacy_pickle_loads_into_the_port(reference_tree, tmp_path,
                                           monkeypatch):
    g = Generator(seed=3, **SMALL)
    d = Discriminator(c_dim=0, img_resolution=64, img_channels=6, seed=4)
    extra = {"synthesis.b64.conv0.resample_filter": torch.ones(4, 4),
             "synthesis.b8.const": torch.ones(8, 8, 8)}
    path = str(tmp_path / "network-snapshot-000000.pkl")
    _snapshot(reference_tree, path, {"G_ema": {**g.state_dict(), **extra},
                                     "G": g.state_dict(),
                                     "D": d.state_dict(),
                                     "D_parsing": d.state_dict()})
    monkeypatch.setenv("PASTA_REFERENCE_ROOT", reference_tree)
    state = legacy_pkl.load_reference_pickle_generator(path)
    g2 = Generator(seed=9, **SMALL)
    g2.load_state_dict(state, strict=True)
    for k, v in g.state_dict().items():
        assert torch.equal(g2.state_dict()[k], v), k
    d2 = Discriminator(c_dim=0, img_resolution=64, img_channels=6, seed=0)
    d2.load_state_dict(legacy_pkl.load_reference_pickle_discriminator(
        path, key="D_parsing"), strict=True)
    assert all(torch.equal(d2.state_dict()[k], v)
               for k, v in d.state_dict().items())
    g3 = cli_test.load_generator_weights(Generator(seed=7, **SMALL), path)
    assert all(torch.equal(g3.state_dict()[k], v)
               for k, v in g.state_dict().items())
    # the JAX importer reads the same pickle into the same variables
    monkeypatch.setattr(jlegacy, "REFERENCE_ROOT", reference_tree)
    for name in [n for n in sys.modules if n.startswith("torch_utils")]:
        del sys.modules[name]
    jvars = jlegacy.load_reference_pickle_generator(path)
    want = state_dict_to_jax(g.state_dict())
    for tree, ref in ((jvars, want),
                      (jlegacy.load_reference_pickle_discriminator(path),
                       discriminator_state_dict_to_jax(d.state_dict()))):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
        assert len(flat) == len(flat_ref)
        for key, leaf in flat:
            np.testing.assert_array_equal(np.asarray(leaf), flat_ref[key])


def test_legacy_pickle_needs_the_reference_tree(tmp_path, monkeypatch):
    missing = str(tmp_path / "no-reference")
    monkeypatch.setenv("PASTA_REFERENCE_ROOT", missing)
    monkeypatch.setattr(jlegacy, "REFERENCE_ROOT", missing)
    texts = []
    for load in (legacy_pkl.load_reference_pickle_generator,
                 jlegacy.load_reference_pickle_generator):
        with pytest.raises(RuntimeError, match="PASTA_REFERENCE_ROOT") as e:
            load(str(tmp_path / "network.pkl"))
        texts.append(str(e.value))
    assert texts[0] == texts[1]
