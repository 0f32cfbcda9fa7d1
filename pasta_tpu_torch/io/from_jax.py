"""Carry JAX-package weights (generator, discriminators, VGG19) into the
port.

`jax_to_state_dict` is the exact inverse of
`pasta_tpu/io/torch_import.py::import_generator_state`: the variable tree
{"params", "buffers"} with numpy leaves (as `io/npz_ckpt.load_npz_variables`
gives it) becomes a strict-loadable state dict for the port's `Generator`:

  * path segments join with '.' (a flax key such as "model.0" already is
    the joined torch name)
  * conv weights [kh, kw, I, O] -> [O, I, kh, kw]   (HWIO -> OIHW)
  * flax nn.Dense `linear/kernel` [I, O] -> torch `linear.weight` [O, I]
  * the `buffers` collection (noise_const, w_avg) -> buffers
  * resample_filter is a non-persistent buffer of the port (recomputed)

`discriminator_jax_to_state_dict` inverts `import_discriminator_state`
(the same rules, plus the epilogue fc: the JAX package flattens the 4x4
features NHWC, the reference and the port NCHW), and
`vgg19_jax_to_state_dict` inverts `losses/vgg.py::import_vgg19_torch_state`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

NPZ_SEP = "||"  # separator of pasta_tpu/io/npz_ckpt.py's flat keys


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _leaf_to_torch(path, value):
    value = np.asarray(value)
    leaf = path[-1]
    if leaf == "kernel" and len(path) >= 2 and path[-2] == "linear":
        return ".".join(path[:-1] + ("weight",)), value.T
    if leaf in ("weight", "m_weight1", "m_weight2") and value.ndim == 4:
        return ".".join(path), value.transpose(3, 2, 0, 1)
    return ".".join(path), value


def jax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-package generator variables (numpy leaves) -> port state dict."""
    state = {}
    for collection in ("params", "buffers"):
        for path, value in _flatten(variables.get(collection, {})):
            key, arr = _leaf_to_torch(path, value)
            state[key] = torch.from_numpy(np.array(arr))   # own, writable copy
    return state


_EPILOGUE_RESOLUTION = 4  # the discriminator epilogue sits at 4x4


def discriminator_jax_to_state_dict(
        variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-package Discriminator variables (numpy leaves) -> port state
    dict; the epilogue fc weight goes from HWC to CHW flatten order."""
    state = jax_to_state_dict(variables)
    w = state["b4.fc.weight"]
    out_f, in_f = w.shape
    side = _EPILOGUE_RESOLUTION
    c = in_f // (side * side)
    state["b4.fc.weight"] = (w.reshape(out_f, side, side, c)
                             .permute(0, 3, 1, 2).reshape(out_f, in_f)
                             .contiguous())
    return state


def vgg19_jax_to_state_dict(
        variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-package VGG19Features params ({"params": {"conv{i}_kernel",
    "conv{i}_bias"}}) -> torchvision-keyed port state dict."""
    state = {}
    for name, value in variables["params"].items():
        idx, leaf = name[len("conv"):].split("_")
        value = np.asarray(value)
        if leaf == "kernel":
            state[f"features.{idx}.weight"] = torch.from_numpy(
                np.array(value.transpose(3, 2, 0, 1)))
        else:
            state[f"features.{idx}.bias"] = torch.from_numpy(np.array(value))
    return state


def load_npz(path) -> Dict[str, torch.Tensor]:
    """A generator checkpoint saved by `pasta_tpu.io.npz_ckpt`
    (`save_npz_variables`) -> port state dict, with numpy alone."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            segs = key.split(NPZ_SEP)
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = data[key]
    return jax_to_state_dict(tree)
