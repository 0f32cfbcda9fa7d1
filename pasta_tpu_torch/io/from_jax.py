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
The detectors of the metrics: `inception_jax_to_state_dict` inverts
`metrics/inception.py::import_inception_torch_state` and
`vgg16_jax_to_state_dict` inverts `metrics/vgg16.py::import_vgg16_torch_state`
(the LPIPS lin weights included), so both packages run the same seeded
detectors.

The way back, for a training state saved by the port and read by the JAX
package: `state_dict_to_jax` and `discriminator_state_dict_to_jax` are the
port's own copy of `import_generator_state` / `import_discriminator_state`
(the same name mapping and layout rules, on {name: numpy array}), so
`jax_to_state_dict(state_dict_to_jax(sd)) == sd`. They serve Adam's moments
too, which have their parameters' names and layouts.
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


def _detector_state(tree):
    """Nested detector tree -> dotted keys, conv weights HWIO -> OIHW (the
    4-d leaves; the fc weights are [out, in] in both layouts)."""
    state = {}
    for path, value in _flatten(tree):
        value = np.asarray(value, np.float32)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        state[".".join(path)] = torch.from_numpy(np.array(value))
    return state


def inception_jax_to_state_dict(
        params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 tree (`random_inception_params`,
    `import_inception_torch_state`) -> the port's InceptionV3 state dict
    (torchvision keys without the auxiliary head)."""
    return _detector_state(params)


def vgg16_jax_to_state_dict(
        params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG16 tree ({"features", "classifier", "lins"})
    -> the port's VGG16 state dict (torchvision keys, `lins.{k}`)."""
    return _detector_state(params)


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


# torch containers whose children are named by index ("model.0", ...); the
# JAX package keeps the joined name as a single module key.
_SEQ_PREFIXES = ("model", "feat_enc", "spade_encoder")
_BUFFER_LEAVES = ("noise_const", "w_avg")


def _key_to_jax_path(key):
    """Port state-dict key -> (JAX path segments, "params" | "buffers")."""
    parts = key.split(".")
    merged = []
    i = 0
    while i < len(parts):
        if (parts[i] in _SEQ_PREFIXES and i + 1 < len(parts)
                and parts[i + 1].isdigit()):
            merged.append(parts[i] + "." + parts[i + 1])
            i += 2
        else:
            merged.append(parts[i])
            i += 1
    leaf = merged[-1]
    collection = "buffers" if leaf in _BUFFER_LEAVES else "params"
    if len(merged) >= 2 and merged[-2] == "linear":
        merged[-1] = {"weight": "kernel", "bias": "bias"}[leaf]
    return tuple(merged), collection


def _leaf_to_jax(path, value, epilogue_fc):
    leaf = path[-1]
    if leaf == "kernel":                               # [O, I] -> [I, O]
        return value.T
    if leaf in ("weight", "m_weight1", "m_weight2") and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)             # OIHW -> HWIO
    if (epilogue_fc and leaf == "weight" and value.ndim == 2
            and path[-3:-1] == ("b4", "fc")):
        out_f, in_f = value.shape                      # CHW -> HWC flatten
        side = _EPILOGUE_RESOLUTION
        return (value.reshape(out_f, in_f // (side * side), side, side)
                .transpose(0, 2, 3, 1).reshape(out_f, in_f))
    return value


def _to_jax(state, epilogue_fc):
    out = {"params": {}, "buffers": {}}
    for key, value in state.items():
        value = (value.detach().cpu().numpy() if torch.is_tensor(value)
                 else np.asarray(value))
        path, collection = _key_to_jax_path(key)
        node = out[collection]
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        # own C-ordered copy (np.ascontiguousarray would make 0-d 1-d)
        node[path[-1]] = np.array(_leaf_to_jax(path, value, epilogue_fc),
                                  order="C")
    return out


def state_dict_to_jax(state) -> Dict[str, Any]:
    """Port Generator state dict (tensors or numpy arrays by name) -> the
    JAX package's {"params", "buffers"} trees with numpy leaves."""
    return _to_jax(state, epilogue_fc=False)


def discriminator_state_dict_to_jax(state) -> Dict[str, Any]:
    """Port Discriminator state dict -> the JAX package's {"params"} tree;
    the epilogue fc weight goes from CHW to HWC flatten order."""
    return _to_jax(state, epilogue_fc=True)
