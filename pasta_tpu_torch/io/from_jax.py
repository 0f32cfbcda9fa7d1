"""Carry JAX-package generator weights into the port.

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
