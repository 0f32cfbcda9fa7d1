"""The port's training snapshot: one file, `ckpt-<step:06d>.pt`.

`torch.save` of the four modules' state dicts (G, the image D, the parsing
D, the G-EMA), the three Adam state dicts and the scalars (`step`,
`cur_nimg`, `ada_p`, Gpl's `pl_mean`), written to a temporary name and
renamed into place, so that a reader never sees half a file (the JAX
package's orbax directory is atomic too). `load_checkpoint` restores a
`TrainState` in place, on whatever device its modules lie; a resumed run
continues from exactly the saved parameters, EMA, moments, `ada_p` and
`pl_mean` (0 in a file written before Gpl was ported). `io/npz_ckpt.py`
is the format that crosses to the JAX package.

With ranks, rank 0 writes (train/loop.py) and every rank reads the same
file onto its own card, so that every rank resumes with the same bits.
"""

from __future__ import annotations

import os

import torch

_MODULES = ("g", "d", "dp", "g_ema")
_OPTIMIZERS = ("g_opt", "d_opt", "dp_opt")


def save_checkpoint(path, state):
    """Write `state` (train/state.py::TrainState) to `path`, atomically."""
    payload = {name: getattr(state, name).state_dict()
               for name in _MODULES + _OPTIMIZERS}
    payload.update(step=int(state.step), cur_nimg=int(state.cur_nimg),
                   ada_p=float(state.ada_p), pl_mean=float(state.pl_mean))
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, state):
    """Restore `state` in place from a file of `save_checkpoint`; returns
    it. Strict: a missing or unexpected key raises. The file is read into
    host memory and each tensor copied onto the device of what it
    restores (each rank's card); Adam's step counters stay on the host,
    where torch's Adam reads them without a device sync."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for name in _MODULES:
        getattr(state, name).load_state_dict(payload[name], strict=True)
    for name in _OPTIMIZERS:
        getattr(state, name).load_state_dict(payload[name])
    state.step = int(payload["step"])
    state.cur_nimg = int(payload["cur_nimg"])
    state.ada_p = torch.tensor(payload["ada_p"], dtype=torch.float32,
                               device=state.ada_p.device)
    state.pl_mean = torch.tensor(payload.get("pl_mean", 0.0),
                                 dtype=torch.float32,
                                 device=state.pl_mean.device)
    return state


def load_module(path, name):
    """The state dict of one module (`name` in "g", "d", "dp", "g_ema") of
    a file of `save_checkpoint`, in host memory: an inference run loads
    the G-EMA alone."""
    if name not in _MODULES:
        raise ValueError(f"module {name!r}: not one of {_MODULES}")
    return torch.load(path, map_location="cpu", weights_only=True)[name]
