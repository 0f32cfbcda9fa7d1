"""The port's training snapshot: one file, `ckpt-<step:06d>.pt`.

`torch.save` of the four modules' state dicts (G, the image D, the parsing
D, the G-EMA), the three Adam state dicts and the scalars (`step`,
`cur_nimg`, `ada_p`), written to a temporary name and renamed into place,
so that a reader never sees half a file (the JAX package's orbax directory
is atomic too). `load_checkpoint` restores a `TrainState` in place, on
whatever device its modules lie; a resumed run continues from exactly the
saved parameters, EMA, moments and `ada_p`. `io/npz_ckpt.py` is the format
that crosses to the JAX package.
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
                   ada_p=float(state.ada_p))
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, state):
    """Restore `state` in place from a file of `save_checkpoint`; returns
    it. Strict: a missing or unexpected key raises."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for name in _MODULES:
        getattr(state, name).load_state_dict(payload[name], strict=True)
    for name in _OPTIMIZERS:
        getattr(state, name).load_state_dict(payload[name])
    state.step = int(payload["step"])
    state.cur_nimg = int(payload["cur_nimg"])
    state.ada_p = torch.tensor(payload["ada_p"], dtype=torch.float32,
                               device=state.ada_p.device)
    return state
