"""A training state as the JAX package's flat .npz, in both directions.

`pasta_tpu/io/npz_ckpt.py::save_npz_variables` flattens its `TrainState`
(`pasta_tpu/train/state.py`) into one array per leaf, keyed by the leaf's
path joined with "||": `.step`, `.cur_nimg`, `.ada_p`, `.pl_mean`,
`.g_params||<module path>`, `.g_buffers||...`, `.d_params||...`,
`.dp_params||...`, `.g_ema_params||...`, `.g_ema_buffers||...` and, for
each optax Adam, `.g_opt||[0]||.count`, `.g_opt||[0]||.mu||<module path>`,
`.g_opt||[0]||.nu||<module path>`. `save_npz_state` writes exactly these
keys from the port's `TrainState`, so `pasta_tpu.io.npz_ckpt.load_npz_into`
restores it, and `load_npz_state` reads a file of either package into the
port's state, in place.

Parameters and buffers cross by `io/from_jax.py`'s rules. Adam: optax keeps
one `count` for the optimizer and the moments `mu`, `nu` as trees shaped
like the parameters; torch keeps `step`, `exp_avg`, `exp_avg_sq` for each
parameter. Every parameter that a module's Adam holds takes part in each of
its updates (an unused one with a zero gradient), so the steps are equal
and one count stands for them.

Freeze-D: the JAX package wraps the image D's Adam in optax's
`multi_transform` ({"train": adam, "freeze": set_to_zero}), whose state
flattens to `.d_opt||.inner_states||train||.inner_state||[0]||.count`,
`...||.mu||<path>` and `...||.nu||<path>` for the trained parameters alone
(the frozen ones are masked out and `set_to_zero` keeps nothing). The
port's Adam leaves the frozen parameters out, so it writes and reads that
layout whenever it holds fewer parameters than its module has.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.state import trained_named_params
from .from_jax import (NPZ_SEP, discriminator_jax_to_state_dict,
                       discriminator_state_dict_to_jax, jax_to_state_dict,
                       state_dict_to_jax)

# TrainState field -> (optimizer field, the module is a discriminator)
_MODULES = {"g": ("g_opt", False), "d": ("d_opt", True),
            "dp": ("dp_opt", True)}
# where optax's multi_transform keeps the Adam state of the trained part
_MASKED = (".inner_states", "train", ".inner_state")


def _flatten(prefix, tree, out):
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(prefix + (key,), value, out)
        else:
            out[NPZ_SEP.join(prefix + (key,))] = value


def _subtree(flat, prefix):
    """The nested dict of every key under `prefix||`."""
    tree = {}
    lead = prefix + NPZ_SEP
    for key, value in flat.items():
        if not key.startswith(lead):
            continue
        node = tree
        segs = key[len(lead):].split(NPZ_SEP)
        for seg in segs[:-1]:
            node = node.setdefault(seg, {})
        node[segs[-1]] = value
    return tree


def _held(opt, module):
    """`trained_named_params(opt, module)`, and whether that is fewer than
    all (freeze-D)."""
    held = trained_named_params(opt, module)
    return held, len(held) < len(list(module.parameters()))


def _adam_lead(opt_field, masked):
    return NPZ_SEP.join((f".{opt_field}",) + (_MASKED if masked else ())
                        + ("[0]",))


def _adam_to_optax(opt, module):
    """(count, {name: exp_avg}, {name: exp_avg_sq}) of a torch Adam over the
    parameters of `module` it holds; zeros before its first step."""
    counts, mu, nu = set(), {}, {}
    for name, p in _held(opt, module)[0]:
        st = opt.state.get(p, {})
        if st:
            counts.add(int(st["step"]))
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            counts.add(0)
            mu[name] = nu[name] = torch.zeros_like(p)
    if len(counts) != 1:
        raise ValueError(f"Adam steps differ between parameters: {counts}")
    return counts.pop(), mu, nu


def save_npz_state(path, state):
    """Write the port's `TrainState` with the JAX package's flat keys."""
    flat = {".step": np.asarray(state.step, np.int32),
            ".cur_nimg": np.asarray(state.cur_nimg, np.int32),
            ".ada_p": np.asarray(float(state.ada_p), np.float32),
            ".pl_mean": np.asarray(float(state.pl_mean), np.float32)}
    for field, (opt_field, disc) in _MODULES.items():
        to_jax = discriminator_state_dict_to_jax if disc else state_dict_to_jax
        module, opt = getattr(state, field), getattr(state, opt_field)
        variables = to_jax(module.state_dict())
        _flatten((f".{field}_params",), variables["params"], flat)
        count, mu, nu = _adam_to_optax(opt, module)
        lead = _adam_lead(opt_field, _held(opt, module)[1])
        flat[lead + NPZ_SEP + ".count"] = np.asarray(count, np.int32)
        _flatten((lead, ".mu"), to_jax(mu)["params"], flat)
        _flatten((lead, ".nu"), to_jax(nu)["params"], flat)
    _flatten((".g_buffers",),
             state_dict_to_jax(state.g.state_dict())["buffers"], flat)
    ema = state_dict_to_jax(state.g_ema.state_dict())
    _flatten((".g_ema_params",), ema["params"], flat)
    _flatten((".g_ema_buffers",), ema["buffers"], flat)
    np.savez(path, **flat)


def load_npz_state(path, state):
    """Restore the port's `TrainState` in place from a flat .npz of either
    package; returns it. Strict: every parameter, buffer and moment of the
    state must be in the file."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    for field, (opt_field, disc) in _MODULES.items():
        to_sd = discriminator_jax_to_state_dict if disc else jax_to_state_dict
        module = getattr(state, field)
        variables = {"params": _subtree(flat, f".{field}_params")}
        if field == "g":
            variables["buffers"] = _subtree(flat, ".g_buffers")
        module.load_state_dict(to_sd(variables), strict=True)
        opt = getattr(state, opt_field)
        held, masked = _held(opt, module)
        lead = _adam_lead(opt_field, masked)
        count = float(flat[lead + NPZ_SEP + ".count"])
        # (with freeze-D the trees lack the top layers: the discriminator's
        # conversion needs only the epilogue, which is never frozen)
        mu = to_sd({"params": _subtree(flat, lead + NPZ_SEP + ".mu")})
        nu = to_sd({"params": _subtree(flat, lead + NPZ_SEP + ".nu")})
        if set(mu) != {name for name, _ in held}:
            raise ValueError(f"{opt_field}: the file's Adam moments are not "
                             "those of the parameters this state trains "
                             "(freeze_d_layers differs?)")
        opt.state.clear()
        for name, p in held:
            opt.state[p] = dict(
                step=torch.tensor(count, dtype=torch.float32),
                exp_avg=mu[name].to(p.device, p.dtype),
                exp_avg_sq=nu[name].to(p.device, p.dtype))
    state.g_ema.load_state_dict(jax_to_state_dict(
        {"params": _subtree(flat, ".g_ema_params"),
         "buffers": _subtree(flat, ".g_ema_buffers")}), strict=True)
    state.step = int(flat[".step"])
    state.cur_nimg = int(flat[".cur_nimg"])
    state.ada_p = torch.tensor(float(flat[".ada_p"]), dtype=torch.float32,
                               device=state.ada_p.device)
    state.pl_mean = torch.tensor(float(flat[".pl_mean"]), dtype=torch.float32,
                                 device=state.pl_mean.device)
    return state

