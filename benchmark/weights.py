"""Seeded weights of a model, made on its device in a few large calls.

The reference model, built on the meta device, says each leaf's name,
shape and initialiser (normal with a std, uniform with a limit, or a
constant); every normal leaf is a slice of one `torch.randn` draw and
every uniform leaf a slice of one `torch.rand` draw, both from a
`torch.Generator` on the device seeded with the run's seed. The result is
a state dict by the reference's names, which the port's modules load too.
"""

from __future__ import annotations

import torch


def init_specs(model):
    """[(state-dict name, shape, Init)] of every leaf with an initialiser."""
    specs = []
    for prefix, module in model.named_modules():
        for name, init in module.__dict__.get("_inits", {}).items():
            full = f"{prefix}.{name}" if prefix else name
            specs.append((full, tuple(getattr(module, name).shape), init))
    return specs


def seeded_state(specs, seed, device, overrides=None):
    """The state dict of `specs` drawn from `seed` on `device` (fp32).
    `overrides` maps a leaf's last name component to a constant that every
    such leaf takes instead of its initialiser."""
    overrides = overrides or {}
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in specs:
        if init.kind in sizes:
            sizes[init.kind] += torch.Size(shape).numel()
    draws = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen,
                              device=device).mul_(2).sub_(1),
    }
    offset = {"normal": 0, "uniform": 0}
    state = {}
    for name, shape, init in specs:
        leaf = name.rsplit(".", 1)[-1]
        if leaf in overrides:
            state[name] = torch.full(shape, float(overrides[leaf]),
                                     device=device)
        elif init.kind in draws:
            n = torch.Size(shape).numel()
            flat = draws[init.kind][offset[init.kind]:offset[init.kind] + n]
            state[name] = flat.view(shape) * init.value
            offset[init.kind] += n
        else:
            state[name] = torch.full(shape, float(init.value), device=device)
    return state
