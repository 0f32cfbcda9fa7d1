"""Module summaries, port of pasta_tpu/summary.py: the per-submodule table
of the reference's startup smoke test (torch_utils/misc.py:201-269,
training_loop_fullbody.py:421-435) and the training state's one-line
parameter accounting, which the training loop prints."""

from __future__ import annotations

import torch


def _count(tensors):
    return sum(t.numel() for t in tensors)


def _persistent_buffers(module):
    """The module's state-dict buffers, recursively: w_avg and noise_const,
    not the resample filters (recomputed constants, as in the JAX
    package's `buffers` collection)."""
    return [b for m in module.modules() for name, b in m._buffers.items()
            if b is not None and name not in m._non_persistent_buffers_set]


def print_module_summary(model, *args, max_depth=2, **kwargs):
    """Run `model(*args, **kwargs)` once without gradients, with a forward
    hook on every submodule, and print a table of each submodule down to
    `max_depth` levels: the parameters and state-dict buffers it adds to
    what the table already counted, its first output's shape and dtype
    (one more row per further output), then the totals. Returns the table
    string (also printed)."""
    entries, depth = [], [0]

    def pre_hook(_mod, _inputs):
        depth[0] += 1

    def post_hook(mod, _inputs, outputs):
        depth[0] -= 1
        if depth[0] <= max_depth:
            outs = list(outputs) if isinstance(outputs, (tuple, list)) \
                else [outputs]
            entries.append((mod, [t for t in outs
                                  if isinstance(t, torch.Tensor)]))

    hooks = [m.register_forward_pre_hook(pre_hook) for m in model.modules()]
    hooks += [m.register_forward_hook(post_hook) for m in model.modules()]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()

    names = {mod: name for name, mod in model.named_modules()}
    rows = [[type(model).__name__, "Parameters", "Buffers", "Output shape",
             "Datatype"], ["---"] * 5]
    seen = set()
    totals = [0, 0]
    for mod, outs in entries:       # innermost first: a parent adds the rest
        params = [t for t in mod.parameters() if id(t) not in seen]
        buffers = [t for t in _persistent_buffers(mod) if id(t) not in seen]
        outs = [t for t in outs if id(t) not in seen]
        seen |= {id(t) for t in params + buffers + outs}
        if not (params or buffers or outs):
            continue
        name = "<top-level>" if mod is model else names[mod]
        n_p, n_b = _count(params), _count(buffers)
        shapes = [str(list(t.shape)) for t in outs] or ["-"]
        dtypes = [str(t.dtype).split(".")[-1] for t in outs] or ["-"]
        rows.append([name + (":0" if len(outs) >= 2 else ""),
                     str(n_p) if n_p else "-", str(n_b) if n_b else "-",
                     shapes[0], dtypes[0]])
        rows += [[f"{name}:{i}", "-", "-", shapes[i], dtypes[i]]
                 for i in range(1, len(outs))]
        totals[0] += n_p
        totals[1] += n_b
    rows += [["---"] * 5, ["Total", str(totals[0]), str(totals[1]), "-", "-"]]
    widths = [max(len(cell) for cell in col) for col in zip(*rows)]
    table = "\n".join("  ".join(cell.ljust(w) for cell, w in zip(row, widths))
                      .rstrip() for row in rows)
    print(table, flush=True)
    return table


def summarize_state(state) -> str:
    """One-line parameter accounting for the training state. The buffers
    counted are those of the state dict (w_avg, noise_const), as in the JAX
    package's line: the resample filters are recomputed constants."""
    line = (f"G params {_count(state.g.parameters()):,} | "
            f"D params {_count(state.d.parameters()):,} | "
            f"D_parsing params {_count(state.dp.parameters()):,} | "
            f"G buffers {_count(_persistent_buffers(state.g)):,}")
    print(line, flush=True)
    return line
