"""Parameter accounting of the training state, port of
`pasta_tpu/summary.py::summarize_state` (the reference prints a module
table at start-up, torch_utils/misc.py:201-269; the training loop prints
this line)."""

from __future__ import annotations


def _count(tensors):
    return sum(t.numel() for t in tensors)


def summarize_state(state) -> str:
    """One-line parameter accounting for the training state. The buffers
    counted are those of the state dict (w_avg, noise_const), as in the JAX
    package's line: the resample filters are recomputed constants."""
    params = {name for name, _ in state.g.named_parameters()}
    buffers = [v for k, v in state.g.state_dict().items() if k not in params]
    line = (f"G params {_count(state.g.parameters()):,} | "
            f"D params {_count(state.d.parameters()):,} | "
            f"D_parsing params {_count(state.dp.parameters()):,} | "
            f"G buffers {_count(buffers):,}")
    print(line, flush=True)
    return line
