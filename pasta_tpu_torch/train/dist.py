"""The collectives of the data-parallel step.

The JAX package trains data-parallel by sharding the global batch over a
1-D `data` mesh under `jit` (`pasta_tpu/train/entry.py`): every reduction
of the step is a reduction over the global batch, and XLA inserts the
collectives. The port runs one process per card, each with its rows of the
global batch, and makes the same reductions global by hand:

- `reduce_phase`: the mean over ranks of a phase's gradients and metrics,
  in one flat buffer (one all-reduce a phase);
- `all_gather_batch`: the global batch of a tensor, rank after rank along
  dim 0 (the minibatch-std groups of `nn/layers.py`);
- `all_reduce_sum`, `all_reduce_mean`: a global sum or mean (Gpl's
  `pl_mean`, the parsing CE's denominator, the contextual loss's target
  mean, the mapping's `w_avg`).

`all_gather_batch` and `all_reduce_sum` are autograd Functions whose
backward passes are built of the same differentiable collectives, so that
R1's double backward goes through them. They use only `all_reduce` and
`all_gather` (gloo has no `reduce_scatter`). With no process group each
returns its input and launches nothing; in a group of one rank each runs
and gives its input back, bit for bit.

Tracing (`tracing.py`: only while a profiler is active, one flag check
otherwise): each collective call opens a span, "allreduce" (`phase`,
`bytes`) around `reduce_phase`'s all-reduce, "all_reduce_sum" around every
summing all-reduce (`all_reduce_sum`, `all_reduce_mean` and the adjoint of
the gather) and "all_gather_batch" around the gather, and `counts()` adds
the call and its bytes under the span's name, as host integers.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .. import tracing

_counts = collections.defaultdict(lambda: [0, 0])


def grouped():
    """Whether this process is in a default process group."""
    return dist.is_available() and dist.is_initialized()


def world_size():
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if grouped() else 1


def rank():
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if grouped() else 0


def counts():
    """{kind: {"calls", "bytes"}} of the collectives traced since the last
    `reset_counts()`: the spans' names, and the bytes each call handed
    over (a gather: this rank's)."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in _counts.items()}


def reset_counts():
    """Forget the counted collectives."""
    _counts.clear()


def _traced(kind, x, **attrs):
    """The span of one collective call on `x`, counted while traced."""
    s = tracing.span(kind, **attrs)
    if isinstance(s, tracing.Span):
        s.attrs["bytes"] = x.numel() * x.element_size()
        c = _counts[kind]
        c[0] += 1
        c[1] += s.attrs["bytes"]
    return s


def _summed(x):
    y = x.clone(memory_format=torch.contiguous_format)
    with _traced("all_reduce_sum", y):
        dist.all_reduce(y)
    return y


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; its own adjoint."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


class _AllGatherBatch(torch.autograd.Function):
    """[n, ...] on each rank -> [world * n, ...], rank r's rows at
    [r * n, (r + 1) * n). Backward: the sum over ranks of the incoming
    gradient, then this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        with _traced("all_gather_batch", x):
            dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // dist.get_world_size()
        r = dist.get_rank()
        return _AllReduceSum.apply(g)[r * n:(r + 1) * n]


def all_reduce_sum(x):
    """Sum of `x` over ranks, differentiable (twice and more)."""
    return _AllReduceSum.apply(x) if grouped() else x


def all_reduce_mean(x):
    """Mean of `x` over ranks, differentiable; its own adjoint."""
    return _AllReduceSum.apply(x) / world_size() if grouped() else x


def all_gather_batch(x):
    """The global batch of `x` (every rank's rows, rank after rank along
    dim 0), differentiable; every rank must pass the same shape."""
    return _AllGatherBatch.apply(x) if grouped() else x


def reduce_phase(grads, metrics, phase=None):
    """(grads, metrics) -> their means over ranks, through ONE all-reduce
    of a flat float32 buffer: the list of gradients, and every tensor
    among the metrics (numbers stay as they are). Each rank gets the same
    bits back. Without a process group: the same objects. `phase` names
    the step's phase on the all-reduce's span."""
    if not grouped():
        return grads, metrics
    n = world_size()
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [metrics[k].reshape(1).float() for k in keys])
    with _traced("allreduce", flat, phase=phase):
        dist.all_reduce(flat)
    flat.div_(n)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    # the metrics leave the big buffer, which the loop would otherwise keep
    # alive with them for a tick
    tail = flat[at:].clone()
    metrics = dict(metrics)
    for i, k in enumerate(keys):
        metrics[k] = tail[i]
    return out, metrics
