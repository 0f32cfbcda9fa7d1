"""A plain data-parallel training step: the frozen one-process step
(`steps.py`: its models, loss cores and `Adam`) run by each rank of a
torch.distributed process group on its own rows of the global batch, with
the couplings a data-parallel step has written as plain torch.distributed
calls:

- each phase's gradients and tensor metrics are meaned over ranks (one
  all-reduce a tensor) before they are sanitized and applied, so that the
  metrics, ADA's `real_signs` among them, are the global batch's;
- the minibatch-std layer groups the all-gathered global batch (a group
  spans ranks) and keeps this rank's rows; the gather's adjoint sums the
  incoming gradient over ranks, and is itself differentiable (R1's double
  backward goes through it);
- whether one interleaved D call serves every sub-batch (`_can_batch_d`)
  is decided on the global batch;
- the parsing loss is the quotient of the global batch's sums;
- G's `w_avg` is meaned over ranks after Gmain.

It imports nothing of the port or of JAX, and leaves the frozen
one-process files as they are. `couple()` replaces, in this process, the
names through which they reach the one-process behaviour: the
minibatch-std gather and rank that `nn/layers.py` imports from
`train/dist.py`, and the parsing loss that `train/loss_terms.py` imports.
`RankTraining` overrides `ReferenceTraining`'s phase update. Departures
from the one-process step, each for the layout alone:

- `data_axis_size` may be above 1 (the one-process step refuses it);
- `batch_size` is the global batch, as the port's configuration states
  it: the EMA's half-life and ADA's adjustment count the global batch's
  images; a rank holds batch_size / world rows;
- `_can_batch_d`'s decision reaches the loss cores through the group size
  they read: 1 where the global batch allows one interleaved call, None
  where it does not (the models keep the configured group size).
"""

from __future__ import annotations

import contextlib
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..losses.parsing import PARSING_CLASS_WEIGHTS
from ..nn import layers
from . import loss_terms
from .steps import ReferenceTraining, _phase_grads, _sanitize


class _SumOverRanks(torch.autograd.Function):
    """y = the sum over ranks of x; the adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, rank after rank along dim 0; the adjoint takes
    this rank's rows of the incoming gradient summed over ranks."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // dist.get_world_size()
        r = dist.get_rank()
        return _SumOverRanks.apply(g)[r * n:(r + 1) * n]


def gather_rows(x):
    """The global batch of `x`, differentiable twice and more."""
    return _GatherRows.apply(x)


def weighted_parsing_ce(logits, targets, ignore_index=255):
    """The weighted parsing CE of the global batch: sum(w_t * nll) over
    every rank's non-ignored pixels / sum(w_t) over them. This rank's
    numerator is scaled by the ranks, so that the mean of the ranks'
    losses (and of their gradients) is the global quotient; the
    denominator carries no gradient."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    cw = torch.tensor(PARSING_CLASS_WEIGHTS, dtype=nll.dtype,
                      device=logits.device)
    w = cw[safe] * valid.to(nll.dtype)
    den = w.sum().detach().clone()
    dist.all_reduce(den)
    return (w * nll).sum() * dist.get_world_size() / den.clamp_min(1e-8)


@contextlib.contextmanager
def couple():
    """Inside, the frozen one-process modules gather the minibatch-std
    groups over ranks and take the parsing loss over the global batch."""
    saved = (layers.all_gather_batch, layers.rank,
             loss_terms.weighted_parsing_ce)
    layers.all_gather_batch, layers.rank = gather_rows, dist.get_rank
    loss_terms.weighted_parsing_ce = weighted_parsing_ce
    try:
        yield
    finally:
        (layers.all_gather_batch, layers.rank,
         loss_terms.weighted_parsing_ce) = saved


def _mean_over_ranks(t):
    """The mean over ranks of `t`, detached and contiguous (R1's double
    backward hands some gradients over in another memory format)."""
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t)
    return t.div_(dist.get_world_size())


class RankTraining(ReferenceTraining):
    """`ReferenceTraining` on this rank's rows (use inside `couple()`):
    `cfg.batch_size` is the global batch, `step` takes the rank's rows."""

    def __init__(self, cfg, weights, device):
        self.global_cfg = cfg
        one = types.SimpleNamespace(**dict(vars(cfg), data_axis_size=1))
        super().__init__(one, weights, device)
        self.cfg = cfg

    def step(self, batch, generator, do_r1=False):
        n = batch["real_img"].shape[0] * dist.get_world_size()
        gs = self.global_cfg.mbstd_group_size
        whole = gs is not None and n >= gs and n % gs == 0
        self.cfg = types.SimpleNamespace(**dict(
            vars(self.global_cfg), mbstd_group_size=1 if whole else None))
        try:
            return super().step(batch, generator, do_r1)
        finally:
            self.cfg = self.global_cfg

    def _update(self, name, loss_fn, sanitize=True):
        """One phase: its loss and gradients, their means over ranks (and
        the tensor metrics'), then sanitized and applied by Adam; after
        Gmain, G's w_avg meaned over ranks."""
        loss, metrics = loss_fn()
        params = [p for _, p in self.opt[name].named]
        grads = [_mean_over_ranks(g) for g in _phase_grads(loss, params)]
        metrics = {k: _mean_over_ranks(v.float()) if torch.is_tensor(v)
                   else v for k, v in metrics.items()}
        if sanitize and self.cfg.sanitize_grads:
            grads = _sanitize(grads)
        if self.record is not None:
            for (leaf, _), g in zip(self.opt[name].named, grads):
                self.record(name, leaf, g)
        self.opt[name].step(grads)
        if name == "g":
            with torch.no_grad():
                w_avg = self.g.mapping.w_avg
                w_avg.copy_(_mean_over_ranks(w_avg))
        return metrics
