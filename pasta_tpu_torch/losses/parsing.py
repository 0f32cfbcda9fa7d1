"""7-class weighted parsing cross-entropy, port of
pasta_tpu/losses/parsing.py. Class weights [1,3,4,4,4,4,4], ignore_index
255 (torch nn.CrossEntropyLoss(weight, ignore_index) semantics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..train.dist import all_reduce_sum, grouped, world_size

PARSING_CLASS_WEIGHTS = (1.0, 3.0, 4.0, 4.0, 4.0, 4.0, 4.0)


def weighted_parsing_ce(logits, targets, ignore_index=255):
    """sum(w_t * nll) / sum(w_t) over the non-ignored pixels of the global
    batch (every rank's, under data parallelism).

    Args:
        logits:  [N, H, W, 7].
        targets: [N, H, W] integer labels (may contain ignore_index).
    """
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(safe, logits.shape[-1]).to(logp.dtype)
    nll = -(logp * onehot).sum(dim=-1)
    cw = torch.tensor(PARSING_CLASS_WEIGHTS, dtype=logp.dtype,
                      device=logits.device)
    w = (onehot @ cw) * valid.to(logits.dtype)
    num, den = (w * nll).sum(), w.sum()
    if grouped():
        # the quotient of the GLOBAL sums (the JAX step's, over the whole
        # batch): the denominator summed over ranks (it carries no
        # gradient), the numerator scaled so that the mean of the ranks'
        # losses and of their gradients is the global quotient's
        den = all_reduce_sum(den.detach())
        num = num * world_size()
    return num / den.clamp_min(1e-8)
