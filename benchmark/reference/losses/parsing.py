"""7-class weighted parsing cross-entropy: a frozen copy of the port's
`losses/parsing.py` in one process. Class weights [1,3,4,4,4,4,4],
ignore_index 255 (torch nn.CrossEntropyLoss(weight, ignore_index)
semantics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

PARSING_CLASS_WEIGHTS = (1.0, 3.0, 4.0, 4.0, 4.0, 4.0, 4.0)


def weighted_parsing_ce(logits, targets, ignore_index=255):
    """sum(w_t * nll) / sum(w_t) over the non-ignored pixels.

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
    return num / den.clamp_min(1e-8)
