"""The comparison that decides `correct` for image answers.

Each sampled answer (a finetune image the timed path produced) is held
against the reference's image of the same pair: `share_off`, the share of
values more than 1% of the reference image's range away from it, and
`mean_gap`, the mean absolute difference over that range. The worst
sampled image gives each number; a non-finite image reads 1 on both.
"""

from __future__ import annotations

import math

import torch


def image_gaps(got, ref):
    """(share_off, mean_gap) of one image against its reference."""
    got = torch.as_tensor(got, device=ref.device, dtype=torch.float32)
    if not bool(torch.isfinite(got).all()):
        return 1.0, 1.0
    span = float(ref.max() - ref.min())
    diff = (got - ref).abs()
    return (float((diff > 0.01 * span).float().mean()),
            float(diff.mean()) / span if span > 0 else math.inf)


def worst(pairs_of_gaps):
    """{"share_off": worst, "mean_gap": worst} over [(share, gap)]."""
    return {"share_off": max(s for s, _ in pairs_of_gaps),
            "mean_gap": max(g for _, g in pairs_of_gaps)}


def judge(numbers, limits):
    """(correct, {name: {"value": v, "limit": l}}), names in `limits`'
    order; a number above its limit, or missing, is not correct."""
    table = {name: {"value": numbers.get(name, math.inf), "limit": limit}
             for name, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
