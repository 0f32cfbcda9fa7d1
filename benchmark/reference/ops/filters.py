"""FIR filter preparation for resampling ops (port of pasta_tpu/ops/filters.py).

Semantics match the reference `setup_filter`: normalize to unit DC gain,
optional flip, gain applied as gain**(ndim/2), and automatic
separable/non-separable selection (1-D filters with >=8 taps stay
separable; shorter 1-D filters are outer-producted to 2-D).
"""

from __future__ import annotations

import numpy as np
import torch


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None):
    """Prepare a FIR filter for upfirdn2d and friends.

    Args:
        f: filter taps -- scalar, 1-D, or 2-D array-like; None = identity.
        normalize: scale so the taps sum to 1 (DC-preserving).
        flip_filter: reverse tap order.
        gain: overall magnitude scale.
        separable: force separable (1-D) / non-separable (2-D); None = auto.

    Returns:
        float32 CPU tensor, 1-D if separable else 2-D.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2)
    assert f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32))
