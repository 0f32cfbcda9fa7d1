"""Inception Score (reference metrics/inception_score.py:18-36): exp of the
mean KL between per-image and marginal class distributions, over splits.

A copy of pasta_tpu/metrics/inception_score.py (numpy only), unchanged in
behaviour.
"""

from __future__ import annotations

import numpy as np


def compute_is(probs, num_splits=10):
    """probs: [N, num_classes] softmax outputs."""
    scores = []
    n = probs.shape[0]
    num_splits = max(min(num_splits, n), 1)
    for i in range(num_splits):
        part = probs[i * n // num_splits: (i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-16)
                     - np.log(np.expand_dims(np.mean(part, 0), 0) + 1e-16))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))
