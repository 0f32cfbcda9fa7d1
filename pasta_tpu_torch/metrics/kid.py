"""Kernel Inception Distance (reference
metrics/kernel_inception_distance.py:18-44): polynomial-kernel MMD averaged
over random subsets.

A copy of pasta_tpu/metrics/kid.py (numpy only), unchanged in
behaviour.
"""

from __future__ import annotations

import numpy as np


def compute_kid(real_features, gen_features, num_subsets=100,
                max_subset_size=1000, seed=0):
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]),
            max_subset_size)
    rng = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rng.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rng.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
