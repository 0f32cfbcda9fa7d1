"""Frechet Inception Distance (reference
metrics/frechet_inception_distance.py:20-39).

A copy of pasta_tpu/metrics/fid.py (numpy only), unchanged in behaviour
but for the call of scipy.linalg.sqrtm: newer SciPy releases take no
`disp` argument, and without it old and new return the root alone.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg


def compute_fid(mu_real, sigma_real, mu_gen, sigma_gen, eps=1e-6):
    m = np.square(mu_gen - mu_real).sum()
    with warnings.catch_warnings():
        # Small sample sets make the covariances rank-deficient; sqrtm then
        # warns (LinAlgWarning) and can return non-finite entries. Retry
        # with the standard eps*I jitter in that case.
        warnings.simplefilter("ignore")
        s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
        if not np.isfinite(s).all():
            off = np.eye(sigma_real.shape[0]) * eps
            s = scipy.linalg.sqrtm(
                np.dot(sigma_gen + off, sigma_real + off))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))
