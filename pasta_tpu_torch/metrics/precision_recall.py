"""k-NN manifold precision / recall (reference
metrics/precision_recall.py:19-60), port of
pasta_tpu/metrics/precision_recall.py.

The pairwise squared distances are plain products (`torch.matmul`, as the
JAX package leaves them to XLA), computed on `device` in the JAX
package's formula and order, batched by rows; fp32 (the entry points pin
TF32 off, `ops/_build.py::pin_fp32_numerics`).
"""

from __future__ import annotations

import numpy as np
import torch


def _sq_dists(rows, feats):
    """|r - f|^2 as |r|^2 - 2 r.f + |f|^2, clamped at 0."""
    d2 = (rows.square().sum(dim=1, keepdim=True) - 2 * rows @ feats.T
          + feats.square().sum(dim=1)[None, :])
    return d2.clamp(min=0.0)


def _kth_nn_radius(feats, nhood_size, row_batch=2048):
    """Distance to the k-th nearest neighbour within `feats` (the
    self-distance 0 counts, so index `nhood_size` of the sorted row)."""
    radii = []
    for start in range(0, feats.shape[0], row_batch):
        d2 = _sq_dists(feats[start:start + row_batch], feats)
        radii.append(d2.sort(dim=1).values[:, nhood_size].sqrt())
    return torch.cat(radii)


def _fraction_within(query, manifold, radii, row_batch=2048):
    """Share of query points within some manifold point's k-NN radius."""
    hits = []
    for start in range(0, query.shape[0], row_batch):
        d = _sq_dists(query[start:start + row_batch], manifold).sqrt()
        hits.append((d <= radii[None, :]).any(dim=1))
    return float(torch.cat(hits).cpu().numpy().mean())


def compute_pr(real_features, gen_features, nhood_size=3, device="cuda"):
    """Returns (precision, recall) of [N, D] feature arrays, computed on
    `device` (the card unless the caller asks for the CPU)."""
    real = torch.as_tensor(np.asarray(real_features, np.float32),
                           device=device)
    gen = torch.as_tensor(np.asarray(gen_features, np.float32),
                          device=device)
    real_radii = _kth_nn_radius(real, nhood_size)
    gen_radii = _kth_nn_radius(gen, nhood_size)
    precision = _fraction_within(gen, real, real_radii)
    recall = _fraction_within(real, gen, gen_radii)
    return precision, recall
