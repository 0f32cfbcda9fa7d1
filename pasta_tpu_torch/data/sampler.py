"""Infinite rank-strided sampler with windowed reshuffle.

The port's own copy of `pasta_tpu/data/sampler.py`, unchanged: the training
loop's index stream must be the JAX package's.

Behavioral parity with the reference's InfiniteSampler
(torch_utils/misc.py:115-146): a permutation array is walked forever; each
visited position is swapped with a random earlier position inside a sliding
window (window_size fraction of the dataset), giving an endless
locally-reshuffled stream; ranks take disjoint strided subsequences
(idx % num_replicas == rank), so multi-host data sharding is deterministic
from (seed, rank).
"""

from __future__ import annotations

import numpy as np


def infinite_sampler(dataset_size, rank=0, num_replicas=1, shuffle=True,
                     seed=0, window_size=0.5, skip_first=0):
    """Yields dataset indices forever; rank-strided and window-shuffled.

    skip_first > 0 excludes indices [0, skip_first) from the stream — the
    in-training evaluator holds those items out, so they are never
    trained on."""
    assert dataset_size - skip_first > 0
    assert 0 <= rank < num_replicas
    order = np.arange(skip_first, dataset_size)
    rnd = None
    window = 0
    if shuffle:
        rnd = np.random.RandomState(seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_size))

    idx = 0
    while True:
        i = idx % order.size
        if idx % num_replicas == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1
