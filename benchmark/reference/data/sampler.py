"""The training loader's index stream: a plain copy of the port's
`data/sampler.py` (the reference's InfiniteSampler, torch_utils/misc.py:
115-146). A permutation of the dataset's indices, drawn from the seed, is
walked forever; each visited position is swapped with a random earlier
one inside a window of half the dataset (wrapping round to its end, so
that an index can come again within a pass), and rank r of n takes the
stream's positions r, r + n, r + 2n, ..."""

from __future__ import annotations

import itertools

import numpy as np


def rank_indices(size, rank, world, seed, count, window_size=0.5):
    """The first `count` indices rank `rank` of `world` draws."""
    order = np.arange(size)
    rnd = np.random.RandomState(seed)
    rnd.shuffle(order)
    window = int(np.rint(size * window_size))
    out = []
    for idx in itertools.count():
        if len(out) == count:
            return out
        i = idx % size
        if idx % world == rank:
            out.append(int(order[i]))
        if window >= 2:
            j = (i - rnd.randint(window)) % size
            order[i], order[j] = order[j], order[i]
