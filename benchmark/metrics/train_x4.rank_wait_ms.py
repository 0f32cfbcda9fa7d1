"""train_x4.rank_wait_ms: how long the fastest rank waits for the slowest
at a traced step's first collective: the gap between the first and the
last rank's entry into the step's Gmain all-reduce (the port's
`allreduce` spans with `phase` "Gmain", on the host's one monotonic
clock), median over the traced steps: ms. None where the port records no
such span."""

import statistics

from benchmark.lib import collectives


def read(run):
    ranks = [r for r in getattr(run, "ranks", None) or [] if r]
    entries = collectives.gmain_entries(ranks)
    if len(ranks) < 2 or not all(entries):
        return None
    gaps = [(max(starts) - min(starts)) / 1e6
            for starts in zip(*entries)]
    return statistics.median(gaps)
