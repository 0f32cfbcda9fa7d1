"""train_x4.loader_wait_ms: the training loop waiting for the loader's
next batch (the port's `loader_wait` span in `train/loop.py`), median
over every rank's traced steps: ms. None where the port records no such
span."""

import statistics

from benchmark.lib import collectives


def read(run):
    waits = collectives.span_ms([r for r in getattr(run, "ranks", None)
                                 or [] if r], "loader_wait")
    return statistics.median(waits) if waits else None
