"""idle_share.train: the share of the traced training steps' window (from
the first step's mark to the mark after the last, on the device's clock)
in which no kernel ran: 1 - busy / window. Appends to the run's notes the
idle split by what the host was doing: inside the wrapped step
(`bench.train_step`: the host queueing a step's launches slower than the
device runs them) or between steps (the loop's upload, assembly and next
batch)."""

from benchmark.lib import training


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    run.notes.append(training.idle_note(run.trace))
    return 1.0 - run.trace.busy_s / run.trace.window_s
