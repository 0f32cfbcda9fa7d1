"""idle_share.serve: the share of the stream's traced window (from the
first batch's mark to the last one's, on the device's clock) in which no
kernel ran: 1 - busy / window."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
