"""idle_share.single: the share of the traced requests' own time on the
device (from the mark where a request starts to its last operation, the
copy of its image to the host) in which no kernel ran: 1 - busy / time,
summed over the requests. The open loop's wait for the next request is
left out, since it would grow as the program got faster."""


def read(run):
    spans = run.trace.segment_spans() if run.trace is not None else []
    total = sum(t for t, _ in spans)
    return 1.0 - sum(b for _, b in spans) / total if total else None
