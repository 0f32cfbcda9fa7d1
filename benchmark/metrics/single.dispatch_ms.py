"""single.dispatch_ms: the host's time from the call of `run_batch` to its
return (upload, the device stages and the generator queued, no sync),
median over the window's requests: ms."""

from benchmark.lib.stats import median


def read(run):
    spans = run.spans.get("run_batch")
    return 1e3 * median(spans) if spans else None
