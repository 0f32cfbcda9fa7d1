"""single.prep_ms: the host's time in `prepare_pair` (decode and host
prep of one pair), median over the window's requests: ms."""

from benchmark.lib.stats import median


def read(run):
    spans = run.spans.get("prepare_pair")
    return 1e3 * median(spans) if spans else None
