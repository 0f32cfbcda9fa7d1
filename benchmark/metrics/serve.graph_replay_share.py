"""serve.graph_replay_share: the share of the traced stream batches whose
`run_batch` replayed its batch key's CUDA graph (the span attribute
`graph`), rather than capturing it or queueing its launches eagerly:
fraction. None where no `run_batch` span carries the attribute."""

from benchmark.lib import replay


def read(run):
    return replay.share(run)
