"""single.generator_queue_ms: the port's `generator` span inside
`run_batch` (the host's time queueing the generator's launches; the rest
of `run_batch` is upload, ingest and assemble), median over the traced
requests: ms. The span is read inside the traced span, so its host time
carries the profiler's cost per operation and reads above the share of
the untraced `single.dispatch_ms` it stands for: compare it only with
itself. None where the port records no spans."""

from benchmark.lib import program


def read(run):
    return program.median_ms(run, "generator")
