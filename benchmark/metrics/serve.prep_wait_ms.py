"""serve.prep_wait_ms: the port's `prep_wait` span in `run_stream` (the
serving thread waiting for the prep threads' items of the batch it is
about to queue), median over the traced batches: ms. Read inside the
traced span, under the profiler's cost per operation: compare it only
with itself. None where the port records no spans."""

from benchmark.lib import program


def read(run):
    return program.median_ms(run, "prep_wait")
