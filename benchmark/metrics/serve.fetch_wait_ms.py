"""serve.fetch_wait_ms: the port's `fetch_wait` span in `run_stream` (the
serving thread waiting for the copy of the previous batch's output,
queued behind its work: the host's slack under the device, falling
toward 0 as the stream turns host-bound), median over the traced
batches: ms. Read inside the traced span, under the profiler's cost per
operation: compare it only with itself. None where the port records no
spans."""

from benchmark.lib import program


def read(run):
    return program.median_ms(run, "fetch_wait")
