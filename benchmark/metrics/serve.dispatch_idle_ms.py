"""serve.dispatch_idle_ms: per traced batch of the stream, the device's
idle time (no kernel of the trace running) inside the port's `run_batch`
span, mapped onto the trace's clock by `lib/program.py`; median over the
batches whose span lies within the marked window: ms. With the previous
batch still queued, idle there means the host held the device back.
Appends to the run's notes the split of the window's idle by the
innermost port span open on the serving thread. The host runs under the
profiler here: compare it only with itself. None where the port records
no spans or they cannot be mapped."""

from benchmark.lib import program


def read(run):
    return program.dispatch_idle_ms(run)
