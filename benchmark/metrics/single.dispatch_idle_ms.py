"""single.dispatch_idle_ms: per traced request, the device's idle time (no
kernel of the trace running) inside the port's `run_batch` span, mapped
onto the trace's clock by `lib/program.py`; median over the requests: ms.
The idle the device spends waiting for the host to queue a request's
launches. Appends to the run's notes the split of the window's idle by
the innermost port span open on the serving thread. The host runs under
the profiler here, slower than untraced: compare it only with itself.
None where the port records no spans or they cannot be mapped."""

from benchmark.lib import program


def read(run):
    return program.dispatch_idle_ms(run)
