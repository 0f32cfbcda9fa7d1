"""single.decode_ms: the port's `decode` span (the two `load_person` calls
of `prepare_pair`: the person's and the clothes' records read and
decoded), median over the traced requests: ms. The span is read inside
the traced span, so its host time carries the profiler's cost per
operation: compare it only with itself. None where the port records no
spans."""

from benchmark.lib import program


def read(run):
    return program.median_ms(run, "decode")
