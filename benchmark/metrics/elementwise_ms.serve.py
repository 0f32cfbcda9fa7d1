"""elementwise_ms.serve: the elementwise chains' device time a batch of the
stream: over the traced span's whole batches, the median of each batch's
device ms in kernels whose names contain `elementwise_kernel` or
`reduce_kernel` (ATen's elementwise, copy, fill and reduction kernels) or
`spade_norm` (the port's fused SPADE normalisation, which took over part
of that work): ms. None where the span holds no such kernel."""

import statistics

ELEMENTWISE_KERNELS = ("elementwise_kernel", "reduce_kernel", "spade_norm")


def read(run):
    if run.trace is None:
        return None
    per_batch = [sum(e - s for name, s, e in seg
                     if any(k in name for k in ELEMENTWISE_KERNELS)) / 1e3
                 for seg in run.trace.segments()]
    if not any(per_batch):
        return None
    return statistics.median(per_batch)
