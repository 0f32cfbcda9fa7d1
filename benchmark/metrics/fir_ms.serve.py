"""fir_ms.serve: the FIR resampling filters' device time a batch of the
stream: over the traced span's whole batches, the median of each batch's
device ms in kernels whose names contain `upfirdn2d` (the port's kernel),
`conv2d_grouped_direct_kernel` or `conv_depthwise2d` (cuDNN's and ATen's
depthwise convolutions, which computed the filters before it): ms. None
where the span holds no such kernel."""

import statistics

FIR_KERNELS = ("upfirdn2d", "conv2d_grouped_direct_kernel",
               "conv_depthwise2d")


def read(run):
    if run.trace is None:
        return None
    per_batch = [sum(e - s for name, s, e in seg
                     if any(k in name for k in FIR_KERNELS)) / 1e3
                 for seg in run.trace.segments()]
    if not any(per_batch):
        return None
    return statistics.median(per_batch)
