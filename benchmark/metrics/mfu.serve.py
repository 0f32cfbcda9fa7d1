"""mfu.serve: the generator's operations at the cell's batch, counted on
the reference (`lib/flops.py`), times the images the window completed,
over the window, as a share of the time those operations take at each
one's dtype peak (67 TFLOP/s fp32, 989 bf16): %."""

from benchmark.lib.roofline import PEAK_FLOPS


def read(run):
    if run.ops is None or not run.items:
        return None
    per_image = run.ops.peak_seconds(PEAK_FLOPS) / run.ops_items
    return 100.0 * per_image * run.items / run.window_s
