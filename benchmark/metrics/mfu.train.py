"""mfu.train: the operations of the window's training steps, counted on the
reference (`lib/flops.py`: convolutions, their gradients and matrix
products, 2 a multiply-add, by dtype) for one R1 step and one regular
step, weighted by the window's steps of each kind (15 regular to 1 R1 a
tick), over the window, as a share of the time they take at each dtype's
peak (67 TFLOP/s fp32, 989 bf16): %."""

from benchmark.lib.roofline import PEAK_FLOPS


def read(run):
    kinds = getattr(run, "ops_kinds", None)
    if not kinds or set(kinds) != set(run.window_steps) or not run.window_s:
        return None
    seconds = sum(kinds[kind].peak_seconds(PEAK_FLOPS) * steps
                  for kind, steps in run.window_steps.items())
    return 100.0 * seconds / run.window_s
