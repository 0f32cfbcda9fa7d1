"""k1_roofline.serve: K1's share of its roofline in the traced span of the
stream: over the whole batches the span holds, the sum of `conv_bound`
over the batch's convolutions in K1's scope (recorded on the reference at
the cell's batch), over K1's device time by kernel name: %. A batch whose
K1 launches do not match the recorded convolutions is left out."""

from benchmark.lib.roofline import is_k1_conv, k1_bound

K1_KERNELS = ("conv3x3_f32_kernel", "conv3x3_bf16_kernel")


def read(run):
    if run.trace is None or run.ops is None:
        return None
    convs = [c for c in run.ops.convs if is_k1_conv(c)]
    bound = sum(k1_bound(c)[0] for c in convs)
    total_bound = total_time = 0.0
    for seg in run.trace.segments():
        k1 = [(s, e) for name, s, e in seg
              if any(k in name for k in K1_KERNELS)]
        if convs and len(k1) == len(convs):
            total_bound += bound
            total_time += sum(e - s for s, e in k1) / 1e6
    return 100.0 * total_bound / total_time if total_time else None
