"""k1_roofline.train: K1's share of its roofline over the traced training
steps: the sum of `conv_bound` over the convolutions a step runs on K1,
forward and input gradient, fp32 and bf16 (recorded on the reference, one
R1 step and one regular step: its forward convolutions in K1's scope,
which in its copy of K1's autograd Function are also the input
gradients), over K1's device time by kernel name: %. A traced step whose
K1 launches do not match its kind's record is left out."""

from benchmark.lib.roofline import is_k1_conv, k1_bound

K1_KERNELS = ("conv3x3_f32_kernel", "conv3x3_bf16_kernel")


def read(run):
    kinds = getattr(run, "ops_kinds", None)
    if run.trace is None or not kinds:
        return None
    records = {kind: [c for c in ops.convs if is_k1_conv(c)]
               for kind, ops in kinds.items()}
    total_bound = total_time = 0.0
    counts = []
    for seg, kind in zip(run.trace.segments(), run.traced_kinds):
        k1 = [(s, e) for name, s, e in seg
              if any(k in name for k in K1_KERNELS)]
        recs = records.get(kind)
        counts.append(f"{'R1' if kind else 'regular'} {len(k1)}/"
                      f"{len(recs or [])}")
        if recs and len(k1) == len(recs):
            total_bound += sum(k1_bound(c)[0] for c in recs)
            total_time += sum(e - s for s, e in k1) / 1e6
    run.notes.append("K1 launches / records a traced step: "
                     + ", ".join(counts))
    return 100.0 * total_bound / total_time if total_time else None
