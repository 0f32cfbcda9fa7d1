"""train_x4.allreduce_ms: the device ms a traced training step spends in
the NCCL kernels of the port's `allreduce` spans (`train/dist.py::
reduce_phase`, one flat all-reduce a phase), median over the traced steps,
on the rank where that median is largest. An NCCL kernel's time holds its
wait for the other ranks' kernels. Appends to the run's notes each
phase's bytes and the bus bandwidth they imply, and the collectives the
port counted. None where the port records no such span."""

import statistics

from benchmark.lib import collectives


def read(run):
    ranks = getattr(run, "ranks", None) or []
    medians = {}
    for r, rank in enumerate(ranks):
        steps = rank and collectives.allreduce_step_ms(rank)
        if steps:
            medians[r] = statistics.median(steps)
    if not medians:
        return None
    worst = max(medians, key=medians.get)
    run.notes.append("allreduce ms a step by rank: " + ", ".join(
        f"{r} {m:.3f}" for r, m in sorted(medians.items())))
    run.notes.extend(f"rank {worst} {line}"
                     for line in collectives.phase_lines(ranks[worst]))
    return medians[worst]
