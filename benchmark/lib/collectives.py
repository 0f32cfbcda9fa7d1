"""What the data-parallel cell's readers take from each rank's traced
steps (`run.ranks`, one dict a rank, written by `lib/ranks.py`), all
on the profiler's host clock (us) but the port's spans:

- `steps`: (start, end) of each traced step (the harness's
  `bench.train_step` label);
- `ranges`: (name, start, end, nccl us) of each of the port's spans as
  the profiler saw it (`pasta.<name>`), with the device time of the NCCL
  kernels launched inside it;
- `spans`: the port's own spans (`tracing.py`: name, start and end in
  perf_counter ns, attrs);
- `counts`: `train/dist.py::counts()` (None where the port has none);
- `world`: the ranks.

A program without those spans leaves them empty: each reader then returns
None.
"""

from __future__ import annotations

import statistics


def _allreduce_ranges(rank):
    return sorted(r for r in rank["ranges"] if r[0] == "allreduce")


def allreduce_step_ms(rank):
    """[ms] a traced step of one rank: the device time of the NCCL kernels
    of the port's `allreduce` spans opened inside it; None where the
    profiler holds no such kernel."""
    ranges = _allreduce_ranges(rank)
    if not rank["steps"] or not any(us for *_, us in ranges):
        return None
    return [sum(us for _, s, _, us in ranges if a <= s <= b) / 1e3
            for a, b in rank["steps"]]


def phase_lines(rank):
    """One line a phase: its bytes a call (the spans' attribute) and the
    bus bandwidth its median kernel time implies (a ring all-reduce moves
    2 (n - 1) / n of the buffer a rank); then the counter's totals."""
    spans = sorted((s for s in rank["spans"] if s["name"] == "allreduce"),
                   key=lambda s: s["start"])
    ranges = _allreduce_ranges(rank)
    n = rank["world"]
    lines = []
    if spans and len(spans) == len(ranges):
        by_phase = {}
        for s, r in zip(spans, ranges):
            by_phase.setdefault(s["attrs"].get("phase"), []).append(
                (s["attrs"]["bytes"], r[3] / 1e3))
        for phase, calls in by_phase.items():
            nbytes = calls[0][0]
            ms = statistics.median(t for _, t in calls)
            busbw = nbytes / (ms / 1e3) * 2 * (n - 1) / n / 1e9 if ms else 0
            lines.append(f"{phase}: {nbytes / 1e6:.1f} MB, {ms:.3f} ms "
                         f"(median of {len(calls)}), bus {busbw:.1f} GB/s")
    elif spans:
        lines.append(f"{len(spans)} allreduce spans, {len(ranges)} "
                     f"profiled ranges: not paired")
    if rank["counts"]:
        lines.append("counted: " + ", ".join(
            f"{k} {c['calls']} calls {c['bytes'] / 1e6:.1f} MB"
            for k, c in sorted(rank["counts"].items())))
    return lines


def gmain_entries(ranks):
    """[[start ns of each traced Gmain all-reduce, in order] a rank]."""
    return [sorted(s["start"] for s in r["spans"]
                   if s["name"] == "allreduce"
                   and s["attrs"].get("phase") == "Gmain") for r in ranks]


def span_ms(ranks, name):
    """[ms] of every rank's `name` spans."""
    return [(s["end"] - s["start"]) / 1e6 for r in ranks for s in r["spans"]
            if s["name"] == name]
