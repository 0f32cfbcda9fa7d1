"""The port's own spans (`pasta_tpu_torch.tracing`), as the per-layer
readers see them: read in-process after the run (the port records them
only while a profiler is active, so only inside the traced span), and
mapped onto the clock of the traced span's kernels.

The first reader of a run takes the port's spans and empties its store,
so a process that runs several cells reads each run's own spans.

The mapping anchors on the drivers' labels: both drivers open
`bench.run_batch` around each traced call of the port's `run_batch`, so
the k-th label and the k-th recorded `run_batch` span are one call, and
the span lies inside its label on one thread. Each pair so bounds the
offset between the two clocks: at most (span start - label start), at
least (span end - label end). The offset is the middle of the tightest
bounds over all pairs; where the counts differ, or the bounds leave more
than MAX_SPREAD_US between them or contradict each other, there is no
mapping. (The median of the start differences would move with the
serving thread's waits for the interpreter lock between label and span,
which in the stream the prep threads hold.)

Where the port has no `tracing` module (a program older than its spans)
every function here returns None.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import importlib.util
import statistics

from .trace import MARK_KERNEL, union

ANCHOR = "run_batch"
MAX_SPREAD_US = 200.0
DISPATCH = ("upload", "replay", "ingest", "assemble", "generator",
            "run_batch")


def spans(run):
    """The port's spans recorded since the last run's were read, or None
    where the port has no span recorder."""
    if not hasattr(run, "port_spans"):
        run.port_spans = None
        if importlib.util.find_spec("pasta_tpu_torch.tracing") is not None:
            tracing = importlib.import_module("pasta_tpu_torch.tracing")
            run.port_spans = tracing.snapshot()
            tracing.clear()
    return run.port_spans


def median_ms(run, name):
    """Median ms of the run's port spans named `name`, or None."""
    found = spans(run) or []
    ms = [(s.end - s.start) / 1e6 for s in found if s.name == name]
    return statistics.median(ms) if ms else None


def anchor(labels, found):
    """(offset us or None, what the note says of it): the port's clock (ns)
    to the trace's (us), trace us = span ns / 1e3 - offset; None where the
    k-th `run_batch` label and span cannot be paired or bound it to
    within MAX_SPREAD_US."""
    marks = sorted((s, e) for name, s, e in labels if name == ANCHOR)
    ports = sorted((s.start / 1e3, s.end / 1e3) for s in found
                   if s.name == ANCHOR)
    if not marks or len(marks) != len(ports):
        return None, (f"{len(marks)} run_batch labels, {len(ports)} "
                      "run_batch spans")
    starts = [p[0] - m[0] for p, m in zip(ports, marks)]
    high = min(starts)
    low = max(p[1] - m[1] for p, m in zip(ports, marks))
    what = (f"offset bounds {high - low:.1f} us apart over {len(marks)} "
            f"run_batch spans (start differences spread "
            f"{max(starts) - min(starts):.1f} us)")
    if not 0 <= high - low <= MAX_SPREAD_US:
        return None, what
    return (low + high) / 2, what


class Idle:
    """The stretches of [lo, hi] in which no kernel of `kernels` (name,
    start, end) ran, as sorted disjoint `pieces`."""

    def __init__(self, kernels, lo, hi):
        self.pieces, t = [], lo
        for s, e in union([(s, e) for _, s, e in kernels
                           if e > lo and s < hi]):
            if s > t:
                self.pieces.append((t, s))
            t = max(t, e)
        if t < hi:
            self.pieces.append((t, hi))
        self._ends = [e for _, e in self.pieces]

    def within(self, a, b):
        """The idle length inside [a, b]."""
        total = 0.0
        for s, e in self.pieces[bisect.bisect_right(self._ends, a):]:
            if s >= b:
                break
            total += min(e, b) - max(s, a)
        return total


def innermost(mapped, lo, hi):
    """[(start, end, name)] covering [lo, hi]: each stretch with the
    innermost of `mapped` (name, start, end) open over it, None where
    none is."""
    cuts = sorted({lo, hi} | {t for _, a, b in mapped for t in (a, b)
                              if lo < t < hi})
    out = []
    for t0, t1 in zip(cuts, cuts[1:]):
        mid = (t0 + t1) / 2
        open_ = [(a, name) for name, a, b in mapped if a <= mid < b]
        out.append((t0, t1, max(open_)[1] if open_ else None))
    return out


def dispatch_idle(run):
    """(per counted `run_batch` span the device's idle us inside it, or
    None; the note that splits the window's idle by the innermost port
    span open on the serving thread, or says why there is none), or None
    where the run recorded no spans. A span counts where it lies within
    the marked window (from the first mark to the last, on the device):
    before the first mark the device may run work queued before the
    profiler started, which the trace does not hold."""
    found = spans(run)
    if not found or run.trace is None:
        return None
    offset, how = anchor(run.trace.labels, found)
    if offset is None:
        return None, f"dispatch idle: no mapping onto the trace: {how}"
    marks = [s for name, s, _ in run.trace.kernels if MARK_KERNEL in name]
    lo, hi = marks[0], marks[-1]
    thread = next(s.thread for s in found if s.name == ANCHOR)
    mapped = [(s.name, s.start / 1e3 - offset, s.end / 1e3 - offset)
              for s in found if s.thread == thread]
    counted = [(a, b) for name, a, b in mapped
               if name == ANCHOR and lo <= a and b <= hi]
    if not counted:
        return None, f"dispatch idle: no run_batch span in the window; {how}"
    gaps = Idle(run.trace.kernels, lo, hi)
    split = collections.Counter()
    for t0, t1, name in innermost(mapped, lo, hi):
        split[name or "none"] += gaps.within(t0, t1)
    host = collections.Counter()
    for name, a, b in mapped:
        if lo <= a and b <= hi:
            host[name] += b - a
    n = len(counted)

    def ms(counter):
        return "; ".join(f"{k} {v / 1e3 / n:.3f}" for k, v in counter)

    note = (f"dispatch idle split, ms a batch over {n} batches inside "
            f"run_batch: {ms((k, split.pop(k, 0.0)) for k in DISPATCH)} | "
            f"in the window outside run_batch: "
            f"{ms((k, v) for k, v in split.most_common() if v > 0) or '0'}"
            f" | the serving thread's host ms a batch in the window: "
            f"{ms(host.items())} | {how}")
    return [gaps.within(a, b) for a, b in counted], note


def dispatch_idle_ms(run):
    """The median over the counted batches of the device's idle ms inside
    each batch's `run_batch` span; appends the idle split (or why there is
    none) to `run.notes`. None where the spans cannot be read or mapped."""
    got = dispatch_idle(run)
    if got is None:
        return None
    per_batch, note = got
    run.notes.append(note)
    return statistics.median(per_batch) / 1e3 if per_batch else None
