"""A bounded traced span of a run: torch.profiler (CPU and CUDA) around
it, reduced to kernel intervals, the device's busy time, the batches (or
steps) the span holds whole, and the breakdown the result line carries.

The harness marks the start of each batch or step in the span with a
tiny kernel of its own (`mark`, PyTorch's `spin_kernel`) on the stream the
work runs on, so the device's kernels between two marks are one batch's:
the work runs on one stream, in the order it was queued. Host labels are
`record_function` ranges on the harness's thread.
"""

from __future__ import annotations

import collections
import contextlib

import torch

MARK_KERNEL = "spin_kernel"
TOP = 10


def busy_us(intervals):
    """Length of the union of (start, end) intervals (profile_serving's)."""
    busy = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def mark():
    """Queue the marker kernel on the current stream."""
    torch.cuda._sleep(1)


class Span:
    """Profile what runs inside `with span:`; afterwards `kernels` holds
    (name, start us, end us) of every device kernel, `labels` the host
    ranges (name, start us, end us) the harness opened with `label`,
    `window_s` the time from the first mark to the last on the device's
    clock and `busy_s` the union of the kernels' intervals within it."""

    def __init__(self):
        self.kernels, self.labels = [], []
        self.window_s = self.busy_s = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.read(self._prof.events())
        self._prof = None
        return False

    def read(self, events):
        """Take the kernels, the labels and the marked window from the
        profiler's events."""
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            label = e.name.startswith("bench.")
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a label's range on the device's timeline is no kernel
                if (not label and not getattr(e, "is_user_annotation", False)
                        and (end > start or MARK_KERNEL in e.name)):
                    self.kernels.append((e.name, start, end))
            elif label:
                self.labels.append((e.name[len("bench."):], start, end))
        if not self.kernels:
            raise RuntimeError("the trace holds no device time")
        self.kernels.sort(key=lambda k: k[1])
        marks = [s for name, s, _ in self.kernels if MARK_KERNEL in name]
        if len(marks) < 2:
            names = sorted({n for n, _, _ in self.kernels})
            raise RuntimeError(f"the trace holds {len(marks)} marks among "
                               f"{len(self.kernels)} kernels: {names[:20]}")
        # the window: from the first mark to the last, on the device's
        # clock, so that work queued before the profiler started and the
        # drain at its end are both left out
        lo, hi = self._lo, self._hi = marks[0], marks[-1]
        self.window_s = (hi - lo) / 1e6
        self.busy_s = busy_us([(max(s, lo), min(e, hi))
                               for _, s, e in self.kernels
                               if e > lo and s < hi]) / 1e6

    def _inside(self):
        """The kernels of the marked window, cut to it."""
        return [(n, s, min(e, self._hi)) for n, s, e in self.kernels
                if self._lo <= s < self._hi]

    def segments(self):
        """Kernels between consecutive marks: one list a whole batch or
        step (the part before the first mark and after the last one is
        left out)."""
        segs, cur = [], None
        for k in self.kernels:
            if MARK_KERNEL in k[0]:
                if cur is not None:
                    segs.append(cur)
                cur = []
            elif cur is not None:
                cur.append(k)
        return segs

    def segment_spans(self):
        """[(seconds from a mark to the end of the last operation before
        the next mark, seconds busy within it)] of each whole segment:
        a request's own time on the device, without the wait for the
        next one."""
        out = []
        marks = [s for name, s, _ in self.kernels if MARK_KERNEL in name]
        for seg, start in zip(self.segments(), marks):
            if seg:
                end = max(e for _, _, e in seg)
                out.append(((end - start) / 1e6,
                            busy_us([(s, e) for _, s, e in seg]) / 1e6))
        return out

    def device_ops(self):
        """[[kernel name, seconds]] of the TOP kernels by total time."""
        total = collections.Counter()
        for name, s, e in self._inside():
            if MARK_KERNEL not in name:
                total[name] += (e - s) / 1e6
        return [[n, t] for n, t in total.most_common(TOP)]

    def idle_gaps(self):
        """[[what the harness's thread was doing, seconds]] of the TOP
        longest stretches of the marked window in which no kernel ran:
        the innermost label that covers the stretch's middle, "other"
        where none does."""
        edges = [self._lo] + [t for iv in union(
            [(s, e) for _, s, e in self._inside()]) for t in iv] + [self._hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:TOP]:
            mid = (s + e) / 2
            inside = [lb for lb in self.labels if lb[1] <= mid <= lb[2]]
            name = (min(inside, key=lambda lb: lb[2] - lb[1])[0]
                    if inside else "other")
            out.append([name, (e - s) / 1e6])
        return out


@contextlib.contextmanager
def label(name):
    """A host range the breakdown names gaps by (`bench.<name>`)."""
    with torch.profiler.record_function(f"bench.{name}"):
        yield
