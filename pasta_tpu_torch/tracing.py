"""Spans of the port's own work, recorded only while a `torch.profiler`
profile is active in the process.

    from pasta_tpu_torch import tracing

    with tracing.span("run_batch", size=8) as s:
        with tracing.span("upload"):          # a child of s
            ...
    spans = tracing.snapshot()

A recorded span holds its name, an id, its parent's id, its start and end
by `time.perf_counter_ns()`, the thread that ran it and its attributes.
The parent is the innermost span open on the same thread, or the one
passed as `parent` (work handed to another thread). Spans opened inside
`with tracing.batch(bid):` carry `batch=bid`, as do the children of a
span that carries one, so that every span of one batch shares its id
whichever thread ran it. Each recorded span also opens
`torch.profiler.record_function("pasta.<name>")`, so it appears on the
profiler's timeline, on the kernels' clock, in any trace exported.

Off a profiler, `span` and `batch` return one shared null context after
a single flag check: they allocate nothing, read no clock and open no
range. The profiler is the one switch. Finished spans stay in memory
until `clear()`, at most CAP of them; past that `dropped()` counts the
spans not kept.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

CAP = 100_000

_profiler = torch.autograd.profiler     # its _is_profiler_enabled flag
_clock = time.perf_counter_ns
_range = torch.profiler.record_function
_local = threading.local()
_lock = threading.Lock()
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_done = []
_dropped = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: `name`, `id`, `parent` (the id of the span it ran under,
    or None), `start` and `end` (ns, `time.perf_counter_ns`), `thread`
    (`threading.get_ident()` of the thread that ran it) and `attrs`."""

    __slots__ = ("name", "id", "parent", "start", "end", "thread", "attrs",
                 "_explicit", "_range")

    def __init__(self, name, parent, attrs):
        self.name, self.attrs, self._explicit = name, attrs, parent

    def __enter__(self):
        stack = _stack()
        parent = self._explicit if self._explicit is not None else (
            stack[-1] if stack else None)
        self.id = next(_span_ids)
        self.parent = None if parent is None else parent.id
        if "batch" not in self.attrs:
            bid = (parent.attrs.get("batch") if parent is not None
                   else getattr(_local, "batch", None))
            if bid is not None:
                self.attrs["batch"] = bid
        self.thread = threading.get_ident()
        stack.append(self)
        self._range = _range("pasta." + self.name)
        self._range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        global _dropped
        with _lock:
            if len(_done) < CAP:
                _done.append(self)
            else:
                _dropped += 1
        return False


def span(name, parent=None, **attrs):
    """A context that records the span `name` while a profiler is active
    (and enters as the `Span`), else the null context (enters as None).
    `parent`, a `Span`, wins over the thread's innermost open span."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, parent, attrs)


class _Batch:
    __slots__ = ("bid", "_prev")

    def __init__(self, bid):
        self.bid = bid

    def __enter__(self):
        self._prev = getattr(_local, "batch", None)
        if self.bid is None:
            self.bid = self._prev if self._prev is not None else new_batch()
        _local.batch = self.bid
        return self.bid

    def __exit__(self, *exc):
        _local.batch = self._prev
        return False


def batch(bid=None):
    """While a profiler is active, a context in which the spans this
    thread opens carry `batch=bid` (with no `bid`: the batch already in
    scope, else a new one); else the null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Batch(bid)


def new_batch():
    """A batch id no other batch of the process has."""
    return next(_batch_ids)


def snapshot():
    """The finished spans, in the order they ended."""
    with _lock:
        return list(_done)


def dropped():
    """Spans finished past CAP and not kept since the last `clear()`."""
    return _dropped


def clear():
    """Forget the finished spans and the dropped count."""
    global _dropped
    with _lock:
        _done.clear()
        _dropped = 0
