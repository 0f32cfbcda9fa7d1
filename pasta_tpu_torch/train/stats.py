"""Training statistics: moment collection + jsonl sink.

The port's own copy of `pasta_tpu/train/stats.py`, unchanged. Replaces the
reference training_stats (torch_utils/training_stats.py): the reference
accumulates [num, sum, sum-of-squares] per name per device and all-reduces
at collection time. Here each step's metrics are batch means already, so
the host side only aggregates across steps within a tick and writes
stats.jsonl (same file format: {name: {num, mean, std}, timestamp}).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict


class Collector:
    def __init__(self):
        self._num = defaultdict(int)
        self._sum = defaultdict(float)
        self._sumsq = defaultdict(float)

    def report(self, metrics: dict):
        for name, value in metrics.items():
            v = float(value)
            self._num[name] += 1
            self._sum[name] += v
            self._sumsq[name] += v * v

    def mean(self, name, default=0.0):
        n = self._num.get(name, 0)
        return self._sum[name] / n if n else default

    def as_dict(self):
        out = {}
        for name, n in self._num.items():
            mean = self._sum[name] / n
            var = max(self._sumsq[name] / n - mean * mean, 0.0)
            out[name] = {"num": n, "mean": mean, "std": var ** 0.5}
        return out

    def reset(self):
        self._num.clear()
        self._sum.clear()
        self._sumsq.clear()


class Tee:
    """Mirror a stream (stdout) into a log file (reference dnnlib
    util.Logger, dnnlib/util.py:56-112 — file tee + autoflush)."""

    def __init__(self, stream, path, mode="at"):
        self._stream = stream
        self._file = open(path, mode)

    def write(self, text):
        self._stream.write(text)
        self._file.write(text)
        self._file.flush()

    def flush(self):
        self._stream.flush()
        self._file.flush()

    def isatty(self):
        return getattr(self._stream, "isatty", lambda: False)()

    def close(self):
        self._file.close()


class JsonlLogger:
    def __init__(self, run_dir, fname="stats.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, fname)
        self._f = open(self.path, "at")

    def write(self, fields: dict):
        self._f.write(json.dumps({**fields, "timestamp": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
