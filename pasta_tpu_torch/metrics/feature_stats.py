"""Streaming feature statistics with disk cache.

Reference: metrics/metric_utils.py:55-131 (FeatureStats) and the md5-keyed
pickle cache (:186-203). Stores raw features and/or streaming mean/cov.

A copy of pasta_tpu/metrics/feature_stats.py (numpy only), unchanged in
behaviour.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Optional

import numpy as np


class FeatureStats:
    def __init__(self, capture_all=False, capture_mean_cov=False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features):
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.raw_mean = np.zeros(num_features, np.float64)
        self.raw_cov = np.zeros((num_features, num_features), np.float64)

    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


def cache_path(cache_dir, tag, **kwargs):
    """md5-keyed cache filename (metric_utils.py:186-203)."""
    key = json.dumps(kwargs, sort_keys=True, default=str)
    md5 = hashlib.md5(key.encode("utf-8")).hexdigest()
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{tag}-{md5}.pkl")
