"""Metric registry + runners (reference metrics/metric_main.py:24-77), port
of pasta_tpu/metrics/metric_main.py.

The evaluation users run: FID / KID / IS / PR between a folder of
generated try-on results and a folder of reals, and the try-on PPL, with
the reference's cache and jsonl conventions. The detectors run on the
device they were loaded onto (the card unless the caller asks for the
CPU): uint8 batches are uploaded as they are and converted there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict

import numpy as np
import PIL.Image
import torch

from .feature_stats import FeatureStats, cache_path
from .fid import compute_fid
from .inception import InceptionV3, preprocess_images, torchvision_state
from .inception_score import compute_is
from .kid import compute_kid
from .precision_recall import compute_pr

_metric_registry: Dict[str, Callable] = {}


def register_metric(fn):
    _metric_registry[fn.__name__] = fn
    return fn


def is_valid_metric(name):
    return name in _metric_registry


def list_metrics():
    return sorted(_metric_registry)


class DetectorRunner:
    """Batched feature extraction over image folders or arrays.

    kind='inception' -> 2048-d pool3 features (+ softmax probs for IS) of an
                        `InceptionV3`;
    kind='vgg16'     -> 4096-d fc7 features of a `VGG16` (the reference PR
                        detector, metrics/precision_recall.py:37-46; no
                        probs).
    `detector` is the module, on the device the features are computed on.
    """

    def __init__(self, detector, batch_size=32, kind="inception"):
        if kind not in ("inception", "vgg16"):
            raise ValueError(f"detector kind {kind!r}")
        self.detector = detector
        self.batch_size = batch_size
        self.kind = kind
        self.device = next(detector.parameters()).device

    def _features(self, images):
        with torch.no_grad():
            if self.kind == "inception":
                return self.detector(preprocess_images(images),
                                     return_logits=True)
            return self.detector.fc_features(images), None

    def folder_stats(self, folder, capture_all=False, capture_mean_cov=True,
                     max_items=None, capture_probs=False, cache_dir=None,
                     crop=None):
        if cache_dir is not None:
            path = cache_path(cache_dir, "feats", folder=folder,
                              max_items=max_items, crop=crop,
                              detector=self.kind)
            if os.path.exists(path):
                return FeatureStats.load(path)
        files = sorted(
            f for f in os.listdir(folder)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not files:
            raise ValueError(f"no images found in {folder}")
        if max_items is not None:
            files = files[:max_items]
        stats = FeatureStats(capture_all=capture_all or capture_probs,
                             capture_mean_cov=capture_mean_cov,
                             max_items=max_items)
        probs_all = []
        batch = []
        for fname in files:
            img = np.array(PIL.Image.open(
                os.path.join(folder, fname)).convert("RGB"))
            if crop is not None:
                y0, y1, x0, x1 = crop
                img = img[y0:y1, x0:x1]
            batch.append(img)
            if len(batch) == self.batch_size:
                self._flush(batch, stats, probs_all)
                batch = []
        if batch:
            self._flush(batch, stats, probs_all)
        stats.probs = np.concatenate(probs_all) if probs_all else None
        if cache_dir is not None:
            stats.save(path)
        return stats

    def array_stats(self, images_uint8, capture_all=False,
                    capture_mean_cov=True, capture_probs=False):
        """FeatureStats over an in-memory [N, H, W, 3] uint8 array (the
        in-training evaluation: no folder round-trip)."""
        imgs = list(np.asarray(images_uint8))
        stats = FeatureStats(capture_all=capture_all or capture_probs,
                             capture_mean_cov=capture_mean_cov)
        probs_all = []
        for i in range(0, len(imgs), self.batch_size):
            self._flush(imgs[i:i + self.batch_size], stats, probs_all)
        stats.probs = np.concatenate(probs_all) if probs_all else None
        return stats

    def _flush(self, batch, stats, probs_all):
        """One batch: images of another size than the first are resized to
        it on the host (PIL), as in the JAX package; the uint8 stack goes
        to the device as it is."""
        shape0 = batch[0].shape
        arr = np.stack([
            np.asarray(PIL.Image.fromarray(b).resize((shape0[1], shape0[0])))
            if b.shape != shape0 else b for b in batch])
        images = torch.from_numpy(arr)
        if self.device.type == "cuda":
            images = images.pin_memory()
        feats, logits = self._features(
            images.to(self.device, non_blocking=True))
        stats.append(feats.float().cpu().numpy())
        if logits is not None:
            probs_all.append(torch.softmax(logits.float(), dim=-1)
                             .cpu().numpy())


@register_metric
def fid(runner, real_dir, gen_dir, max_items=None, cache_dir=None, crop=None):
    real = runner.folder_stats(real_dir, capture_mean_cov=True,
                               max_items=max_items, cache_dir=cache_dir)
    gen = runner.folder_stats(gen_dir, capture_mean_cov=True,
                              max_items=max_items, crop=crop)
    mu_r, sig_r = real.get_mean_cov()
    mu_g, sig_g = gen.get_mean_cov()
    return {"fid": compute_fid(mu_r, sig_r, mu_g, sig_g)}


@register_metric
def kid(runner, real_dir, gen_dir, max_items=None, cache_dir=None, crop=None):
    real = runner.folder_stats(real_dir, capture_all=True,
                               capture_mean_cov=False, max_items=max_items,
                               cache_dir=cache_dir)
    gen = runner.folder_stats(gen_dir, capture_all=True,
                              capture_mean_cov=False, max_items=max_items,
                              crop=crop)
    return {"kid": compute_kid(real.get_all(), gen.get_all())}


@register_metric
def inception_score(runner, real_dir, gen_dir, max_items=None,
                    cache_dir=None, crop=None):
    gen = runner.folder_stats(gen_dir, capture_probs=True,
                              capture_mean_cov=False, max_items=max_items,
                              crop=crop)
    mean, std = compute_is(gen.probs)
    return {"is_mean": mean, "is_std": std}


@register_metric
def ppl(runner, real_dir, gen_dir, max_items=None, cache_dir=None, crop=None,
        ppl_ctx=None, epsilon=1e-4, interp="lerp", seed=0, t=None):
    """Try-on conditional perceptual path length (metrics/ppl.py). Needs
    `ppl_ctx` from ppl.build_tryon_ppl_ctx (the model and the condition
    endpoints) and a feature extractor: `runner` may be a VGG16 runner
    (LPIPS space) or an Inception one; real_dir and gen_dir are unused.
    `t` is drawn from a torch.Generator seeded with `seed` unless given."""
    if ppl_ctx is None:
        raise ValueError(
            "ppl needs ppl_ctx=build_tryon_ppl_ctx(...): from the command "
            "line, pass --network/--dataroot/--testtxt "
            "(cli/calc_metrics.py)")
    from .ppl import compute_ppl, make_lpips_feature_fn

    if "feature_fn" in ppl_ctx:
        feature_fn = ppl_ctx["feature_fn"]
    elif runner.kind == "vgg16":
        feature_fn = make_lpips_feature_fn(runner.detector)
    else:
        def feature_fn(images_pm1):
            # preprocess_images rescales from [0, 255] (any float dtype)
            return runner.detector(preprocess_images((images_pm1 + 1.0)
                                                     * 127.5))

    codes_a, codes_b = ppl_ctx["codes_a"], ppl_ctx["codes_b"]
    if max_items:
        codes_a, codes_b = codes_a[:max_items], codes_b[:max_items]
    generator = torch.Generator(device=codes_a.device).manual_seed(seed)
    value = compute_ppl(
        ppl_ctx["synth_from_code"], feature_fn, codes_a, codes_b,
        generator=generator, epsilon=epsilon, interp=interp, crop=crop, t=t)
    return {"ppl": value}


@register_metric
def pr(runner, real_dir, gen_dir, max_items=None, cache_dir=None, crop=None):
    real = runner.folder_stats(real_dir, capture_all=True,
                               capture_mean_cov=False, max_items=max_items,
                               cache_dir=cache_dir)
    gen = runner.folder_stats(gen_dir, capture_all=True,
                              capture_mean_cov=False, max_items=max_items,
                              crop=crop)
    precision, recall = compute_pr(real.get_all(), gen.get_all(),
                                   device=runner.device)
    return {"precision": precision, "recall": recall}


def calc_metric(metric, runner, real_dir, gen_dir, run_dir=None, **kwargs):
    """Run one metric; append its record to metric-<name>.jsonl in
    `run_dir` like the reference (metric_main.py:67-77)."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric}")
    # fail fast on empty or missing folders before any feature extraction
    # (ppl synthesizes its own images: no folders)
    if metric != "ppl":
        for d in (real_dir, gen_dir):
            if not os.path.isdir(d):
                raise ValueError(f"not a directory: {d}")
            if not any(f.lower().endswith((".png", ".jpg", ".jpeg"))
                       for f in os.listdir(d)):
                raise ValueError(f"no images found in {d}")
    t0 = time.time()
    results = _metric_registry[metric](runner, real_dir, gen_dir, **kwargs)
    record = dict(
        metric=metric, results=results, total_time=time.time() - t0,
        real_dir=real_dir, gen_dir=gen_dir, timestamp=time.time())
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "at") as f:
            f.write(json.dumps(record) + "\n")
    return record


def _load_state(path):
    """A flat .npz, or a torch state dict (.pth / .pt, tensors only)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def load_detector(path, device="cuda"):
    """InceptionV3 weights (torchvision / pytorch-fid keys, .npz flat or a
    torch state dict) -> the eval-mode module on `device`."""
    state = torchvision_state(_load_state(path))
    model = InceptionV3(num_classes=state["fc.weight"].shape[0])
    model.load_state_dict(state, strict=True)
    return model.eval().to(device)


def load_vgg16_detector(path, lpips_path=None, device="cuda"):
    """torchvision vgg16 weights (+ the LPIPS lin weights) -> the
    eval-mode VGG16 module on `device`."""
    from .vgg16 import VGG16, import_state

    lpips_state = _load_state(lpips_path) if lpips_path else None
    model = VGG16()
    model.load_state_dict(import_state(_load_state(path), lpips_state),
                          strict=True)
    return model.eval().to(device)
