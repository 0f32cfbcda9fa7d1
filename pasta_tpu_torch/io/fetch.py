"""Cached URL/file fetcher, port of pasta_tpu/io/fetch.py (reference:
dnnlib/util.py:382-477 open_url); host code, copied unchanged in
behaviour.

The reference downloads metric detectors and resume pickles through a
md5-keyed on-disk cache (`~/.cache/dnnlib`). This deployment is
zero-egress by policy, so the network path is OFF by default and every
weight is file-supplied; the fetcher still provides:

  * local paths and file:// URLs -- always allowed, cached (so repeated
    metric runs hit one canonical copy, like the reference's cache);
  * http(s) URLs -- only when PASTA_ALLOW_NETWORK=1 is set by the operator
    (urllib, no extra deps); otherwise a RuntimeError explains the gate.

Cache writes are atomic (temp file + rename) and keyed by the url's md5,
mirroring dnnlib/util.py:438-477. The cache lives in $PASTA_CACHE_DIR, by
default ~/.cache/pasta_tpu_torch.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.parse
import urllib.request

_ENV_GATE = "PASTA_ALLOW_NETWORK"


def make_cache_dir_path(*paths: str) -> str:
    """$PASTA_CACHE_DIR/<paths...>, by default under
    ~/.cache/pasta_tpu_torch (dnnlib/util.py:118-133)."""
    root = os.environ.get(
        "PASTA_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "pasta_tpu_torch"))
    path = os.path.join(root, *paths)
    os.makedirs(path, exist_ok=True)
    return path


def _is_url(obj: str) -> bool:
    try:
        parsed = urllib.parse.urlparse(obj)
        return parsed.scheme in ("http", "https", "file")
    except (ValueError, AttributeError):
        return False


def fetch_path(url: str, cache_dir: str | None = None,
               cache: bool = True) -> str:
    """Resolve `url` to a local file path, via the cache for URLs.

    Plain filesystem paths are returned as-is (existence-checked).
    """
    if not _is_url(url):
        if not os.path.isfile(url):
            raise FileNotFoundError(url)
        return url

    parsed = urllib.parse.urlparse(url)
    if parsed.scheme == "file":
        src = urllib.request.url2pathname(parsed.path)
        if not cache:
            if not os.path.isfile(src):
                raise FileNotFoundError(url)
            return src
        return _cache_copy(url, src, cache_dir)

    # http(s): gated — this framework targets zero-egress deployments.
    if os.environ.get(_ENV_GATE, "0") != "1":
        raise RuntimeError(
            f"network fetch of {url!r} is disabled (zero-egress default); "
            f"set {_ENV_GATE}=1 to allow downloads, or supply the file "
            "locally and pass its path")

    key = hashlib.md5(url.encode("utf-8")).hexdigest()
    name = os.path.basename(parsed.path) or "download"
    cache_dir = cache_dir or make_cache_dir_path("downloads")
    dst = os.path.join(cache_dir, f"{key}-{name}")
    if cache and os.path.isfile(dst):
        return dst
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as out, \
                urllib.request.urlopen(url) as resp:  # noqa: S310 -- gated
            shutil.copyfileobj(resp, out)
        os.replace(tmp, dst)  # atomic publish (dnnlib/util.py:470-473)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dst


def _cache_copy(url: str, src: str, cache_dir: str | None) -> str:
    key = hashlib.md5(url.encode("utf-8")).hexdigest()
    cache_dir = cache_dir or make_cache_dir_path("downloads")
    dst = os.path.join(cache_dir, f"{key}-{os.path.basename(src)}")
    if not os.path.isfile(dst):
        if not os.path.isfile(src):
            raise FileNotFoundError(url)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        os.close(fd)
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
    return dst


def open_url(url: str, cache_dir: str | None = None, cache: bool = True):
    """Binary file object for `url` (reference open_url return contract)."""
    return open(fetch_path(url, cache_dir=cache_dir, cache=cache), "rb")
