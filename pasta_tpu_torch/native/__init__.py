"""Native (C++) host preprocessing plugin: threaded batch warp, erosion and
JPEG/PNG decode; the port's copy of `pasta_tpu/native/`.

`warp.cpp` (beside this file) is compiled with g++ against libjpeg and
libpng at first use, into `pasta_tpu_torch/_build/native-<source
digest>/` (git-ignored), and loaded through ctypes. Its functions run in
C++ threads with the interpreter lock released. Where the plugin cannot be
built (no compiler, no libjpeg or libpng headers), `available()` is False
and `build_error()` says why; every caller then takes its cv2 / PIL branch,
as the JAX package's callers do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "warp.cpp")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_VERSION = 2

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _build():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(_BUILD_ROOT, f"native-{digest}")
    so_path = os.path.join(out_dir, "libpasta_native.so")
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               _SRC, "-o", tmp, "-ljpeg", "-lpng"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{res.stderr}")
        os.replace(tmp, so_path)  # atomic: concurrent builds race safely
    return ctypes.CDLL(so_path)


def _bind(lib):
    lib.pasta_warp_perspective_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pasta_warp_perspective_batch.restype = None
    lib.pasta_erode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.pasta_erode_batch.restype = None
    lib.pasta_decode_image.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.pasta_decode_image.restype = ctypes.c_int
    lib.pasta_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.pasta_decode_batch.restype = None
    lib.pasta_native_version.argtypes = []
    lib.pasta_native_version.restype = ctypes.c_int
    version = lib.pasta_native_version()
    if version != _VERSION:
        raise RuntimeError(f"native plugin version {version}, expected "
                           f"{_VERSION}")


def _get_lib():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                lib = _build()
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError) as e:  # no g++, headers, ...
                _build_error = str(e)
    return _lib


def available() -> bool:
    return _get_lib() is not None


def build_error():
    _get_lib()
    return _build_error


def _need_lib():
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native plugin unavailable: {_build_error}")
    return lib


def warp_perspective_batch(src, matrices, out_h, out_w, num_threads=8):
    """Batched cv2-semantics perspective warp on uint8 images.

    Args:
        src:      [N, H, W, C] uint8 (C-contiguous).
        matrices: [N, 3, 3] float64 mapping OUTPUT pixel -> SOURCE pixel
                  (i.e. the inverse of the cv2.warpPerspective M argument).
    Returns [N, out_h, out_w, C] uint8.
    """
    lib = _need_lib()
    src = np.ascontiguousarray(src, np.uint8)
    matrices = np.ascontiguousarray(matrices, np.float64)
    if src.ndim != 4 or matrices.shape != (src.shape[0], 3, 3):
        raise ValueError(f"warp_perspective_batch: src {src.shape}, "
                         f"matrices {matrices.shape}")
    n, h, w, c = src.shape
    dst = np.empty((n, out_h, out_w, c), np.uint8)
    lib.pasta_warp_perspective_batch(
        src.ctypes.data, n, h, w, c, matrices.ctypes.data, dst.ctypes.data,
        out_h, out_w, num_threads)
    return dst


def decode_image(data: bytes):
    """Decode JPEG/PNG bytes with PIL-equivalent channel semantics.

    Returns [H, W] uint8 for grayscale AND palette PNGs (index plane, like
    PIL 'P' mode), [H, W, C] for RGB/RGBA -- i.e. what
    np.array(PIL.Image.open(...)) yields on the dataset's sidecars.
    Raises ValueError on undecodable input.
    """
    lib = _need_lib()
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.pasta_decode_image(buf.ctypes.data, len(data), None, 0,
                                ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"native decode failed (probe rc={rc})")
    dst = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.pasta_decode_image(buf.ctypes.data, len(data), dst.ctypes.data,
                                dst.nbytes, ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"native decode failed (rc={rc})")
    return dst[..., 0] if c.value == 1 else dst


def decode_batch(blobs, h, w, c, num_threads=8):
    """Threaded batch decode of same-geometry images into [N, h, w, c] u8.

    Every blob must decode to exactly (h, w, c); raises ValueError naming
    the first failing index otherwise. Threads run with the interpreter
    lock released, unlike a PIL loop.
    """
    lib = _need_lib()
    n = len(blobs)
    arrs = [np.frombuffer(b, np.uint8) for b in blobs]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    sizes = np.array([a.size for a in arrs], np.int64)
    dst = np.empty((n, h, w, c), np.uint8)
    rc = np.zeros(n, np.int32)
    lib.pasta_decode_batch(ptrs, sizes.ctypes.data, n, dst.ctypes.data,
                           h, w, c, rc.ctypes.data, num_threads)
    if rc.any():
        i = int(np.argmax(rc != 0))
        raise ValueError(f"native batch decode failed at {i} (rc={rc[i]})")
    return dst


def erode_batch(masks, k, num_threads=8):
    """Batched k x k erosion of [N, H, W] uint8 masks (cv2 border rules)."""
    lib = _need_lib()
    masks = np.ascontiguousarray(masks, np.uint8)
    if masks.ndim != 3:
        raise ValueError(f"erode_batch: masks {masks.shape}, not [N, H, W]")
    n, h, w = masks.shape
    dst = np.empty_like(masks)
    lib.pasta_erode_batch(masks.ctypes.data, n, h, w, k, dst.ctypes.data,
                          num_threads)
    return dst
