"""Build and load the port's CUDA sources (csrc/*.cu) with nvcc + ctypes.

Each source compiles once per source digest into
`pasta_tpu_torch/_build/<digest>/lib<name>.so` (git-ignored), for sm_90a,
with ptxas's register and spill report kept for the caller to print. The
libraries have a plain C interface: pointers and the stream go as
ctypes.c_void_p, sizes as ctypes.c_int.

In a process group (train/entry.py), the first rank of each host builds a
missing library while the host's other ranks wait at a barrier, and then
every rank loads it: each rank reaches its first launch of a library at
the same point of the step, so each passes that barrier once a library.

`pin_fp32_numerics` is the one place that sets how a process of the port
computes fp32 convolutions and matrix products; every entry point calls it
first, and `train/entry.py::spawn` calls it in each rank it starts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch
import torch.distributed as dist

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs = {}
_lock = threading.Lock()


def pin_fp32_numerics():
    """Full fp32 products for fp32 convolutions and matrix products in this
    process: TF32 off in cuDNN and in cuBLAS (PyTorch's default leaves
    cuDNN's on). The JAX package's CLI calls fp32 the reference inference
    numerics, and the reference's StyleGAN2-ADA training loop turns TF32
    off too. The flags belong to the process; a spawned rank sets its own.
    Returns the two flags as a run records them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def load_library(source, bind):
    """Compile csrc/<source> (once per source digest) and load it.

    `bind(lib)` declares the argtypes and restype of the library's
    functions. Returns (ctypes library, seconds spent compiling, compiler
    output); the seconds are 0 and the output empty when the library was
    already loaded or built from the same source. Builds of different
    sources may run in parallel threads, outside a process group.
    """
    with _lock:
        if source in _libs:
            return _libs[source], 0.0, ""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(_BUILD_ROOT, digest)
    so = os.path.join(out_dir, f"lib{os.path.splitext(source)[0]}.so")
    seconds, log = 0.0, ""
    ranked = dist.is_available() and dist.is_initialized()
    builds = not ranked or os.environ.get("LOCAL_RANK", "0") == "0"
    if builds and not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc()] + _NVCC_FLAGS + ["-o", tmp, src],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, so)
    if ranked:
        from ..train.entry import barrier

        barrier()
    lib = ctypes.CDLL(so)
    bind(lib)
    with _lock:
        lib = _libs.setdefault(source, lib)
    return lib, seconds, log
