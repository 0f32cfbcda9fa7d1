"""K1: hand-written Hopper kernel for the VALID 3x3 convolution, NHWC.

Replaces the Pallas kernel `pasta_tpu/ops/pallas_conv.py::conv3x3_valid`,
both branches: the C_in=64 lane-packed `_kernel_packed` and the C_in=128
`_kernel_direct`. The source is `csrc/conv3x3.cu` (CUDA C++ for sm_90a),
built with nvcc at first use into `pasta_tpu_torch/_build/<digest>/` and
bound through ctypes.

Contract (the Pallas kernel's): x [N, H+2, W', C_in] already carries its
1-px halo; w is HWIO [3, 3, C_in, C_out]; the result is [N, H, out_w, C_out]
in x's dtype with fp32 accumulation; out_w defaults to W' - 2. Scope:
stride 1, groups 1, C_in in {64, 128}, C_out <= 128, bf16 or fp32.

What bounds it on an H100: at [8,514,514,128] x [3,3,128,64] the conv is
~309 GFLOP over ~0.81 GB of input and output, ~380 FLOP/B, just above the
bf16 ridge of ~295 FLOP/B (989 TFLOP/s over 3.35 TB/s), so compute bound;
64 -> 64 is ~285 FLOP/B, at the ridge. The design therefore keeps device
traffic at its floor -- each block stages the 4-row input slab of two
output rows in shared memory once and reuses it for all 9 taps, so an
input pixel is read ~2 times, mostly from L2 -- and puts the arithmetic on
the tensor cores (mma.sync bf16 with fp32 accumulators, ldmatrix on
conflict-free padded rows), with the next tap's weights copied (cp.async)
while the current tap computes. wgmma, TMA and warp specialisation are
later work; see csrc/conv3x3.cu for the tiling.

On a CPU tensor the wrapper computes `conv3x3_valid_plain`; on a CUDA
tensor it launches the kernel or raises -- it never falls back.
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
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "conv3x3.cu")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_lib = None
_lib_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def build():
    """Compile csrc/conv3x3.cu (once per source digest) and load it.

    Returns (ctypes library, seconds spent compiling, compiler output with
    ptxas's register and spill counts); the seconds are 0 and the output
    empty when a library built from the same source is already there.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib, 0.0, ""
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out_dir = os.path.join(_BUILD_ROOT, digest)
        so = os.path.join(out_dir, "libconv3x3.so")
        seconds, log = 0.0, ""
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + _NVCC_FLAGS + ["-Xptxas=-v"]
            t0 = time.perf_counter()
            res = subprocess.run(cmd + ["-o", tmp, _SRC],
                                 capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.pasta_conv3x3_valid
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        return lib, seconds, log


def in_scope(c_in, c_out):
    """Channel scope of K1 (the Pallas kernel's own asserted scope)."""
    return c_in in (64, 128) and c_out <= 128


def conv3x3_valid_plain(x, w, out_w=None):
    """Plain PyTorch version of K1: F.conv2d with no padding, same NHWC
    contract. Used for CPU tensors and as the kernel's reference."""
    out_w = x.shape[2] - 2 if out_w is None else out_w
    xs = x[:, :, :out_w + 2, :].permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x, w, out_w):
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_valid: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3x3_valid: dtype {x.dtype} not bf16/fp32")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(
            f"conv3x3_valid: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if not in_scope(x.shape[3], w.shape[3]):
        raise ValueError(
            f"conv3x3_valid: channels {x.shape[3]}->{w.shape[3]} outside "
            "C_in in {64,128}, C_out <= 128")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_valid: x must be contiguous NHWC, "
                         "16-byte aligned")
    if x.shape[1] < 3 or not 1 <= out_w <= x.shape[2] - 2:
        raise ValueError(
            f"conv3x3_valid: out_w {out_w} for input {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError("conv3x3_valid: x and w on different devices")


def conv3x3_valid(x, w, out_w=None):
    """VALID 3x3 conv: [N, H+2, W', C_in] x [3, 3, C_in, C_out] (HWIO)
    -> [N, H, out_w, C_out]. K1 on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return conv3x3_valid_plain(x, w, out_w)
    out_w = x.shape[2] - 2 if out_w is None else out_w
    _check(x, w, out_w)
    lib, _, _ = build()
    n, hp, wp, ci = x.shape
    co = w.shape[3]
    wk = w.to(x.dtype).contiguous()
    if wk.data_ptr() % 16:
        raise ValueError("conv3x3_valid: w must be 16-byte aligned")
    out = torch.empty((n, hp - 2, out_w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pasta_conv3x3_valid(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            n, hp, wp, ci, co, out_w, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_valid: kernel launch failed, "
                           f"CUDA error {err}")
    conv3x3_valid.launches += 1
    return out


conv3x3_valid.launches = 0

