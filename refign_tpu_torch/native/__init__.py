"""Native (C++/OpenMP) host correlation, built on demand with g++ and bound
through ctypes (counterpart of ``refign_tpu/native``, with its functions).

``correlation.cc`` is the port's own copy of the JAX package's source.  It
runs on no path of the port: it is an independent numerics oracle of the
local correlation (kernel K3 and its plain version,
``refign_tpu_torch/ops/correlation.py``) on host arrays.  The library
builds at first use into the package's git-ignored
``build/native/libnative-<hash>.so`` (the hash of the source, the flags
and the host CPU that ``-march=native`` builds for, as ``ops/_build.py``
keys the kernels), never next to the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

__all__ = ["get_lib", "correlation_forward", "correlation_backward"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "correlation.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


def _host_cpu() -> bytes:
    """The host CPU's model and flags (``-march=native`` builds for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(sorted({l for l in lines
                               if l.startswith((b"model name", b"flags"))}))


def _lib_path() -> str:
    h = hashlib.sha1()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    return os.path.join(BUILD_DIR, f"libnative-{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    # compile to a pid-unique path and rename into place: a concurrent
    # process (a pytest-xdist worker) loads either no library or a whole one
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for native/correlation.cc "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.correlation_forward_nhwc.argtypes = [f32p, f32p, f32p,
                                                 i64, i64, i64, i64, i64]
        lib.correlation_backward_nhwc.argtypes = [f32p, f32p, f32p, f32p,
                                                  f32p, i64, i64, i64, i64,
                                                  i64]
        lib.correlation_forward_nhwc.restype = None
        lib.correlation_backward_nhwc.restype = None
        _LIB = lib
        return lib


def correlation_forward(target: np.ndarray, source: np.ndarray,
                        patch_size: int = 9) -> np.ndarray:
    """NHWC local correlation on the host: (N,H,W,C) x (N,H,W,C) ->
    (N,H,W,P*P), fp32."""
    lib = get_lib()
    target = np.ascontiguousarray(target, np.float32)
    source = np.ascontiguousarray(source, np.float32)
    N, H, W, C = target.shape
    out = np.empty((N, H, W, patch_size * patch_size), np.float32)
    lib.correlation_forward_nhwc(target, source, out, N, H, W, C,
                                 patch_size)
    return out


def correlation_backward(target: np.ndarray, source: np.ndarray,
                         grad_out: np.ndarray, patch_size: int = 9):
    """The gradients of ``correlation_forward`` with respect to the target
    and the source, for the output gradient ``grad_out``."""
    lib = get_lib()
    target = np.ascontiguousarray(target, np.float32)
    source = np.ascontiguousarray(source, np.float32)
    grad_out = np.ascontiguousarray(grad_out, np.float32)
    N, H, W, C = target.shape
    gt = np.empty_like(target)
    gs = np.empty_like(source)
    lib.correlation_backward_nhwc(target, source, grad_out, gt, gs,
                                  N, H, W, C, patch_size)
    return gt, gs
