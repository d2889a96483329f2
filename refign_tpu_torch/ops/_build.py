"""Build the CUDA C++ kernels under ``refign_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``build/kernels/<name>-<hash>.so`` inside the package
(``build/`` is git-ignored), then loads with ``ctypes``.  The hash is of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header builds anew and an unchanged one is reused.  Nothing is
built at import: the first launch of a kernel builds it, or
:func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")

# -Xptxas -v lists each kernel's registers, shared memory and spills in
# the build log that build_all returns
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    # the source, the shared headers it may include, and the flags
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` that is not built yet, one nvcc each, all
    in parallel; returns nvcc's log for each source it built."""
    started = {n: _start(n) for n in kernel_names()}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib
