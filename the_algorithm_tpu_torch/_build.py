"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into ONE shared library with
a plain C interface (no PyTorch headers, so the build takes seconds, not
minutes). The library lands in ``build/kernels/`` under the repository root,
named by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads from disk. Nothing here runs at import time: the CPU tests
import every module of the package on a machine with no ``nvcc``.

Each C entry point takes every pointer and the stream as ``void*`` and returns
the ``cudaError_t`` of its launch; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points (csrc/*.cu); every pointer and the stream
# are void*, or ctypes would pass a 64-bit pointer as a 32-bit int
_SIGNATURES = {
    # ids, v0, v1, v2, out_ids, o0, o1, o2, Q, W, k, cluster, tile, passes, stages, threads, smem, stream
    "run_collapse_sorted": [_P] * 8 + [_I] * 9 + [_P],
    # ids, B, R, k, t0, t1, t2, o0, o1, o2, rb0, rb1, rb2, rows, piece, stages, grid, smem, stream
    "row_gather_ring": [_P, _I, _I, _I] + [_P] * 6 + [_L] * 3 + [_I, _L] + [_I] * 3 + [_P],
    # ids, B, R, k, t0, t1, t2, o0, o1, o2, rb0, rb1, rb2, num_sms, stream
    "row_gather_words": [_P, _I, _I, _I] + [_P] * 6 + [_L] * 3 + [_I, _P],
}


def _sources(suffixes=(".cu",)):
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(suffixes)
    )


def _nvcc() -> str:
    # PyTorch's own lookup: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources((".cu", ".cuh")):  # an edited header rebuilds too
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a torn file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a refused or failed launch (the C side returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
