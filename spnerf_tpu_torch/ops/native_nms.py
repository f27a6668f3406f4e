"""Exact greedy NMS on the host through ctypes
(``spnerf_tpu/ops/native_nms.py``).

The port's own copy of the C++ source, ``spnerf_tpu_torch/native/
exact_nms.cpp``, is built with g++ at first use into the git-ignored
``build/spnerf_tpu_torch/native/`` directory; the JAX package's source and
library are never built or loaded. Where the reference falls back to its
jitted greedy NMS when the build fails, the port raises with the
compiler's output: a slow fallback would hide a broken build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "exact_nms.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" / "spnerf_tpu_torch"
             / "native")
_LIB_PATH = BUILD_DIR / "libexact_nms.so"
_lock = threading.Lock()
_lib = None


def _build() -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("ops.native_nms: g++ not found; it builds "
                           f"{SOURCE} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libexact_nms.{os.getpid()}.tmp.so"
    proc = subprocess.run(
        [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp),
         str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ops.native_nms: g++ failed on {SOURCE}:\n"
                           f"{proc.stderr}")
    tmp.replace(_LIB_PATH)  # atomic: a concurrent loader never sees half


def _load():
    global _lib
    with _lock:
        if _lib is None:
            if (not _LIB_PATH.exists()
                    or _LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.exact_nms.restype = ctypes.c_int
            lib.exact_nms.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads (raises nothing)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def exact_nms(prob: np.ndarray, size: int = 4, iou: float = 0.1,
              min_prob: float = 0.015, keep_top_k: int = 0) -> np.ndarray:
    """Exact greedy NMS on an (H, W) float heatmap -> NMS'd heatmap."""
    lib = _load()
    prob = np.ascontiguousarray(prob, np.float32)
    if prob.ndim != 2:
        raise ValueError(f"exact_nms takes an (H, W) heatmap, got "
                         f"{prob.shape}")
    H, W = prob.shape
    out = np.zeros_like(prob)
    lib.exact_nms(
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
        float(size), float(iou), float(min_prob), int(keep_top_k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
