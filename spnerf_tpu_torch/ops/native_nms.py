"""Exact greedy NMS on the host through ctypes
(``spnerf_tpu/ops/native_nms.py``).

The port's own copy of the C++ source, ``spnerf_tpu_torch/native/
exact_nms.cpp``, is built with g++ at first use into the git-ignored
``build/spnerf_tpu_torch/native/`` directory by ``utils/native.load``;
the JAX package's source and library are never built or loaded. Where
the reference falls back to its jitted greedy NMS when the build fails,
the port raises with the compiler's output: a slow fallback would hide a
broken build.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.utils import native


def _load():
    lib = native.load("exact_nms")
    lib.exact_nms.restype = ctypes.c_int
    lib.exact_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


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
