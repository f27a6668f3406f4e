"""OpenCV's SIFT without cv2: ``cv2.SIFT_create(nfeatures).detectAndCompute``
of an 8-bit gray image with no mask, keypoints and float32 descriptors.

The detector and descriptor run in the port's own C++
(``native/cv_sift.cpp``, built by g++ at first use, called outside the
GIL): OpenCV 5.0's pyramid, extrema, refinement, orientations, selection
and descriptor, each float32 sum in OpenCV's order. SIFT has no work on
the card in the reference either (cv2 runs it on the host), so it runs on
the host here too.

``sift(image, nfeatures)`` returns a ``Sift`` of arrays, one row a
keypoint in cv2's order: ``pt`` (N, 2) x, y; ``size``, ``angle``,
``response`` (N,) float32; ``octave`` (N,) int32, cv2's packed word
(octave in the low byte, layer in the next, the sub-layer offset above);
``desc`` (N, 128) float32 with integer values 0-255, as cv2 returns them.
``lanes`` is the vector width whose rounding cv2 reproduces: 16 where the
CPU has AVX-512 (cv2's AVX512_SKX dispatch), else 8 (AVX2); None takes
this CPU's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from spnerf_tpu_torch.utils import native

DESCRIPTOR_SIZE = 128


@dataclass(frozen=True)
class Sift:
    pt: np.ndarray
    size: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    octave: np.ndarray
    desc: np.ndarray

    def __len__(self) -> int:
        return int(self.size.shape[0])


def _lib():
    lib = native.load("cv_sift")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.cv_sift_lanes.argtypes = []
    lib.cv_sift_lanes.restype = i32
    lib.cv_sift_detect.argtypes = [ptr, i32, i32, i32, i32]
    lib.cv_sift_detect.restype = ptr
    lib.cv_sift_count.argtypes = [ptr]
    lib.cv_sift_count.restype = ctypes.c_int64
    lib.cv_sift_fetch.argtypes = [ptr, ptr, ptr, ptr]
    lib.cv_sift_fetch.restype = None
    lib.cv_sift_free.argtypes = [ptr]
    lib.cv_sift_free.restype = None
    return lib


def dispatch_lanes() -> int:
    """The vector width cv2's SIFT dispatches to on this CPU."""
    return int(_lib().cv_sift_lanes())


def sift(image: np.ndarray, nfeatures: int = 0,
         lanes: int | None = None) -> Sift:
    """``cv2.SIFT_create(nfeatures).detectAndCompute(image, None)`` of an
    (H, W) uint8 image."""
    image = np.ascontiguousarray(image)
    if image.ndim != 2 or image.dtype != np.uint8 or image.size == 0:
        raise ValueError(f"sift takes a non-empty (H, W) uint8 image, got "
                         f"{image.shape} {image.dtype}")
    if nfeatures < 0:
        raise ValueError(f"sift: nfeatures {nfeatures} < 0")
    lib = _lib()
    lanes = int(lib.cv_sift_lanes()) if lanes is None else int(lanes)
    if lanes not in (8, 16):
        raise ValueError(f"sift: lanes {lanes} is not 8 or 16")
    handle = lib.cv_sift_detect(image.ctypes.data, image.shape[0],
                                image.shape[1], int(nfeatures), lanes)
    try:
        n = int(lib.cv_sift_count(handle))
        kp = np.empty((n, 5), np.float32)
        octave = np.empty(n, np.int32)
        desc = np.empty((n, DESCRIPTOR_SIZE), np.float32)
        lib.cv_sift_fetch(handle, kp.ctypes.data, octave.ctypes.data,
                          desc.ctypes.data)
    finally:
        lib.cv_sift_free(handle)
    return Sift(pt=kp[:, :2].copy(), size=kp[:, 2].copy(),
                angle=kp[:, 3].copy(), response=kp[:, 4].copy(),
                octave=octave, desc=desc)
