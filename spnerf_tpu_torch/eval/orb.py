"""OpenCV's ORB without cv2: ``cv2.ORB_create(nfeatures).detectAndCompute``
of an 8-bit gray image with no mask, keypoints and binary descriptors.

The detector and descriptor run in the port's own C++
(``native/cv_orb.cpp``, built by g++ at first use, called outside the
GIL): OpenCV 5.0's pyramid (``INTER_LINEAR_EXACT``), FAST-9, the Harris
ranking, intensity-centroid angles and rBRIEF over OpenCV's
``bit_pattern_31_``, with ORB's defaults (scale 1.2, 8 levels,
edgeThreshold 31, WTA_K 2, patchSize 31, fastThreshold 20). The
reference runs ORB on the host through cv2, so it runs on the host here
too.

``orb(image, nfeatures)`` returns an ``Orb`` of arrays, one row a
keypoint in cv2's order: ``pt`` (N, 2) x, y at level 0; ``size``,
``angle`` (degrees), ``response`` (N,) float32; ``octave`` (N,) int32,
the pyramid level; ``desc`` (N, 32) uint8, as cv2 returns them.
``pattern()`` is the 1,024 ints of the rBRIEF table compiled in;
``resize_linear_exact`` (``cv2.resize(..., INTER_LINEAR_EXACT)``) and
``pyramid_blur`` (``cv2.GaussianBlur`` 7 x 7, sigma 2, of a level inside
ORB's pyramid buffer) are two of its steps alone.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from spnerf_tpu_torch.utils import native

DESCRIPTOR_SIZE = 32  # bytes


@dataclass(frozen=True)
class Orb:
    pt: np.ndarray
    size: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    octave: np.ndarray
    desc: np.ndarray

    def __len__(self) -> int:
        return int(self.size.shape[0])


def _lib():
    lib = native.load("cv_orb")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.cv_orb_detect.argtypes = [ptr, i32, i32, i32]
    lib.cv_orb_detect.restype = ptr
    lib.cv_orb_count.argtypes = [ptr]
    lib.cv_orb_count.restype = ctypes.c_int64
    lib.cv_orb_fetch.argtypes = [ptr, ptr, ptr, ptr]
    lib.cv_orb_fetch.restype = None
    lib.cv_orb_free.argtypes = [ptr]
    lib.cv_orb_free.restype = None
    lib.cv_orb_pattern.argtypes = [ptr]
    lib.cv_orb_pattern.restype = None
    lib.cv_orb_resize.argtypes = [ptr, i32, i32, ptr, i32, i32]
    lib.cv_orb_resize.restype = None
    lib.cv_orb_blur.argtypes = [ptr, i32, i32, ptr]
    lib.cv_orb_blur.restype = None
    return lib


def _gray(image: np.ndarray, name: str) -> np.ndarray:
    image = np.ascontiguousarray(image)
    if image.ndim != 2 or image.dtype != np.uint8 or image.size == 0:
        raise ValueError(f"{name} takes a non-empty (H, W) uint8 image, got "
                         f"{image.shape} {image.dtype}")
    return image


def pattern() -> np.ndarray:
    """The (1024,) int32 rBRIEF table of ``native/cv_orb.cpp``."""
    out = np.empty(1024, np.int32)
    _lib().cv_orb_pattern(out.ctypes.data)
    return out


def resize_linear_exact(image: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(image, size, interpolation=INTER_LINEAR_EXACT)`` of an
    (H, W) uint8 image, ``size`` = (width, height)."""
    image = _gray(image, "resize_linear_exact")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_linear_exact: empty size {size}")
    out = np.empty((dh, dw), np.uint8)
    _lib().cv_orb_resize(image.ctypes.data, image.shape[0], image.shape[1],
                         out.ctypes.data, dh, dw)
    return out


def pyramid_blur(image: np.ndarray) -> np.ndarray:
    """ORB's descriptor blur of one pyramid level: ``GaussianBlur(level,
    (7, 7), 2, 2, BORDER_REFLECT_101)`` as cv2 computes it on a sub-matrix
    of its pyramid buffer (the float32 path; ``native/cv_orb.cpp``)."""
    image = _gray(image, "pyramid_blur")
    out = np.empty_like(image)
    _lib().cv_orb_blur(image.ctypes.data, image.shape[0], image.shape[1],
                       out.ctypes.data)
    return out


def orb(image: np.ndarray, nfeatures: int = 500) -> Orb:
    """``cv2.ORB_create(nfeatures).detectAndCompute(image, None)`` of an
    (H, W) uint8 image."""
    image = _gray(image, "orb")
    if nfeatures < 0:
        raise ValueError(f"orb: nfeatures {nfeatures} < 0")
    lib = _lib()
    handle = lib.cv_orb_detect(image.ctypes.data, image.shape[0],
                               image.shape[1], int(nfeatures))
    if not handle:  # cv2's resize asserts on the empty level
        raise ValueError(f"orb: {image.shape} is too small for 8 levels at "
                         f"scale 1.2 (a level would be empty)")
    try:
        n = int(lib.cv_orb_count(handle))
        kp = np.empty((n, 5), np.float32)
        octave = np.empty(n, np.int32)
        desc = np.empty((n, DESCRIPTOR_SIZE), np.uint8)
        lib.cv_orb_fetch(handle, kp.ctypes.data, octave.ctypes.data,
                         desc.ctypes.data)
    finally:
        lib.cv_orb_free(handle)
    return Orb(pt=kp[:, :2].copy(), size=kp[:, 2].copy(),
               angle=kp[:, 3].copy(), response=kp[:, 4].copy(),
               octave=octave, desc=desc)
