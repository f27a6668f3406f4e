"""OpenCV's random generator and its RANSAC subset draws, in Python.

``cv::RNG`` is a multiply-with-carry generator on a 64-bit state:
state = (uint32)state * 4164903690 + (state >> 32), each draw the low 32
bits of the new state, and ``uniform(a, b)`` = a + next() % (b - a).
OpenCV's RANSAC (``RANSACPointSetRegistrator::run``) seeds a fresh one
with (uint64)-1 at every call, so its draws repeat from call to call;
``CvRNG()`` starts from that seed. ``draw_subset`` draws a minimal sample
as ``RANSACPointSetRegistrator::getSubset`` does: one index at a time,
each redrawn while it equals an earlier one of the same sample.

A ``np.random.Generator`` may stand in for the generator: its
``integers`` draws then take the place of ``uniform``.

``the_rng()`` is the calling thread's generator ``cv::theRNG()``: OpenCV
keeps one per thread, and each starts at state 0xffffffff (not at
``CvRNG()``'s (uint64)-1), whatever another thread drew or seeded before.
``set_rng_seed`` copies ``cv2.setRNGSeed``, which restarts the calling
thread's generator alone. ``randu`` fills an 8-bit image as ``cv2.randu``
does, in row-major order by ``uniform``; the draws run in C++
(``native/cv_rng.cpp``, built at first use), since a 960 x 1280 fill is
1.2 M draws.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from spnerf_tpu_torch.utils import native

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
_COEFF = 4164903690  # CV_RNG_COEFF


class CvRNG:
    """``cv::RNG``; the default seed is the one OpenCV's RANSAC uses."""

    def __init__(self, state: int = _MASK64):
        self.state = state & _MASK64 or _MASK32  # RNG(0) starts at 2^32 - 1

    def next(self) -> int:
        s = self.state
        self.state = ((s & _MASK32) * _COEFF + (s >> 32)) & _MASK64
        return self.state & _MASK32

    def uniform(self, a: int, b: int) -> int:
        """An int in [a, b) (``RNG::uniform(int, int)``)."""
        return a if a == b else self.next() % (b - a) + a


def _uniform(rng, count: int) -> int:
    if isinstance(rng, CvRNG):
        return rng.uniform(0, count)
    return int(rng.integers(0, count))


def draw_subset(rng, count: int, size: int) -> np.ndarray:
    """``size`` distinct indices in [0, count), drawn in OpenCV's order."""
    idx: list[int] = []
    for _ in range(size):
        i = _uniform(rng, count)
        while i in idx:
            i = _uniform(rng, count)
        idx.append(i)
    return np.array(idx, np.int64)


_THREAD = threading.local()


def the_rng() -> CvRNG:
    """The calling thread's generator (``cv::theRNG()``), made at the
    thread's first use."""
    rng = getattr(_THREAD, "rng", None)
    if rng is None:
        rng = _THREAD.rng = CvRNG(_MASK32)
    return rng


def set_rng_seed(seed: int) -> None:
    """``cv2.setRNGSeed(seed)``: the calling thread's generator restarts
    at ``seed`` (0 at 2^32 - 1)."""
    the_rng().state = CvRNG(int(seed)).state


def randu(img: np.ndarray, low: int, high: int, rng: CvRNG | None = None):
    """``cv2.randu(img, low, high)`` on a contiguous uint8 array, in place,
    from ``rng`` (default: the calling thread's generator): each element
    ``uniform(low, high)`` in row-major order. OpenCV draws ranges of a
    power-of-two width by a bit mask instead; those raise."""
    rng = the_rng() if rng is None else rng
    low, high = int(low), int(high)
    d = high - low
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError(f"randu fills a contiguous uint8 array, got "
                         f"{img.dtype}")
    if not 0 <= low < high <= 256 or d & (d - 1) == 0:
        raise ValueError(f"randu: range [{low}, {high}) is not reproduced "
                         "(8-bit, width not a power of two)")
    lib = native.load("cv_rng")
    lib.cv_rng_fill_u8.restype = ctypes.c_uint64
    lib.cv_rng_fill_u8.argtypes = [ctypes.c_uint64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_uint32]
    rng.state = lib.cv_rng_fill_u8(rng.state, img.ctypes.data, img.size,
                                   low, d)
    return img
