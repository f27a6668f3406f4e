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
"""

from __future__ import annotations

import numpy as np

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
