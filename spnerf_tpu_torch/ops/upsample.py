"""Integer-factor bicubic upsampling with Keys a = -0.75 and clamped
borders (``spnerf_tpu/ops/upsample.py``), the geometry of
``F.interpolate(..., mode='bicubic', align_corners=False)``.

For an integer factor the fractional source offsets cycle through
``factor`` fixed phases, so each axis is a phase-weighted sum of 4
shifted slices of the edge-padded input, with the weights of a
float32 table built once per factor, in the reference's order of sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(t: float, a: float = -0.75) -> np.ndarray:
    """Weights for source offsets (-1, 0, 1, 2) at fractional position t."""

    def w(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    return np.array([w(t + 1), w(t), w(1 - t), w(2 - t)], np.float32)


@functools.lru_cache(maxsize=None)
def _phase_table(factor: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase (base offset, 4-tap weights) for align_corners=False."""
    bases = np.zeros(factor, np.int32)
    weights = np.zeros((factor, 4), np.float32)
    for p in range(factor):
        src = (p + 0.5) / factor - 0.5
        base = int(np.floor(src))
        bases[p] = base
        weights[p] = _cubic_kernel(src - base)
    return bases, weights


def _upsample_axis(x: torch.Tensor, factor: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    bases, weights = _phase_table(factor)
    # clamp at the border = edge padding by 2 on each side
    xp = torch.cat([x.narrow(axis, 0, 1)] * 2 + [x]
                   + [x.narrow(axis, n - 1, 1)] * 2, dim=axis)
    phases = []
    for p in range(factor):
        acc = None
        for k in range(4):
            term = xp.narrow(axis, int(bases[p]) - 1 + k + 2, n) \
                * float(weights[p, k])
            acc = term if acc is None else acc + term
        phases.append(acc)
    stacked = torch.stack(phases, dim=axis + 1)  # (..., n, factor, ...)
    shape = list(x.shape)
    shape[axis] = n * factor
    return stacked.reshape(shape)


def upsample_bicubic(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bicubic-upsample (B, H, W, C) by an integer factor on H and W."""
    return _upsample_axis(_upsample_axis(x, factor, axis=1), factor, axis=2)
