"""Bilinear resizing of 8-bit images as ``cv2.resize(img, (W, H))``
(``INTER_LINEAR``) computes it, in numpy (no cv2 on the card's machine).

OpenCV works in fixed point: each source column and row gets two 11-bit
weights, round(2048 (1 - f)) and round(2048 f), from f = (dst + 0.5)
scale - 0.5 in float32 (scale = 1 / (dst / src), float64), clamped at
the borders. The horizontal pass sums exactly in int32. The vertical
pass is OpenCV's SIMD one over whole rows (its row tail too, on every
tested width): ((a >> 4) b0 >> 16) + ((c >> 4) b1 >> 16) with 16-bit
saturation, then (x + 2) >> 2, which is not always the exact (a b0 + c b1
+ 2^21) >> 22. An exact 2x downscale in both axes switches to
``INTER_AREA``: the rounded mean of each 2 x 2 block.
"""

from __future__ import annotations

import numpy as np

_COEF_SCALE = 1 << 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _taps(dst: int, src: int, clamp_weight: bool):
    """Source index and (w0, w1) fixed-point weights of each output
    position along one axis. Columns (``clamp_weight``) drop to one tap at
    the borders; rows keep the weight and clamp the row index."""
    scale = 1.0 / (float(dst) / float(src))
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return s, w0.astype(np.int64), w1.astype(np.int64)


def _area_2x(img: np.ndarray) -> np.ndarray:
    a = img.astype(np.int32)
    total = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    return ((total + 2) >> 2).astype(np.uint8)


def _vertical(r0: np.ndarray, r1: np.ndarray, b0: np.ndarray,
              b1: np.ndarray) -> np.ndarray:
    """Rows r0, r1 (H, N) of horizontal sums weighted by b0, b1 (H, 1):
    16-bit high products of the sums shifted by 4, added with
    saturation, rounded by 2 bits."""
    def part(rows, b):
        return (np.clip(rows >> 4, -32768, 32767) * b) >> 16
    s = np.clip(part(r0, b0) + part(r1, b1), -32768, 32767)
    return np.clip((s + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``img`` (H, W) or (H, W, C) uint8 resized to ``size`` = (width,
    height), as ``cv2.resize(img, size)`` returns it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_linear takes (H, W[, C]) uint8, got "
                         f"{img.shape} {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (dh, dw) == (sh, sw):
        return img.copy()
    if sw == 2 * dw and sh == 2 * dh:
        return _area_2x(img)
    planar = img.reshape(sh, sw, -1).astype(np.int64)
    cn = planar.shape[2]
    xs, a0, a1 = _taps(dw, sw, clamp_weight=True)
    nxt = np.minimum(xs + 1, sw - 1)
    rows = planar[:, xs] * a0[None, :, None] + planar[:, nxt] * a1[None, :,
                                                                   None]
    rows = rows.reshape(sh, dw * cn)  # the horizontal pass, exact
    ys, b0, b1 = _taps(dh, sh, clamp_weight=False)
    r0 = rows[np.clip(ys, 0, sh - 1)]
    r1 = rows[np.clip(ys + 1, 0, sh - 1)]
    out = _vertical(r0, r1, b0[:, None], b1[:, None])
    return out.reshape((dh, dw) + img.shape[2:])


def resize_linear_float(img: np.ndarray, size) -> np.ndarray:
    """``img`` (H, W) float32 resized to ``size`` = (width, height) as
    ``cv2.resize(img, size)`` (``INTER_LINEAR``) returns it, to a few
    float32 ulps (module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError(f"resize_linear_float takes (H, W) float32, got "
                         f"{img.shape} {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape
    if (dh, dw) == (sh, sw):
        return img.copy()
    if sw == 2 * dw and sh == 2 * dh:  # INTER_AREA, as for uint8
        return ((img[0::2, 0::2] + img[0::2, 1::2]) + img[1::2, 0::2]
                + img[1::2, 1::2]) * np.float32(0.25)

    def taps(dst, src):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
        s = np.floor(f).astype(np.int64)
        f -= s
        clamped = (s < 0) | (s >= src - 1)
        f[clamped] = 0.0
        s = np.clip(s, 0, src - 1)
        return s, np.minimum(s + 1, src - 1), 1.0 - f, f

    x0, x1, a0, a1 = taps(dw, sw)
    y0, y1, b0, b1 = taps(dh, sh)
    rows = img.astype(np.float64)
    rows = rows[:, x0] * a0 + rows[:, x1] * a1
    out = rows[y0] * b0[:, None] + rows[y1] * b1[:, None]
    return out.astype(np.float32)
