"""OpenCV's image filters that the synthetic shapes and the host
photometric augmentation call, in numpy (no cv2 on the card's machine).

Every filter reads past the border by ``BORDER_REFLECT_101``, reflected
again and again where the kernel is wider than the image.

- ``blur_u8`` is ``cv2.blur`` on uint8, byte for byte: the window of an
  even ``k`` spans [x - k/2, x + k/2 - 1], the sums are exact, and the
  division follows OpenCV's paths: for k^2 <= 256 the 16-bit path, whose
  fixed-point divisor gives (s + k^2/2 + 1) >> log2(k^2) at a power of two
  and s / k^2 rounded half up otherwise; above, the float path, s times
  float32(1 / k^2) in float32 rounded half to even, except the columns
  after the last whole group of 8, which the scalar tail computes in
  float64.
- ``gaussian_blur_u8`` is ``cv2.GaussianBlur(img, (k, k), 0)`` on uint8,
  byte for byte: OpenCV's fixed-point path, 8-bit taps from its bit-exact
  kernel by error diffusion (the centre tap takes the remainder), the row
  pass exact, the column pass exact, then (sum + 2^15) >> 16.
- ``gaussian_blur_f32`` and ``filter2d_f32`` (float32 images) sum in
  float64 with OpenCV's float32 taps; OpenCV sums in float32 in its own
  order, so they agree within about 1e-4 on the 0-255 scale
  (``tests/test_torch_cv_filter.py`` pins the bounds).

The window sums of the 8-bit filters and both passes of
``gaussian_blur_f32`` run in C++ (``native/cv_filter.cpp``, built by g++
at first use): in numpy the 8-bit ones took 30-110 ms a call at
960 x 1280, and the float32 one, with the photometric shade's 101-151
taps, four times as long as in C++ (whose sums are the same, in the same
order).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from spnerf_tpu_torch.utils import native

# getGaussianKernelBitExact's fixed kernels for sigma <= 0
_SMALL_KERNELS = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875,
        0.1171875, 0.05078125, 0.015625),
}


def reflect101_index(n: int, idx: np.ndarray) -> np.ndarray:
    """Indices into [0, n) of ``idx`` by repeated ``BORDER_REFLECT_101``."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _padded(img: np.ndarray, before: int, after: int, axis: int):
    n = img.shape[axis]
    idx = reflect101_index(n, np.arange(-before, n + after))
    return np.take(img, idx, axis=axis)


def _check(img: np.ndarray, dtype, name: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != dtype or img.ndim != 2:
        raise ValueError(f"{name} takes an (H, W) {np.dtype(dtype)} image, "
                         f"got {img.shape} {img.dtype}")
    return img


def _native():
    lib = native.load("cv_filter")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.box_sums_u8.argtypes = [ptr, i64, i64, i64, ptr]
    lib.gaussian_u8.argtypes = [ptr, i64, i64, ptr, i64, ptr]
    lib.gaussian_f32.argtypes = [ptr, i64, i64, ptr, i64, ptr]
    lib.box_sums_u8.restype = lib.gaussian_u8.restype = None
    lib.gaussian_f32.restype = None
    return lib


def _box_sums(img: np.ndarray, k: int) -> np.ndarray:
    """Exact int64 sums of every k x k window of an (H, W) uint8 image,
    anchored at k // 2 (``native/cv_filter.cpp``)."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.int64)
    _native().box_sums_u8(img.ctypes.data, img.shape[0], img.shape[1], k,
                          out.ctypes.data)
    return out


def blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of an (H, W) uint8 image."""
    img = _check(img, np.uint8, "blur_u8")
    k = int(k)
    if k < 1:
        raise ValueError(f"blur_u8: kernel size {k}")
    if k == 1:
        return img.copy()
    s = _box_sums(img, k)
    d = k * k
    if d <= 256:
        if d & (d - 1) == 0:
            out = (s + d // 2 + 1) >> (d.bit_length() - 1)
        else:
            out = (s + d // 2) // d
    else:
        out = np.rint(s.astype(np.float32) * np.float32(1.0 / d))
        tail = s.shape[1] // 8 * 8
        out[:, tail:] = np.rint(s[:, tail:] * (1.0 / d))
    return np.clip(out, 0, 255).astype(np.uint8)


def gaussian_kernel(k: int) -> np.ndarray:
    """``getGaussianKernelBitExact(k, sigma=0)`` in float64 (sigma =
    0.15 k + 0.35): the odd kernel OpenCV rounds its taps from."""
    if k in _SMALL_KERNELS:
        return np.array(_SMALL_KERNELS[k])
    if k < 1 or k % 2 == 0:
        raise ValueError(f"gaussian_kernel: size {k} is not odd")
    sigma = k * 0.15 + 0.35
    scale = -0.125 / (sigma * sigma)
    half = [math.exp((x * x) * scale) for x in range(1 - k, 0, 2)]
    mul = 1.0 / (sum(half) * 2.0 + 1.0)
    side = [v * mul for v in half]
    return np.array(side + [mul] + side[::-1])


def gaussian_taps_u8(k: int) -> np.ndarray:
    """OpenCV's 8-bit fixed-point taps of a k-tap Gaussian (sum 256):
    ``getGaussianKernelFixedPoint_ED``."""
    kernel = gaussian_kernel(k)
    taps = np.zeros(k, np.int64)
    err, total = 0.0, 0
    for i in range(k // 2):
        adjusted = kernel[i] * 256.0 + err
        v = round(adjusted)
        err = adjusted - v
        taps[i] = taps[k - 1 - i] = v
        total += v
    taps[k // 2] = 256 - 2 * total
    return taps


def gaussian_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of an (H, W) uint8 image (the
    integer passes in ``native/cv_filter.cpp``)."""
    img = np.ascontiguousarray(_check(img, np.uint8, "gaussian_blur_u8"))
    taps = np.ascontiguousarray(gaussian_taps_u8(int(k)), np.int32)
    out = np.empty_like(img)
    _native().gaussian_u8(img.ctypes.data, img.shape[0], img.shape[1],
                          taps.ctypes.data, len(taps), out.ctypes.data)
    return out


def gaussian_blur_f32(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of an (H, W) float32 image,
    within the bound of the module docstring (both passes in
    ``native/cv_filter.cpp``)."""
    img = np.ascontiguousarray(_check(img, np.float32, "gaussian_blur_f32"))
    taps = gaussian_kernel(int(k)).astype(np.float32).astype(np.float64)
    out = np.empty_like(img)
    _native().gaussian_f32(img.ctypes.data, img.shape[0], img.shape[1],
                           taps.ctypes.data, len(taps), out.ctypes.data)
    return out


def filter2d_f32(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` (a correlation, anchor at the
    centre) of an (H, W) float32 image by a float32 kernel, within the
    bound of the module docstring."""
    img = _check(img, np.float32, "filter2d_f32")
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    H, W = img.shape
    p = _padded(_padded(img.astype(np.float64), kw // 2, kw - 1 - kw // 2, 1),
                kh // 2, kh - 1 - kh // 2, 0)
    out = np.zeros((H, W))
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                out += p[i:i + H, j:j + W] * float(kernel[i, j])
    return out.astype(np.float32)
