"""``cv2.warpPerspective`` of an 8-bit gray image, bilinear, constant-0
border, without cv2.

OpenCV inverts the 3 x 3 map in float64 (``invert``'s closed form for
3 x 3: the adjugate times 1 / det), rounds it to float32 and warps each
destination pixel through it (``warp_kernels.simd.hpp`` since OpenCV
4.11). The arithmetic of that warp, copied in ``native/cv_warp.cpp``
(built at first use), was read off cv2 5.0 on x86 with AVX2: fused
multiply-adds in the vector body, the scalar tail's own order, the blend
rounded half to even.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.utils import native


def invert3(m) -> np.ndarray:
    """``cv2.invert`` of a 3 x 3 float64 matrix (``DECOMP_LU``): the
    adjugate scaled by the reciprocal of the determinant, in OpenCV's
    order of operations."""
    s = np.asarray(m, np.float64).reshape(3, 3).tolist()
    det = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
           - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
           + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if det == 0.0:
        raise ValueError("warp_perspective_u8: singular homography")
    d = 1.0 / det
    t = [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
         (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
         (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
         (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
         (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
         (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
         (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
         (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
         (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]
    return np.array(t, np.float64).reshape(3, 3)


def warp_perspective_u8(image: np.ndarray, H, dsize) -> np.ndarray:
    """``cv2.warpPerspective(image, H, dsize, flags=cv2.INTER_LINEAR)``
    (border constant 0) of an (h, w) uint8 image; ``dsize`` is (width,
    height) as cv2 takes it."""
    image = np.ascontiguousarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"warp_perspective_u8 takes (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    width, height = (int(v) for v in dsize)
    minv = np.ascontiguousarray(invert3(H).ravel())
    out = np.empty((height, width), np.uint8)
    lib = native.load("cv_warp")
    fn = lib.cv_warp_perspective_u8
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p]
    fn(image.ctypes.data, image.shape[0], image.shape[1], out.ctypes.data,
       height, width, minv.ctypes.data)
    return out
