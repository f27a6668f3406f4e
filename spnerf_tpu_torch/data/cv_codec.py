"""What OpenCV's own image decoders share, for the port's copies of them
(``data/pnm.py``, ``bmp.py``, ``sunras.py``, ``pam.py``, ``pfm.py``,
``hdr.py``, ``gif.py``):

- ``refuse``: the ``signature.Unreadable`` of a file ``cv2.imread``
  returns None for (or raises on);
- ``check_size``: ``validateInputImageSize`` of ``loadsave.cpp``, which
  ``cv2.imread`` applies to every header (width and height 1 to 2**20,
  at most 2**30 pixels), raising where cv2 raises;
- ``gray``: the colour-to-gray step of ``utils.cpp``
  (``icvCvt_BGR2Gray_8u_C3C1R``), 14-bit fixed point with rounding:
  (4899 R + 9617 G + 1868 B + 8192) >> 14; ``gray15`` that of
  ``cvtColor``'s 8-bit ``BGR2GRAY``, 15-bit:
  (9798 R + 19235 G + 3735 B + 16384) >> 15;
- ``to_u8``: ``saturate_cast<uchar>`` of a float32 array as OpenCV's SIMD
  conversions do it (round half to even; NaN, infinities and values out
  of int32 range give 0, as x86's conversion gives INT_MIN for them);
- ``lookup``: colour-table entries by index (palette images), as one
  4-byte gather.
"""

from __future__ import annotations

import numpy as np

from spnerf_tpu_torch.data.signature import Unreadable

MAX_SIDE = 1 << 20  # CV_IO_MAX_IMAGE_WIDTH, CV_IO_MAX_IMAGE_HEIGHT
MAX_PIXELS = 1 << 30  # CV_IO_MAX_IMAGE_PIXELS
RGB_TO_GRAY = (4899, 9617, 1868)  # OpenCV's cR, cG, cB at SCALE 14
RGB_TO_GRAY15 = (9798, 19235, 3735)  # cvtColor's RY15, GY15, BY15


def refuse(fmt: str, name: str, why: str) -> Unreadable:
    return Unreadable(f"{fmt}: {name}: {why}; cv2.imread does not read it "
                      "either")


def check_size(fmt: str, name: str, width: int, height: int) -> None:
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE
            and width * height <= MAX_PIXELS):
        raise refuse(fmt, name, f"{width} x {height} pixels, outside "
                     "cv2's limits")


def gray(bgr: np.ndarray, coefficients=RGB_TO_GRAY,
         shift: int = 14) -> np.ndarray:
    """(..., 3) uint8 B, G, R to (...) uint8 gray, OpenCV's fixed point."""
    v = bgr.astype(np.int32)
    cr, cg, cb = coefficients
    return ((v[..., 0] * cb + v[..., 1] * cg + v[..., 2] * cr
             + (1 << (shift - 1))) >> shift).astype(np.uint8)


def gray15(bgr: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 B, G, R to gray as ``cvtColor(COLOR_BGR2GRAY)``."""
    return gray(bgr, RGB_TO_GRAY15, 15)


def to_u8(x: np.ndarray) -> np.ndarray:
    """float32 to uint8 as ``saturate_cast<uchar>`` (``cvRound``)."""
    r = np.rint(np.asarray(x, np.float32))
    with np.errstate(invalid="ignore"):
        inside = (r >= np.float32(-2.0**31)) & (r < np.float32(2.0**31))
    return np.where(inside, np.clip(r, 0, 255), 0).astype(np.uint8)


def lookup(table: np.ndarray, index: np.ndarray) -> np.ndarray:
    """(N, 3) uint8 entries at ``index`` (values below N): (..., 3)."""
    wide = np.zeros((len(table), 4), np.uint8)
    wide[:, :3] = table
    return np.take(wide.view(np.uint32)[:, 0], index).view(np.uint8) \
        .reshape(index.shape + (4,))[..., :3]
