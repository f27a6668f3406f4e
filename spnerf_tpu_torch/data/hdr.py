"""Radiance HDR reading as ``cv2.imread`` does it (OpenCV's
``grfmt_hdr.cpp`` over its ``rgbe.cpp``, Greg Ward's reader), with the
scanlines decoded in the port's own C++ (``native/hdr_rle.cpp``, built
by g++ at first use).

The header is read line by line as the C library's ``fgets`` into 128
bytes reads it (so a line past 127 bytes is two, and a line holds
what comes before a NUL byte): lines up to the first empty one, among
which one must be exactly ``FORMAT=32-bit_rle_rgbe`` (OpenCV refuses
``32-bit_rle_xyze``), then the size as ``sscanf(line, "-Y %d +X %d")``
reads it (top-down rows of W pixels; no other orientation). The pixels:
new-style run-length scanlines where the width is 8 to 32,767, else flat
R, G, B, E quadruples; from the first scanline that does not start with
2, 2 on, flat (old-style runs are read as pixels).

Each quadruple becomes float32 ``mantissa * 2 ** (E - 136)`` (0 where E
is 0), then 8 bits as ``convertTo(..., 255)``: x255 in float32, rounded
half to even, clamped to 0-255, values past the int32 range (and
infinities) to 0 (``hdr_bgr8`` in the same C++). A gray read converts those 8-bit B, G, R with
``cvtColor``'s 15-bit fixed point (``cv_codec.gray15``). A broken header
or scanline, or a cut file, raises ``signature.Unreadable``:
``cv2.imread`` returns None for it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.data import cv_codec
from spnerf_tpu_torch.utils import native

_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_LINE = 127  # fgets into char[128]
_libc = ctypes.CDLL(None)
_libc.sscanf.restype = ctypes.c_int  # variadic: its arguments as passed


def _fgets(data: bytes, pos: int):
    """(the C string fgets leaves, position after it), or None at the
    end of the file."""
    if pos >= len(data):
        return None
    end = data.find(b"\n", pos, pos + _LINE)
    end = pos + min(_LINE, len(data) - pos) if end < 0 else end + 1
    return data[pos:end].split(b"\0")[0], end


def _header(data: bytes, name: str):
    """(width, height, offset of the pixels)."""
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise cv_codec.refuse("hdr", name, "not a Radiance HDR file")
    line = _fgets(data, 0)
    has_format = False
    while line is not None and line[0] != b"\n":
        has_format |= line[0] == _FORMAT
        line = _fgets(data, line[1])
    if line is None:
        raise cv_codec.refuse("hdr", name, "the header is cut")
    if not has_format:
        raise cv_codec.refuse("hdr", name, "no FORMAT=32-bit_rle_rgbe line")
    line = _fgets(data, line[1])
    if line is None:
        raise cv_codec.refuse("hdr", name, "the header is cut")
    height, width = ctypes.c_int(0), ctypes.c_int(0)
    if _libc.sscanf(line[0], b"-Y %d +X %d", ctypes.byref(height),
                    ctypes.byref(width)) < 2:
        raise cv_codec.refuse("hdr", name, "no -Y H +X W size line")
    if width.value <= 0 or height.value <= 0:
        raise cv_codec.refuse("hdr", name, f"size {width.value} x "
                              f"{height.value}")
    return width.value, height.value, line[1]


def _decode(data: bytes, name: str) -> np.ndarray:
    """(H, W, 3) uint8 B, G, R."""
    width, height, pos = _header(data, name)
    cv_codec.check_size("hdr", name, width, height)
    lib = native.load("hdr_rle")
    lib.hdr_rgbe.restype = ctypes.c_int
    lib.hdr_rgbe.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.hdr_bgr8.restype = None
    lib.hdr_bgr8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p]
    rgbe = np.empty((height, width, 4), np.uint8)
    src = data[pos:]
    code = lib.hdr_rgbe(src, len(src), width, height, rgbe.ctypes.data)
    if code:
        raise cv_codec.refuse("hdr", name, "a bad scanline" if code == 1
                              else "the pixels are cut")
    bgr = np.empty((height, width, 3), np.uint8)
    lib.hdr_bgr8(rgbe.ctypes.data, width * height, bgr.ctypes.data)
    return bgr


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)``."""
    return cv_codec.gray15(_decode(data, name))


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return np.ascontiguousarray(_decode(data, name)[..., ::-1])
