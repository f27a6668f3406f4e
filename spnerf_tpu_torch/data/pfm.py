"""PFM reading as ``cv2.imread`` does it (OpenCV's ``grfmt_pfm.cpp``), on
numpy.

A PFM file is ``PF`` (colour, R, G, B) or ``Pf`` (gray), a line break,
then width, height and scale, each a token ended by one whitespace byte
and parsed by the C library (``atoi``, ``atof``: a token of up to 2,048
bytes; a byte past 127 in one is an error), then float32 rows from the
bottom up, big-endian where the scale is positive or zero and
little-endian where it is negative. OpenCV multiplies the samples by the
float32 of ``1 / |scale|`` (a zero or NaN scale is refused) and
converts them to 8 bits with no x255 scaling: rounded half to even,
clamped to 0-255, NaN, infinities and values past the int32 range to 0
(``cv_codec.to_u8``).

The decoder keeps the file's channels: a gray read of a colour file, or
a colour read of a gray one, makes OpenCV's ``convertTo`` reallocate the
image, which ``loadsave.cpp`` refuses (``original_ptr ==
real_mat.data``), so ``cv2.imread`` returns None and the port raises
``signature.Unreadable``, as it does for a cut file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.data import cv_codec

_TOKEN = 2048  # read_number's buffer
_SPACE = b" \t\n\v\f\r"
# the C library's number parsing, which OpenCV's atoi / atof are (hex and
# "inf" included)
_libc = ctypes.CDLL(None)
_libc.strtod.restype = ctypes.c_double
_libc.strtod.argtypes = (ctypes.c_char_p, ctypes.c_void_p)
_libc.atoi.restype = ctypes.c_int
_libc.atoi.argtypes = (ctypes.c_char_p,)


def _token(data: bytes, pos: int, name: str):
    """(token, position after it): read_number's bytes up to the first
    whitespace, which it consumes, or 2,048 bytes."""
    end = pos
    while end - pos < _TOKEN:
        if end >= len(data):
            raise cv_codec.refuse("pfm", name, "the header is cut")
        c = data[end]
        if c >= 128:
            raise cv_codec.refuse("pfm", name, "a byte past 127 in the "
                                  "header")
        end += 1
        if c in _SPACE:
            return data[pos:end - 1], end
    return data[pos:end], end


def _decode(data: bytes, name: str, channels: int) -> np.ndarray:
    """(H, W, C) uint8 samples in the file's order (R, G, B)."""
    if len(data) < 3 or data[:2] not in (b"PF", b"Pf"):
        raise cv_codec.refuse("pfm", name, "not a PFM file")
    if data[2] != 0x0A:
        raise cv_codec.refuse("pfm", name, "no line break after the magic")
    width, pos = _token(data, 3, name)
    height, pos = _token(data, pos, name)
    scale, pos = _token(data, pos, name)
    width, height = _libc.atoi(width), _libc.atoi(height)
    scale = _libc.strtod(scale, None)
    file_channels = 3 if data[1] == 0x46 else 1
    cv_codec.check_size("pfm", name, width, height)
    n = width * height * file_channels
    if len(data) - pos < 4 * n:
        raise cv_codec.refuse("pfm", name, "the samples are cut")
    if not abs(scale) > 0:
        raise cv_codec.refuse("pfm", name, f"scale {scale}")
    if channels != file_channels:
        raise cv_codec.refuse("pfm", name, f"a {channels}-channel read of a "
                              f"{file_channels}-channel file")
    order = ">f4" if scale >= 0 else "<f4"
    samples = np.frombuffer(data, order, n, pos).astype(np.float32)
    samples = samples.reshape(height, width, file_channels)[::-1]
    with np.errstate(over="ignore", invalid="ignore"):
        factor = np.float32(1.0 / abs(scale))
        return cv_codec.to_u8(samples * factor)


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)`` of a ``Pf``
    file."""
    return _decode(data, name, 1)[..., 0]


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]`` of a
    ``PF`` file."""
    return np.ascontiguousarray(_decode(data, name, 3))
