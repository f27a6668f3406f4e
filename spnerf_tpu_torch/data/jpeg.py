"""Gray JPEG reading as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does it
(libjpeg-turbo asked for ``JCS_GRAYSCALE``), byte for byte, without cv2.

The decoder is the port's own C++ (``native/jpeg_gray.cpp``, built by g++
at first use): baseline and extended-sequential Huffman files of 8-bit
samples, 1 or 3 components at any sampling where luma is at full
resolution, with restart markers. It returns the luma plane through
libjpeg's integer inverse DCT, which is what libjpeg hands back for a
YCbCr file read as gray (chroma is entropy-decoded and dropped). The
EXIF orientation of the first APP1 segment is then applied as OpenCV's
``ExifTransform`` does. Progressive, arithmetic-coded, lossless,
12-bit, CMYK/YCCK and RGB-coded files raise (ROADMAP Queue 1 item 7),
as do broken ones (a truncated file, a missing restart marker), which
libjpeg would pad with gray and warn about.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from spnerf_tpu_torch.utils import native

SUFFIXES = (".jpg", ".jpeg")
UNSUPPORTED = "ROADMAP Queue 1 item 7, colour and progressive JPEG"


def _lib():
    lib = native.load("jpeg_gray")
    lib.jpeg_gray_header.restype = ctypes.c_int
    lib.jpeg_gray_header.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_gray_decode.restype = ctypes.c_int
    lib.jpeg_gray_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int]
    return lib


def _segments(data: bytes):
    """(marker, body) of the segments before the first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        yield marker, data[pos + 4:pos + 2 + length]
        if marker == 0xDA:
            return
        pos += 2 + length


def exif_orientation(data: bytes) -> int:
    """The orientation tag (1-8) of IFD0 in the file's first APP1 segment
    if that segment is EXIF, else 1."""
    for marker, body in _segments(data):
        if marker != 0xE1:
            continue
        if not body.startswith(b"Exif\0\0") or len(body) < 14:
            return 1
        tiff = body[6:]
        order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if order is None:
            return 1
        try:
            ifd = struct.unpack(order + "I", tiff[4:8])[0]
            count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
            for i in range(count):
                entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
                tag, kind = struct.unpack(order + "HH", entry[:4])
                if tag == 0x0112 and kind == 3:
                    value = struct.unpack(order + "H", entry[8:10])[0]
                    return value if 1 <= value <= 8 else 1
        except struct.error:
            return 1
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: flips and transposes by the EXIF
    orientation."""
    if orientation in (5, 6, 7, 8):
        img = img.T
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _fail(name: str, err) -> None:
    msg = err.value.decode()
    if "not decoded" in msg:  # a kind of file, not a broken one
        msg += f" ({UNSUPPORTED})"
    raise ValueError(f"jpeg: {name}: {msg}")


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 gray image of a JPEG file's bytes, EXIF orientation
    applied."""
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_gray_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                            err, len(err)):
        _fail(name, err)
    out = np.empty((h.value, w.value), np.uint8)
    if lib.jpeg_gray_decode(data, len(data), out.ctypes.data, err, len(err)):
        _fail(name, err)
    return apply_orientation(out, exif_orientation(data))


def read_gray(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` of a JPEG file."""
    return decode_gray(Path(path).read_bytes(), str(path))
