"""JPEG reading as ``cv2.imread`` does it, gray (``IMREAD_GRAYSCALE``) or
colour (``IMREAD_COLOR``), byte for byte, without cv2.

The decoder is the port's own C++ (``native/jpeg.cpp``, built by g++ at
first use), a copy of what libjpeg-turbo 3.1 does when cv2 asks it for
``JCS_GRAYSCALE``, BGR or ``JCS_CMYK``: baseline, extended-sequential and
progressive files of 8-bit samples, Huffman- or arithmetic-coded (with
DAC conditioning), gray, YCbCr, RGB-coded (Adobe transform 0, or ids 'R'
'G' 'B'), CMYK and YCCK, any integral chroma sampling, restart markers;
lossless files (any integral sampling, upsampled by replication) where
libjpeg-turbo needs no colour conversion; libjpeg's integer inverse DCT, its "fancy"
chroma upsampling and its fixed-point colour conversion, then OpenCV's
own CMYK formulas. The EXIF orientation of the first APP1 segment is
applied as OpenCV's ``ExifTransform`` does. Damaged files read as
libjpeg reads them: cut inside their scans (padded as libjpeg pads
them), block-smoothed where progressive coefficients were not all sent,
restart markers resynced, stray bytes skipped, with libjpeg's first
warning on stderr. What cv2 returns None for (12- and 16-bit samples,
hierarchical and lossless arithmetic frames, 2 components, a lossless
read that needs a colour conversion, fractional sampling where a
component must be upsampled, a file cut inside its header, and every
error libjpeg stops at: bad tables, headers and lengths) raises
``signature.Unreadable``.

Writing: ``encode_gray`` / ``write_gray`` make the bytes of
``cv2.imencode('.jpg', img)`` / ``cv2.imwrite`` for an 8-bit gray image
at cv2's defaults (quality 95, baseline, standard Huffman tables), by the
port's own encoder (``native/jpeg_enc.cpp``), a copy of libjpeg-turbo's.
"""

from __future__ import annotations

import ctypes
import struct
import sys
from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data.signature import Unreadable
from spnerf_tpu_torch.utils import native

# the C decoder's prefix of the kinds of file cv2 refuses too
_REFUSED = "cv2 refuses: "


def _lib():
    lib = native.load("jpeg")
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
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
    """OpenCV's ``ExifTransform``: flips and transposes of the first two
    axes by the EXIF orientation."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _fail(name: str, err) -> None:
    msg = err.value.decode()
    if msg.startswith(_REFUSED):
        raise Unreadable(f"jpeg: {name}: {msg[len(_REFUSED):]}: cv2.imread "
                         "does not read it either")
    # the decoder stops where libjpeg stops with an error
    raise Unreadable(f"jpeg: {name}: {msg}; cv2.imread returns None for "
                     "it too")


def decode(data: bytes, channels: int, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes as cv2 decodes them, EXIF orientation applied:
    (H, W) uint8 for ``channels`` 1 (``IMREAD_GRAYSCALE``), (H, W, 3) B, G,
    R for 3 (``IMREAD_COLOR``). A file libjpeg warns of (cut inside its
    scans, stray bytes, a restart marker out of place) decodes with
    libjpeg's first warning on stderr, as libjpeg shows only that one."""
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                       err, len(err)):
        _fail(name, err)
    out = np.empty((h.value, w.value) + ((3,) if channels == 3 else ()),
                   np.uint8)
    warning = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, channels, warning,
                       len(warning), err, len(err)):
        _fail(name, err)
    if warning.value:
        print(f"jpeg: {name}: {warning.value.decode()}", file=sys.stderr)
    return apply_orientation(out, exif_orientation(data))


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, cv2.IMREAD_GRAYSCALE)``."""
    return decode(data, 1, name)


def decode_bgr(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 B, G, R: ``cv2.imdecode(data, cv2.IMREAD_COLOR)``."""
    return decode(data, 3, name)


def read_gray(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` of a JPEG file."""
    return decode_gray(Path(path).read_bytes(), str(path))


def read_rgb(path) -> np.ndarray:
    """``cv2.imread(path)[..., ::-1]`` of a JPEG file: (H, W, 3) R, G, B."""
    return np.ascontiguousarray(
        decode_bgr(Path(path).read_bytes(), str(path))[..., ::-1])


def encode_gray(image: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of ``cv2.imencode('.jpg', image, [IMWRITE_JPEG_QUALITY,
    quality])`` of an (H, W) uint8 image."""
    image = np.ascontiguousarray(image)
    if image.ndim != 2 or image.dtype != np.uint8 or image.size == 0:
        raise ValueError(f"jpeg: encode_gray takes (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    if max(image.shape) > 65535:
        raise ValueError(f"jpeg: {image.shape} is past JPEG's 65535 limit")
    lib = native.load("jpeg_enc")
    fn = lib.jpeg_encode_gray
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
    cap = 2 * image.size + 4096  # past any 8-bit gray file's size
    out = np.empty(cap, np.uint8)
    n = fn(image.ctypes.data, image.shape[0], image.shape[1], int(quality),
           out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("jpeg: encode_gray overflowed its buffer")
    return out[:n].tobytes()


def write_gray(path, image: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, image)`` of an (H, W) uint8 image to a ``.jpg``
    path: the same bytes."""
    Path(path).write_bytes(encode_gray(image, quality))
