"""8-bit PNG reading and writing on ``zlib`` and numpy (no cv2).

``read_gray`` decodes non-interlaced 8-bit gray, gray + alpha, RGB and
RGBA images with any of the five row filters and returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns: alpha is dropped
and colour goes to gray as libpng's ``png_set_rgb_to_gray(0.299,
0.587)`` computes it, (9797 R + 19234 G + 3737 B) >> 15 (truncated), a
gray pixel keeping its value. Anything else (other bit depths, palettes,
interlacing, a broken stream) raises. ``write_gray`` writes an 8-bit gray
image, every row with filter 0, as the counterpart of ``cv2.imwrite``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel
_RGB_TO_GRAY = (9797, 19234, 3737)  # libpng's fixed-point 0.299, 0.587


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("png: truncated chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"png: bad CRC in {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("png: no IEND chunk")


def _paeth_or_average_row(filt: int, row: bytearray, prior: bytes,
                          bpp: int) -> None:
    """Undo filter 3 (Average) or 4 (Paeth) in place: each byte depends on
    the reconstructed byte ``bpp`` to its left."""
    for i in range(len(row)):
        left = row[i - bpp] if i >= bpp else 0
        up = prior[i]
        if filt == 3:
            row[i] = (row[i] + ((left + up) >> 1)) & 0xFF
            continue
        up_left = prior[i - bpp] if i >= bpp else 0
        p = left + up - up_left
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc else up_left)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) != height * (stride + 1):
        raise ValueError(f"png: {len(raw)} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        filt, cur = int(rows[y, 0]), rows[y, 1:]
        if filt == 0:
            out[y] = cur
        elif filt == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif filt == 2:  # Up
            out[y] = cur + prior
        elif filt in (3, 4):
            row = bytearray(cur.tobytes())
            _paeth_or_average_row(filt, row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"png: unknown filter type {filt} in row {y}")
        prior = out[y]
    return out


def read_gray(path) -> np.ndarray:
    """(H, W) uint8 gray image of an 8-bit PNG file."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"png: {path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError(f"png: {path}: palette images are not supported")
    if header is None or not idat:
        raise ValueError(f"png: {path}: no IHDR or IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"png: {path}: bit depth {depth}, colour type "
                         f"{colour}; only 8-bit gray, gray + alpha, RGB and "
                         "RGBA are supported")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"png: {path}: compression {compression}, filter "
                         f"method {filtering}, interlace {interlace}; only "
                         "0, 0, 0 are supported")
    bpp = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                       bpp).reshape(height, width, bpp)
    if bpp <= 2:
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    gray = (rgb[..., 0] * _RGB_TO_GRAY[0] + rgb[..., 1] * _RGB_TO_GRAY[1]
            + rgb[..., 2] * _RGB_TO_GRAY[2]) >> 15
    return gray.astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_gray(path, image: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit gray PNG (filter 0)."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"png: write_gray takes (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    height, width = image.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8), image], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))
