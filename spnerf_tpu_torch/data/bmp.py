"""BMP reading as ``cv2.imread`` does it (OpenCV's ``grfmt_bmp.cpp``), on
numpy, with the run-length encodings in the port's own C++
(``native/bmp_rle.cpp``, built by g++ at first use).

The header as OpenCV reads it: the pixel offset at byte 10; an info
header of 12 bytes (OS/2: 16-bit width and height, always bottom-up, a
palette of 3-byte entries) or of 36 bytes or more (Windows: 40, 52, 56,
108 or 124, all read as the first 40, the rest skipped; a negative
height is a top-down file); any other size is refused. The palette (2 **
bits entries, or the header's colours-used count, at most 256) follows
the info header, whatever the offset says; the pixels start at the
offset.

- 1, 4 and 8 bits: palette indices, rows padded to 4 bytes; a gray read
  looks them up in the palette's gray (the fixed-point colour-to-gray
  step of each entry);
- 16 bits: 5-5-5 by default (each sample's 5 bits shifted up by 3, not
  replicated), 5-6-5 only where ``BI_BITFIELDS`` masks 0xF800, 0x7E0,
  0x1F follow the info header (OpenCV reads the three masks after the
  whole header, so a V4 or V5 header's own masks are not the ones read);
  other masks are refused;
- 24 bits: B, G, R; 32 bits (``BI_RGB`` or ``BI_BITFIELDS``, the masks
  unread): B, G, R and a fourth byte, dropped;
- ``BI_RLE8`` and ``BI_RLE4``: runs, literal runs and the escapes (end
  of line, end of bitmap, delta), the pixels an escape skips filled with
  palette entry 0; a run past its row is refused, as OpenCV gives up.

A file cut short, a bad header or compression, or pixels past the end
raise ``signature.Unreadable``: ``cv2.imread`` returns None for them.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from spnerf_tpu_torch.data import cv_codec
from spnerf_tpu_torch.utils import native

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _header(data: bytes, name: str) -> dict:
    def dword(pos):
        if pos + 4 > len(data):
            raise cv_codec.refuse("bmp", name, "the header is cut")
        return struct.unpack_from("<i", data, pos)[0]

    if data[:2] != b"BM":
        raise cv_codec.refuse("bmp", name, "not a BMP file")
    offset, size = dword(10), dword(14)
    palette = np.zeros((256, 4), np.uint8)  # B, G, R, reserved
    header_masks = None
    if size >= 36:
        width, height = dword(18), dword(22)
        bits, rle, colours = dword(26) >> 16, dword(30), dword(46)
        if not 0 <= rle <= _BITFIELDS:
            raise cv_codec.refuse("bmp", name, f"compression {rle}")
        pos = 14 + size
        ok = width > 0 and height != 0 and (
            (bits in (1, 4, 8, 24, 32) and rle == _RGB)
            or (bits in (16, 32) and rle in (_RGB, _BITFIELDS))
            or (bits == 4 and rle == _RLE4) or (bits == 8 and rle == _RLE8))
        if ok and bits <= 8:
            if not 0 <= colours <= 256:
                raise cv_codec.refuse("bmp", name, f"{colours} colours")
            n = colours or 1 << bits
            if pos + 4 * n > len(data):
                raise cv_codec.refuse("bmp", name, "the palette is cut")
            palette.reshape(-1)[:4 * n] = np.frombuffer(data, np.uint8,
                                                        4 * n, pos)
        elif ok and bits == 16 and rle == _BITFIELDS:
            red, green, blue = dword(pos), dword(pos + 4), dword(pos + 8)
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bits = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                ok = False
        elif ok and bits == 16:
            bits = 15
        elif ok and bits == 32 and rle == _BITFIELDS and size >= 56:
            masks = [dword(54 + 4 * i) & 0xFFFFFFFF for i in range(4)]
            if all(masks[:3]):
                header_masks = masks[:3]
    elif size == 12:
        if 26 > len(data):
            raise cv_codec.refuse("bmp", name, "the header is cut")
        width, height, planes_bits = struct.unpack_from("<HHi", data, 18)
        bits, rle = planes_bits >> 16, _RGB
        ok = width > 0 and height != 0 and bits in (1, 4, 8, 24, 32)
        if ok and bits <= 8:
            n = 1 << bits
            if 26 + 3 * n > len(data):
                raise cv_codec.refuse("bmp", name, "the palette is cut")
            palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, 26) \
                .reshape(n, 3)
    else:
        if size <= 0:
            raise cv_codec.refuse("bmp", name, f"info header of {size} "
                                  "bytes")
        ok = False
    if not ok:
        raise cv_codec.refuse("bmp", name, "a kind of BMP OpenCV refuses")
    return {"width": width, "height": abs(height), "bottom_up": height > 0,
            "bits": bits, "rle": rle, "offset": offset, "palette": palette,
            "masks": header_masks}


def _rle(data: bytes, name: str, h: dict, gray_palette: np.ndarray,
         nch: int) -> np.ndarray:
    fn = native.load("bmp_rle").bmp_rle
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    out = np.empty((h["height"], h["width"] * nch), np.uint8)
    src = data[h["offset"]:]
    code = fn(src, len(src), 8 if h["rle"] == _RLE8 else 4, h["width"],
              h["height"], int(h["bottom_up"]), h["palette"].ctypes.data,
              gray_palette.ctypes.data, nch, out.ctypes.data)
    if code:
        raise cv_codec.refuse("bmp", name, "a run past its row" if code == 1
                              else "the runs are cut")
    return out.reshape(h["height"], h["width"], nch)


def _decode(data: bytes, name: str, colour: bool) -> np.ndarray:
    """(H, W, 3) uint8 B, G, R for a colour read, (H, W) for a gray one."""
    h = _header(data, name)
    width, height, bits = h["width"], h["height"], h["bits"]
    cv_codec.check_size("bmp", name, width, height)
    nch = 3 if colour else 1
    if height * width * nch >= 1 << 30:
        raise cv_codec.refuse("bmp", name, "too large for OpenCV's reader")
    if h["offset"] < 0:
        raise cv_codec.refuse("bmp", name, f"pixel offset {h['offset']}")
    palette = h["palette"]
    gray_palette = np.zeros(256, np.uint8)
    if bits <= 8:
        gray_palette[:1 << bits] = cv_codec.gray(palette[:1 << bits, :3])
    if h["rle"] in (_RLE8, _RLE4):
        out = _rle(data, name, h, gray_palette, nch)
        return out if colour else out[..., 0]
    pitch = ((width * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
    if h["offset"] + pitch * height > len(data):
        raise cv_codec.refuse("bmp", name, "the pixels are cut")
    rows = np.frombuffer(data, np.uint8, pitch * height, h["offset"]) \
        .reshape(height, pitch)
    if h["bottom_up"]:
        rows = rows[::-1]
    if bits <= 8:
        if bits == 8:
            index = rows
        elif bits == 4:
            index = np.stack([rows >> 4, rows & 15], -1).reshape(height, -1)
        else:
            index = np.unpackbits(rows, axis=1)
        index = index[:, :width]
        return (cv_codec.lookup(palette[:, :3], index) if colour
                else np.take(gray_palette, index))
    if bits in (15, 16):
        v = rows[:, :2 * width].view("<u2").astype(np.int32)
        if bits == 15:
            bgr = np.stack([(v << 3) & 0xF8, (v >> 2) & 0xF8,
                            (v >> 7) & 0xF8], -1)
        else:
            bgr = np.stack([(v << 3) & 0xF8, (v >> 3) & 0xFC,
                            (v >> 8) & 0xF8], -1)
        bgr = bgr.astype(np.uint8)
    elif h["masks"] is not None:
        return _masked(rows[:, :4 * width].view("<u4"), h["masks"], colour)
    else:
        step = bits // 8
        bgr = rows[:, :step * width].reshape(height, width, step)[..., :3]
    return bgr.copy() if colour else cv_codec.gray(bgr)


def _masked(v: np.ndarray, masks: list, colour: bool) -> np.ndarray:
    """32-bit pixels through a header's R, G, B masks: each field scaled
    to 0-255 in float32 and truncated, gray in float32 from those bytes."""
    f32 = np.float32
    rgb = []
    for mask in masks:
        shift = (mask & -mask).bit_length() - 1
        field = ((v & np.uint32(mask)) >> np.uint32(shift)).astype(f32)
        rgb.append((field * (f32(255) / f32(mask >> shift))).astype(np.uint8))
    red, green, blue = rgb
    if colour:
        return np.stack([blue, green, red], -1)
    return ((f32(0.299) * red.astype(f32) + f32(0.587) * green.astype(f32))
            + f32(0.114) * blue.astype(f32)).astype(np.uint8)


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)``."""
    return np.ascontiguousarray(_decode(data, name, False))


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return np.ascontiguousarray(_decode(data, name, True)[..., ::-1])
