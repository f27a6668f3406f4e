"""Sun raster reading as ``cv2.imread`` does it (OpenCV's
``grfmt_sunras.cpp``), on numpy.

The 32-byte big-endian header: magic, width, height, depth, length
(unread), type, colour-map type, colour-map length. OpenCV 5.0 reads the
old (0) and standard (1) types at depths 1, 8, 24 and 32. Its check for
the byte-encoded (2) and RGB (3) types compares them with the decoder's
image type instead of the file's type, which never matches, so cv2
returns None for those files and the port raises
``signature.Unreadable``, as for any other type or depth, a cut file or
a bad colour map.

- A colour map (type 1, up to 3 x 2**depth bytes at depths 1 and 8)
  holds its R, G and B planes of length // 3 entries each; entries past
  them are black. A colour read looks the pixels up in it; a gray read
  looks them up in its gray (the fixed-point colour-to-gray step).
- With no map, a colour read looks pixels up in a gray ramp (1 bit: 0
  and 255; 8 bits: the byte itself), and a gray read in a table of
  zeros: cv2 gives an all-black image, and so does the port.
- 24 bits: B, G, R bytes; 32 bits: a pad byte, then B, G, R.
- Rows are padded to a whole number of 16-bit words.
"""

from __future__ import annotations

import struct

import numpy as np

from spnerf_tpu_torch.data import cv_codec

MAGIC = b"\x59\xa6\x6a\x95"


def _decode(data: bytes, name: str, colour: bool) -> np.ndarray:
    """(H, W, 3) uint8 B, G, R for a colour read, (H, W) for a gray one."""
    if len(data) < 32 or data[:4] != MAGIC:
        raise cv_codec.refuse("sunras", name, "no Sun raster header")
    (width, height, depth, _, kind, map_type,
     map_length) = struct.unpack(">iiiIiii", data[4:32])
    pal_size = 3 << depth if 0 < depth <= 8 else 0
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32)
            and kind in (0, 1)
            and ((map_type == 0 and map_length == 0)
                 or (map_type == 1 and 0 < map_length <= pal_size))):
        raise cv_codec.refuse("sunras", name, f"type {kind}, depth {depth}, "
                              f"colour map {map_type} of {map_length} bytes")
    if len(data) < 32 + map_length:
        raise cv_codec.refuse("sunras", name, "the colour map is cut")
    cv_codec.check_size("sunras", name, width, height)
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    pos = 32 + map_length
    if len(data) - pos < pitch * height:
        raise cv_codec.refuse("sunras", name, "the pixels are cut")
    rows = np.frombuffer(data, np.uint8, pitch * height, pos) \
        .reshape(height, pitch)
    if depth == 24:
        bgr = rows[:, :width * 3].reshape(height, width, 3)
    elif depth == 32:
        bgr = rows[:, :width * 4].reshape(height, width, 4)[..., 1:]
    else:
        if depth == 1:
            index = np.unpackbits(rows, axis=1)[:, :width]
        else:
            index = rows[:, :width]
        palette = np.zeros((1 << depth, 3), np.uint8)  # B, G, R
        if map_type == 1:
            n = map_length // 3
            planes = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
            palette[:n] = planes[::-1].T
        elif colour:
            palette[:] = (np.arange(1 << depth) * 255
                          // ((1 << depth) - 1))[:, None]
        if not colour:
            return np.take(cv_codec.gray(palette), index)
        return cv_codec.lookup(palette, index)
    return bgr.copy() if colour else cv_codec.gray(bgr)


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)``."""
    return _decode(data, name, False)


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return np.ascontiguousarray(_decode(data, name, True)[..., ::-1])
