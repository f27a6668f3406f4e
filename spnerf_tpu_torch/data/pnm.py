"""Binary PGM / PPM reading on numpy (no cv2): the port's counterpart of
``cv2.imread`` for HPatches' ``.ppm`` files.

``read_gray`` decodes P5 (gray) and P6 (RGB) files of maxval 255, with
``#`` comments in the header, and returns an (H, W) uint8 array, as
``cv2.imread(path, IMREAD_GRAYSCALE)``; ``read_rgb`` returns (H, W, 3) R,
G, B, as ``cv2.imread(path)[..., ::-1]``: P6 as stored, P5 in three
equal planes. Colour goes to gray as OpenCV's image codecs convert it,
in 14-bit fixed point
with rounding: (4899 R + 9617 G + 1868 B + 8192) >> 14 (0.299, 0.587,
0.114; not libpng's weights, which ``data/png.py`` uses). Other magic
numbers, maxvals and truncated files raise ``ValueError``. ``write``
writes (H, W) uint8 images as P5 and (H, W, 3) RGB ones as P6, with the
header ``cv2.imwrite`` writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_RGB_TO_GRAY = (4899, 9617, 1868)  # OpenCV's cR, cG, cB at SCALE 14


def _header(data: bytes):
    """(magic, width, height, maxval, offset of the pixels)."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if pos < len(data) and data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace() \
                and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise ValueError("pnm: truncated header")
        tokens.append(data[start:pos])
    if pos >= len(data) or not data[pos:pos + 1].isspace():
        raise ValueError("pnm: no whitespace after the header")
    magic = tokens[0].decode("ascii", "replace")
    try:
        width, height, maxval = (int(t) for t in tokens[1:])
    except ValueError:
        raise ValueError(f"pnm: bad header {tokens!r}") from None
    return magic, width, height, maxval, pos + 1


def _read(path):
    """The (H, W, 1) or (H, W, 3) pixels of a P5 / P6 file."""
    data = Path(path).read_bytes()
    magic, width, height, maxval, offset = _header(data)
    if magic not in ("P5", "P6"):
        raise ValueError(f"pnm: {path}: only binary P5 / P6 files are read, "
                         f"not {magic!r}")
    if maxval != 255:
        raise ValueError(f"pnm: {path}: only maxval 255 is read, not "
                         f"{maxval}")
    channels = 1 if magic == "P5" else 3
    n = width * height * channels
    if width <= 0 or height <= 0 or len(data) - offset < n:
        raise ValueError(f"pnm: {path}: truncated ({width} x {height})")
    return np.frombuffer(data, np.uint8, n, offset).reshape(
        height, width, channels)


def read_gray(path) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path, IMREAD_GRAYSCALE)``
    returns it, for binary 8-bit PGM (P5) and PPM (P6) files."""
    pixels = _read(path)
    if pixels.shape[2] == 1:
        return pixels[..., 0].copy()
    rgb = pixels.astype(np.int32)
    cr, cg, cb = _RGB_TO_GRAY
    gray = (rgb[..., 0] * cr + rgb[..., 1] * cg + rgb[..., 2] * cb
            + (1 << 13)) >> 14
    return gray.astype(np.uint8)


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B, as ``cv2.imread(path)[..., ::-1]`` returns
    it, for binary 8-bit PGM (P5) and PPM (P6) files."""
    pixels = _read(path)
    return np.ascontiguousarray(np.broadcast_to(
        pixels, pixels.shape[:2] + (3,)))


def write(path, image: np.ndarray) -> None:
    """Write an (H, W) gray or (H, W, 3) RGB uint8 image as a binary PGM
    (P5) or PPM (P6) file."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (
            image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"pnm.write takes (H, W[, 3]) uint8, got "
                         f"{image.shape} {image.dtype}")
    magic = "P5" if image.ndim == 2 else "P6"
    header = f"{magic}\n{image.shape[1]} {image.shape[0]}\n255\n"
    Path(path).write_bytes(header.encode("ascii") + image.tobytes())
