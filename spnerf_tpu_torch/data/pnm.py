"""PBM / PGM / PPM reading on numpy (no cv2), as OpenCV's ``grfmt_pxm.cpp``
reads them: the port's counterpart of ``cv2.imread`` for HPatches'
``.ppm`` files and any other P1-P6 file.

``decode_gray`` / ``read_gray`` return an (H, W) uint8 array, as
``cv2.imread(path, IMREAD_GRAYSCALE)``; ``decode_rgb`` / ``read_rgb`` (H,
W, 3) R, G, B, as ``cv2.imread(path)[..., ::-1]``: gray in three equal
planes. All six magic numbers are read, with ``#`` comments in the
header, as OpenCV reads them:

- P1 / P4 bitmaps: a set bit is black (0), a clear one white (255); P1's
  digits need no space between them;
- P2 / P3 (ASCII): samples past maxval are clamped to it, and at maxval
  255 or less each is scaled to ``v * 255 // maxval``;
- P5 / P6 (binary) at maxval 255 or less: the bytes as stored, not
  scaled;
- maxval 256-65535: big-endian 16-bit samples (ASCII ones clamped),
  brought to 8 bits by ``>> 8``.

Colour goes to gray as OpenCV's image codecs convert it, in 14-bit fixed
point with rounding: (4899 R + 9617 G + 1868 B + 8192) >> 14 (0.299,
0.587, 0.114; not libpng's weights, which ``data/png.py`` uses). A file
cut short or with a bad header raises ``signature.Unreadable``, a
``ValueError``: ``cv2.imread`` returns None for it too. ``write`` writes
(H, W) uint8 images as P5 and (H, W, 3) RGB ones as P6, with the header
``cv2.imwrite`` writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data.signature import Unreadable

_RGB_TO_GRAY = (4899, 9617, 1868)  # OpenCV's cR, cG, cB at SCALE 14
_WHITESPACE = b" \t\n\v\f\r"


class _Stream:
    """OpenCV's ``ReadNumber`` over the file's bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise Unreadable("pnm: the file ends inside its numbers")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, max_digits: int = 0) -> int:
        code = self.byte()
        while not 0x30 <= code <= 0x39:
            if code == 0x23:  # '#': a comment to the end of its line
                while code not in (0x0A, 0x0D):
                    code = self.byte()
                code = self.byte()
            elif bytes([code]) in _WHITESPACE:
                while bytes([code]) in _WHITESPACE:
                    code = self.byte()
            else:
                raise Unreadable(f"pnm: unexpected byte 0x{code:x} in a "
                                 "number")
        value, digits = 0, 0
        while True:
            value = value * 10 + code - 0x30
            digits += 1
            if value > 2**31 - 1:
                raise Unreadable("pnm: a number past INT_MAX")
            if max_digits and digits >= max_digits:
                return value
            # the byte past a number is read: a P2 / P3 file that ends
            # on a digit is cut, as OpenCV's stream finds it
            code = self.byte()
            if not 0x30 <= code <= 0x39:
                return value


def _decode(data: bytes, name: str) -> np.ndarray:
    """(H, W, 1) or (H, W, 3) uint8 R, G, B samples of a P1-P6 file."""
    if len(data) < 3 or data[0] != 0x50 or data[1] not in b"123456":
        raise Unreadable(f"pnm: {name} is not a PBM / PGM / PPM file")
    kind = data[1] - 0x30
    bitmap, channels, binary = kind in (1, 4), 3 if kind in (3, 6) else 1, \
        kind >= 4
    s = _Stream(data, 2)
    try:
        width, height = s.number(), s.number()
        maxval = 1 if bitmap else s.number()
    except Unreadable as err:
        raise Unreadable(f"pnm: {name}: bad header ({err}); cv2.imread does "
                         "not read it either") from None
    if width <= 0 or height <= 0 or not 0 < maxval < 65536:
        raise Unreadable(f"pnm: {name}: bad header ({width} x {height}, "
                         f"maxval {maxval}); cv2.imread does not read it "
                         "either")
    wide = maxval > 255
    n = width * height * channels
    try:
        if bitmap and binary:
            pitch = (width + 7) // 8
            rows = np.frombuffer(data, np.uint8, pitch * height, s.pos)
            bits = np.unpackbits(rows.reshape(height, pitch), axis=1)
            samples = np.where(bits[:, :width] != 0, 0, 255).astype(np.uint8)
        elif binary:
            dtype = np.dtype(">u2") if wide else np.uint8
            samples = np.frombuffer(data, dtype, n, s.pos)
            samples = (samples >> 8).astype(np.uint8) if wide else samples
        elif bitmap:
            samples = np.array([0 if s.number(1) else 255 for _ in range(n)],
                               np.uint8)
        else:
            codes = np.minimum([s.number() for _ in range(n)], maxval)
            samples = ((codes >> 8) if wide else codes * 255 // maxval) \
                .astype(np.uint8)
    except ValueError as err:  # np.frombuffer past the end of the file
        if isinstance(err, Unreadable):
            raise Unreadable(f"pnm: {name}: {err}; cv2.imread does not read "
                             "it either") from None
        raise Unreadable(f"pnm: {name}: truncated ({width} x {height}); "
                         "cv2.imread does not read it either") from None
    return np.asarray(samples).reshape(height, width, channels)


def _gray(pixels: np.ndarray) -> np.ndarray:
    if pixels.shape[2] == 1:
        return pixels[..., 0].copy()
    rgb = pixels.astype(np.int32)
    cr, cg, cb = _RGB_TO_GRAY
    gray = (rgb[..., 0] * cr + rgb[..., 1] * cg + rgb[..., 2] * cb
            + (1 << 13)) >> 14
    return gray.astype(np.uint8)


def _rgb(pixels: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(
        pixels, pixels.shape[:2] + (3,)))


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)`` of a P1-P6
    file's bytes."""
    return _gray(_decode(data, name))


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return _rgb(_decode(data, name))


def read_gray(path) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path, IMREAD_GRAYSCALE)``
    returns it, for PBM, PGM and PPM files (P1-P6)."""
    return decode_gray(Path(path).read_bytes(), str(path))


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B, as ``cv2.imread(path)[..., ::-1]`` returns
    it, for PBM, PGM and PPM files (P1-P6)."""
    return decode_rgb(Path(path).read_bytes(), str(path))


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
