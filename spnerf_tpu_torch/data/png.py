"""PNG reading as ``cv2.imread`` does it, and 8-bit PNG writing, on
``zlib`` and numpy (no cv2).

The reader follows what OpenCV's ``grfmt_png.cpp`` asks of libpng:
every bit depth and colour type of the PNG specification, interlaced
(Adam7) or not, with any of the five row filters (undone by the port's
own C++, ``native/png_unfilter.cpp``, built by g++ at first use). Then
libpng's transformations in libpng's order:

- palettes expand to R, G, B (``png_set_palette_to_rgb``), gray at 1, 2
  and 4 bits to 8 (``png_set_expand_gray_1_2_4_to_8``: ``v * 255 /
  (2**depth - 1)``);
- alpha is dropped (``png_set_strip_alpha``); a ``tRNS`` chunk adds none,
  so neither changes a pixel;
- a gray read of colour goes through ``png_set_rgb_to_gray(0.299,
  0.587)``: (9797 R + 19234 G + 3737 B) >> 15 at 8 bits (truncated, an
  equal R, G, B kept), ``+ 16384`` before the shift at 16 bits; where the
  file's ``gAMA`` or ``sRGB`` chunk (before ``PLTE`` and ``IDAT``) names
  a gamma that is not 1 (within libpng's 5%), samples go through libpng's
  gamma tables to linear light and back (8-bit tables, or at 16 bits the
  11-bit-indexed ones that stripping to 8 bits makes it build), and the
  sum is rounded;
- 16-bit samples keep their high byte (``png_set_strip_16``);
- a colour read of gray replicates it.

The orientation of an ``eXIf`` chunk is applied as OpenCV's
``ExifTransform`` does. A broken file raises ``signature.Unreadable``, a ``ValueError``: cv2 returns None for
it too (a bad CRC in a critical chunk, a truncated file, no IEND, bad
image data; an ancillary chunk with a bad CRC is dropped, as libpng
drops it).
``write_gray`` and ``write_rgb`` write 8-bit gray
and RGB images, every row with filter 0, as the counterparts of
``cv2.imwrite``.
"""

from __future__ import annotations

import ctypes
import math
import struct
import zlib
from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import jpeg
from spnerf_tpu_torch.data.signature import Unreadable
from spnerf_tpu_torch.utils import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_RGB_TO_GRAY = (9797, 19234, 3737)  # libpng's fixed-point 0.299, 0.587
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_FP_1 = 100000  # libpng's fixed-point 1.0
_GAMMA_THRESHOLD = 5000  # PNG_GAMMA_THRESHOLD_FIXED
_GAMMA_SRGB = 45455  # PNG_GAMMA_sRGB_INVERSE


def _chunks(data: bytes):
    """(type, body) of each chunk to IEND; an ancillary chunk with a bad
    CRC is dropped, as libpng drops it."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise Unreadable("png: truncated chunk; cv2.imread does not read "
                             "it either")
        pos += 12 + length
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            if kind[0] & 0x20:  # ancillary
                continue
            raise Unreadable(f"png: bad CRC in {kind!r}; cv2.imread does not "
                             "read it either")
        yield kind, body
        if kind == b"IEND":
            return
    raise Unreadable("png: no IEND chunk; cv2.imread does not read it either")


def _unfilter(raw: memoryview, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """(height, stride) bytes of ``height`` filtered rows."""
    lib = native.load("png_unfilter")
    fn = lib.png_unfilter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    out = np.empty((height, stride), np.uint8)
    bad = fn(bytes(raw), height, stride, bpp, out.ctypes.data)
    if bad:
        raise Unreadable(f"png: unknown filter type in row {bad - 1}; "
                         "cv2.imread does not read it either")
    return out


def _unpack(rows: np.ndarray, width: int, depth: int,
            samples: int) -> np.ndarray:
    """(H, width, samples) uint8 or uint16 sample values of unfiltered
    rows."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(
            height, width, samples)
    if depth == 8:
        return rows.reshape(height, width, samples)
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    values = np.zeros(bits.shape[:2], np.uint8)
    for b in range(depth):
        values = (values << 1) | bits[..., b]
    return values[:, :width, None]


def _pixels(raw: bytes, width: int, height: int, depth: int, samples: int,
            interlace: int) -> np.ndarray:
    """(H, W, samples) sample values of the decompressed image data."""
    bpp = max(1, depth * samples // 8)

    def stride(w):
        return (w * depth * samples + 7) // 8

    view = memoryview(raw)
    if interlace == 0:
        need = height * (stride(width) + 1)
        if len(raw) < need:
            raise Unreadable(f"png: {len(raw)} bytes of image data, expected "
                             f"{need}; cv2.imread does not read it either")
        return _unpack(_unfilter(view[:need], height, stride(width), bpp),
                       width, depth, samples)
    out = np.zeros((height, width, samples),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        need = h * (stride(w) + 1)
        if len(raw) < pos + need:
            raise Unreadable("png: the interlaced image data ends early; "
                             "cv2.imread does not read it either")
        rows = _unfilter(view[pos:pos + need], h, stride(w), bpp)
        out[y0::dy, x0::dx] = _unpack(rows, w, depth, samples)
        pos += need
    return out


def _gamma_8bit_table(gamma: int) -> np.ndarray:
    """libpng's ``png_build_8bit_table``: ``floor(255 * (v / 255) **
    (gamma / 1e5) + .5)``, the ends kept."""
    table = np.arange(256, dtype=np.uint8)
    if abs(gamma - _FP_1) > _GAMMA_THRESHOLD:
        for v in range(1, 255):
            table[v] = int(math.floor(255 * math.pow(v / 255.0,
                                                     gamma * .00001) + .5))
    return table


def _gamma_16bit_table(gamma: int) -> np.ndarray:
    """libpng's ``png_build_16bit_table`` at shift 5, flattened over the
    11-bit index ``v >> 5``: ``floor(65535 * (i / 2047) ** (gamma / 1e5)
    + .5)``."""
    i = np.arange(2048, dtype=np.float64)
    return np.array([math.floor(65535. * math.pow(v / 2047, gamma * .00001)
                                + .5) for v in i], np.uint32)


def _gamma_16_to_8() -> np.ndarray:
    """libpng's ``png_build_16to8_table`` at shift 5 and gamma 1 (the
    file's gamma times the screen's, its reciprocal): the 16-bit sample
    ``i * 257`` of the 8-bit value ``i`` nearest the 11-bit index."""
    table = np.full(2048, 65535, np.uint32)
    last = 0
    for i in range(255):
        bound = ((i * 257 + 128) * 2047 + 32768) // 65535 + 1
        table[last:bound] = i * 257
        last = max(last, bound)
    return table


_GAMMA_16_TO_8 = _gamma_16_to_8()


def _reciprocal(gamma: int) -> int:
    """libpng's ``png_reciprocal``: 1e10 / gamma, rounded."""
    return int(math.floor(1e10 / gamma + .5))


def _rgb_to_gray(rgb: np.ndarray, gamma: int) -> np.ndarray:
    """``png_do_rgb_to_gray`` with cv2's coefficients, 8 or 16 bits."""
    rc, gc, bc = _RGB_TO_GRAY
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    equal = (r == g) & (r == b)
    if rgb.dtype == np.uint16:
        if not gamma:
            return ((rc * r + gc * g + bc * b + 16384) >> 15).astype(
                np.uint16)
        # libpng's 16-bit tables at gamma_shift 5 (the samples are stripped
        # to 8 bits after): indexed by the top 11 bits of a sample
        to_1 = _gamma_16bit_table(_reciprocal(gamma))
        from_1 = _gamma_16bit_table(_reciprocal(_reciprocal(gamma)))
        mixed = from_1[((rc * to_1[r >> 5] + gc * to_1[g >> 5]
                         + bc * to_1[b >> 5] + 16384) >> 15) >> 5]
        return np.where(equal, _GAMMA_16_TO_8[r >> 5], mixed).astype(
            np.uint16)
    if not gamma:
        return np.where(equal, r, (rc * r + gc * g + bc * b) >> 15) \
            .astype(np.uint8)
    to_1 = _gamma_8bit_table(_reciprocal(gamma)).astype(np.uint32)
    from_1 = _gamma_8bit_table(_reciprocal(_reciprocal(gamma)))
    mixed = from_1[(rc * to_1[r] + gc * to_1[g] + bc * to_1[b] + 16384) >> 15]
    return np.where(equal, r, mixed).astype(np.uint8)


def _file_gamma(chunks: dict) -> int:
    """The file's gamma in libpng's fixed point where it is significant
    (``gAMA``, or 45455 for an ``sRGB`` chunk), else 0."""
    gamma = 0
    if b"sRGB" in chunks:
        gamma = _GAMMA_SRGB
    elif b"gAMA" in chunks and len(chunks[b"gAMA"]) == 4:
        value = struct.unpack(">I", chunks[b"gAMA"])[0]
        if 16 <= value <= 625000000:  # libpng's png_colorspace_set_gamma
            gamma = value
    return gamma if abs(gamma - _FP_1) > _GAMMA_THRESHOLD else 0


def _exif_orientation(body: bytes) -> int:
    """The orientation tag of an ``eXIf`` chunk's TIFF structure, else 1."""
    return jpeg.exif_orientation(b"\xff\xd8" + b"\xff\xe1" + struct.pack(
        ">H", len(body) + 8) + b"Exif\0\0" + body)


def _decode(data: bytes, name: str, channels: int) -> np.ndarray:
    """(H, W) uint8 for ``channels`` 1 (``IMREAD_GRAYSCALE``), (H, W, 3)
    R, G, B for 3 (``IMREAD_COLOR``, reversed)."""
    if not data.startswith(_SIGNATURE):
        raise Unreadable(f"png: {name} is not a PNG file")
    chunks, idat = {}, []
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind in (b"gAMA", b"sRGB") and (idat or b"PLTE" in chunks):
            continue  # libpng ignores them "out of place"
        else:
            chunks.setdefault(kind, body)
    if b"IHDR" not in chunks or not idat:
        raise Unreadable(f"png: {name}: no IHDR or IDAT chunk; cv2.imread "
                         "does not read it either")
    width, height, depth, colour, compression, filtering, interlace = \
        struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    if (depth not in _DEPTHS.get(colour, ()) or compression != 0
            or filtering != 0 or interlace > 1 or not width or not height):
        raise Unreadable(f"png: {name}: bit depth {depth}, colour type "
                         f"{colour}, compression {compression}, filter "
                         f"method {filtering}, interlace {interlace}: not a "
                         "valid PNG; cv2.imread does not read it either")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as err:
        raise Unreadable(f"png: {name}: {err}; cv2.imread does not read it "
                         "either") from None
    pixels = _pixels(raw, width, height, depth, _CHANNELS[colour], interlace)
    if colour == 3:  # png_set_palette_to_rgb
        plte = np.frombuffer(chunks.get(b"PLTE", b""), np.uint8)
        palette = np.zeros((256, 3), np.uint8)
        # indices past PLTE read libpng's zeroed entries
        palette[:len(plte) // 3] = plte[:len(plte) // 3 * 3].reshape(-1, 3)
        if channels == 1:  # rgb_to_gray is per pixel: once per entry
            palette = _rgb_to_gray(palette[None], _file_gamma(chunks))[0]
            palette = palette[:, None]
        pixels = palette[pixels[..., 0]]
    elif depth < 8:  # png_set_expand_gray_1_2_4_to_8
        pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    pixels = pixels[..., :3] if pixels.shape[2] >= 3 else pixels[..., :1]
    if channels == 1 and pixels.shape[2] == 3:
        pixels = _rgb_to_gray(pixels, _file_gamma(chunks))[..., None]
    if pixels.dtype == np.uint16:  # png_set_strip_16
        pixels = (pixels >> 8).astype(np.uint8)
    if channels == 1:
        out = pixels[..., 0]
    elif pixels.shape[2] == 1:
        out = np.repeat(pixels, 3, axis=2)
    else:
        out = pixels
    if b"eXIf" in chunks:
        return jpeg.apply_orientation(out, _exif_orientation(chunks[b"eXIf"]))
    return np.ascontiguousarray(out)


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8: ``cv2.imdecode(data, IMREAD_GRAYSCALE)`` of a PNG
    file's bytes."""
    return _decode(data, name, 1)


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imdecode(data)[..., ::-1]``."""
    return _decode(data, name, 3)


def read_gray(path) -> np.ndarray:
    """(H, W) uint8: ``cv2.imread(path, IMREAD_GRAYSCALE)`` of a PNG."""
    return decode_gray(Path(path).read_bytes(), str(path))


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B: ``cv2.imread(path)[:, :, ::-1]`` of a PNG
    (alpha dropped, gray replicated)."""
    return decode_rgb(Path(path).read_bytes(), str(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write(path, image: np.ndarray, colour: int) -> None:
    height, width = image.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           image.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))


def write_gray(path, image: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit gray PNG (filter 0)."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"png: write_gray takes (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    _write(path, image, 0)


def write_rgb(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit RGB PNG (filter 0)."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"png: write_rgb takes (H, W, 3) uint8, got "
                         f"{image.shape} {image.dtype}")
    _write(path, np.ascontiguousarray(image), 2)
