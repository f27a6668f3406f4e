"""``data/png.py``, the port's PNG reader and writer, against cv2.

The reader must give what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
gives, byte for byte: on files cv2 wrote (gray, RGB, RGBA; libpng picks
each row's filter), and on files encoded here with every row under one
chosen filter type (0-4) for each colour type (gray, gray + alpha, RGB,
RGBA). The writer's files read back equal through cv2. Broken files
raise; ``test_torch_imread_formats.py`` covers the other depths, colour
types, palettes and interlacing.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.data import png

COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prior, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def encode(pixels: np.ndarray, kind) -> bytes:
    """An 8-bit PNG of (H, W, C) pixels, every row under filter ``kind``
    (or a row-dependent kind when ``kind`` is a callable)."""
    H, W, C = pixels.shape
    raw, prior = b"", bytes(W * C)
    for y in range(H):
        row = pixels[y].tobytes()
        k = kind(y) if callable(kind) else kind
        raw += bytes([k]) + _filter_row(k, row, prior, C)
        prior = row

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    header = struct.pack(">IIBBBBB", W, H, 8, COLOUR[C], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _pixels(rng, H, W, C):
    """Noise with flat patches and ramps, so every filter sees carries."""
    x = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    x[: H // 3] = 200
    x[H // 3: H // 2] = (np.arange(W)[:, None] * 7 % 256).astype(np.uint8)
    return x


@pytest.mark.parametrize("channels", [1, 2, 3, 4],
                         ids=["gray", "gray-alpha", "rgb", "rgba"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_reader_equals_cv2_on_every_filter(tmp_path, channels, kind):
    rng = np.random.default_rng(channels)
    pixels = _pixels(rng, 23, 37, channels)
    path = tmp_path / "x.png"
    path.write_bytes(encode(pixels, (lambda y: y % 5) if kind == "mixed"
                            else kind))
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = png.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == (23, 37)
    np.testing.assert_array_equal(got, want)
    if channels <= 2:
        np.testing.assert_array_equal(got, pixels[..., 0])


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_reader_equals_cv2_on_files_cv2_wrote(tmp_path, channels):
    rng = np.random.default_rng(10 + channels)
    pixels = _pixels(rng, 48, 64, channels)
    path = tmp_path / "c.png"
    cv2.imwrite(str(path), pixels if channels > 1 else pixels[..., 0])
    np.testing.assert_array_equal(png.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_writer_reads_back_through_cv2(tmp_path):
    image = _pixels(np.random.default_rng(3), 48, 64, 1)[..., 0]
    path = tmp_path / "w.png"
    png.write_gray(path, image)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED), image)
    np.testing.assert_array_equal(png.read_gray(path), image)
    with pytest.raises(ValueError):
        png.write_gray(path, image.astype(np.float32))


def test_everything_else_raises(tmp_path):
    """What raised before and now reads as cv2 reads it: 16-bit samples, a
    palette image. What still raises, beside cv2's None: a bad CRC, a
    truncated file, a file that is not a PNG."""
    path = tmp_path / "bad.png"
    rng = np.random.default_rng(4)
    cv2.imwrite(str(path), rng.integers(0, 65535, (8, 8), dtype=np.uint16))
    np.testing.assert_array_equal(png.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    good = encode(_pixels(rng, 8, 8, 1), 0)
    interlaced = bytearray(good)
    interlaced[28] = 1  # IHDR's interlace byte (CRC now wrong too)
    for bad, message in ((bytes(interlaced), "CRC"), (good[:-20], ""),
                         (b"GIF89a" + good[6:], "not a PNG")):
        path.write_bytes(bad)
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None
        with pytest.raises(ValueError, match=message):
            png.read_gray(path)
    # a palette image: colour type 3 with a PLTE chunk of one colour
    body = struct.pack(">IIBBBBB", 8, 8, 8, 3, 0, 0, 0)
    plte = b"\x00" * 768
    chunks = (b"\x89PNG\r\n\x1a\n"
              + struct.pack(">I", 13) + b"IHDR" + body
              + struct.pack(">I", zlib.crc32(b"IHDR" + body))
              + struct.pack(">I", 768) + b"PLTE" + plte
              + struct.pack(">I", zlib.crc32(b"PLTE" + plte)))
    path.write_bytes(chunks + good[33:])
    np.testing.assert_array_equal(png.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.read_rgb(path)[..., ::-1],
                                  cv2.imread(str(path)))
