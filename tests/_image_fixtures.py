"""The PNG and PNM fixtures of ``tests/data/png/`` and ``tests/data/pnm/``:
how they were made and the digests of what cv2 reads from them.

    python tests/_image_fixtures.py   # rewrites both folders' files and
                                      # digests.json

The pixels are the port's synthetic-shapes planes (``_jpeg_fixtures.
colour_image``). PNG: a 16-bit RGB and a palette image at 480 x 640 for
timing (the 16-bit one blown up 4 x 4 from 120 x 160), then at
240 x 320 or less gray at 1, 2 and 4 bits, a palette
with ``tRNS`` alphas, gray + alpha, 16-bit gray, a gray ``tRNS`` colour
key, Adam7-interlaced RGB and 16-bit gray (written here, since neither
cv2 nor PIL interlaces), an ``sRGB`` RGB file (libpng's gamma in a gray
read), an ``eXIf`` orientation 6, and a JPEG file named ``.png``. PNM:
ASCII and binary bitmaps (P1, P4), ASCII gray and colour at maxvals 100
and 1000 (P2, P3), binary 16-bit gray and colour (P5, P6) and binary
gray at maxval 100. Each folder's ``digests.json`` holds the shape and
sha256 of ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` at its top level
and of ``cv2.imread(path)`` (B, G, R) under ``"colour"``.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np

from _jpeg_fixtures import COLOUR, SMALL, colour_image, digest

ROOT = Path(__file__).resolve().parent / "data"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def with_chunk(data: bytes, kind: bytes, body: bytes) -> bytes:
    """A PNG file with one more chunk right after IHDR."""
    return data[:33] + png_chunk(kind, body) + data[33:]


def adam7(pixels: np.ndarray, depth: int = 8) -> bytes:
    """An Adam7-interlaced PNG of (H, W, C) uint8 or uint16 samples, every
    row of every pass under filter 0."""
    height, width, channels = pixels.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = pixels[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw += b"\0" + (row.astype(">u2") if depth == 16 else row) \
                .tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                             depth, colour, 0, 0, 1))
            + png_chunk(b"IDAT", zlib.compress(raw, 9))
            + png_chunk(b"IEND", b""))


def exif_orientation(orientation: int) -> bytes:
    """An eXIf chunk body: little-endian TIFF, IFD0 with the one tag."""
    return (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))


def png_fixtures() -> dict:
    import cv2
    from PIL import Image

    def pil(img, **kw):
        out = io.BytesIO()
        img.save(out, "PNG", **kw)
        return out.getvalue()

    big = colour_image()
    small = colour_image(SMALL, seed=5)
    rgb = small[::2, ::2, ::-1]
    h, w = big.shape[:2]
    # 16 bits: the planes at a quarter of the size, blown up 4 x 4 (so
    # that the file stays small), high; a smooth pattern low
    low = ((np.arange(w)[None, :] * 7 + np.arange(h)[:, None] * 3)
           & 0xFF).astype(np.uint16)
    coarse = np.repeat(np.repeat(big[::4, ::4], 4, axis=0), 4, axis=1)
    big16 = coarse.astype(np.uint16) * 256 + low[..., None]
    gray16 = small[..., 0].astype(np.uint16) * 256 + low[:240, :320]
    ok, rgb16 = cv2.imencode(".png", big16, [
        cv2.IMWRITE_PNG_COMPRESSION, 9,
        cv2.IMWRITE_PNG_STRATEGY, cv2.IMWRITE_PNG_STRATEGY_DEFAULT])
    ok2, jpg = cv2.imencode(".jpg", small[::2, ::2])
    assert ok and ok2
    palette = Image.fromarray(big[..., ::-1]).quantize(200)
    small_pal = Image.fromarray(rgb).quantize(60)
    plain = pil(Image.fromarray(rgb))
    return {
        "rgb16.png": rgb16.tobytes(),
        "palette.png": pil(palette),
        "gray1.png": pil(Image.fromarray(small[..., 1] >> 7), bits=1),
        "gray2.png": pil(Image.fromarray(small[..., 1] >> 6), bits=2),
        "gray4.png": pil(Image.fromarray(small[..., 1] >> 4), bits=4),
        "palette_trns.png": pil(small_pal,
                                transparency=bytes(range(0, 240, 4))),
        "gray_alpha.png": pil(Image.fromarray(small[..., 1]).convert("LA")),
        "gray16.png": pil(Image.fromarray(gray16)),
        "gray_trns.png": pil(Image.fromarray(small[..., 2]), transparency=77),
        "adam7_rgb.png": adam7(rgb[:61, :103]),
        "adam7_gray16.png": adam7(gray16[:77, :131, None], 16),
        "srgb.png": with_chunk(plain, b"sRGB", b"\0"),
        "exif6.png": with_chunk(plain, b"eXIf", exif_orientation(6)),
        "jpeg_as.png": jpg.tobytes(),
    }


def pnm_fixtures() -> dict:
    small = colour_image((48, 64), seed=7)
    g, rgb = small[..., 0], small[..., ::-1]
    h, w = g.shape

    def ascii_rows(values, per_line=17):
        flat = [str(int(v)) for v in np.asarray(values).reshape(-1)]
        return "\n".join(" ".join(flat[i:i + per_line])
                         for i in range(0, len(flat), per_line)) + "\n"

    bits = (g > 127).astype(np.uint8)
    wide = g.astype(np.uint16) * 257 + 3
    return {
        "bitmap_ascii.pbm": f"P1\n# bitmap\n{w} {h}\n".encode()
        + "".join("".join(str(b) for b in row) + "\n"
                  for row in bits).encode(),
        "bitmap.pbm": f"P4\n{w} {h}\n".encode()
        + np.packbits(bits, axis=1).tobytes(),
        "gray_ascii100.pgm": f"P2\n{w} {h}\n100\n".encode()
        + ascii_rows(g * 100 // 255).encode(),
        "gray_ascii1000.pgm": f"P2\n{w} {h}\n1000\n".encode()
        + ascii_rows(g.astype(np.int64) * 1000 // 255).encode(),
        "rgb_ascii100.ppm": f"P3\n{w} {h}\n100\n".encode()
        + ascii_rows(rgb.astype(np.int64) * 100 // 255).encode(),
        "gray16.pgm": f"P5\n{w} {h}\n65535\n".encode()
        + wide.astype(">u2").tobytes(),
        "rgb16.ppm": f"P6 {w} {h} 4095\n".encode()
        + (rgb.astype(">u2") * 16).tobytes(),
        "gray_max100.pgm": f"P5\n#c\n{w} {h}\n100\n".encode()
        + (g // 3).tobytes(),
    }


def write(folder: Path, files: dict) -> None:
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    gray, colour = {}, {}
    for name, data in files.items():
        path = folder / name
        path.write_bytes(data)
        gray[name] = digest(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        colour[name] = digest(cv2.imread(str(path)))
    gray[COLOUR] = colour
    (folder / "digests.json").write_text(json.dumps(gray, indent=1) + "\n")


def main() -> None:
    write(ROOT / "png", png_fixtures())
    write(ROOT / "pnm", pnm_fixtures())


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main()
