"""The fixtures of OpenCV's own six decoders, ``tests/data/{bmp, sunras,
pam, pfm, hdr, gif}/``: how they were made and the digests of what cv2
reads from them.

    python tests/_codec_fixtures.py   # rewrites the six folders' files
                                      # and digests.json

The pixels are the port's synthetic-shapes planes (``_jpeg_fixtures.
colour_image``), 48 x 64 for every uncompressed file, 120 x 160 for the
small GIFs. The 480 x 640 files timed on the card are the run-length HDR
file and the GIF (compressed); the uncompressed ones timed there (BMP,
Sun raster, PAM, PFM) are written at run time by
``spnerf_tpu_torch/tools/smoke_data.py``.

- BMP: 24 bits (cv2), 8-bit gray palette (cv2), 8-bit colour palette,
  4 and 1 bits, ``BI_RLE8`` with deltas and an early end of bitmap,
  ``BI_RLE4``, 5-5-5 and 5-6-5 (``BI_BITFIELDS``) 16 bits, 32 bits,
  a V5 header's 32-bit masks, an OS/2 header, a top-down file and a V4
  header;
- Sun raster: 24 bits (cv2), 8 bits with a colour map and without one
  (gray read black, as cv2 reads it), 1 bit, 32 bits, the old type, a
  short colour map;
- PAM: gray, RGB (cv2), 16-bit RGB at maxval 1000, black and white,
  gray + alpha and RGB + alpha one pixel wide (the widths where cv2
  writes every byte, ``data/pam.py``);
- PFM: gray and colour (a gray read of colour is cv2's None), big-endian
  and scaled;
- HDR: run-length 480 x 640 (cv2; colours in steps of 16), flat,
  ``#?RGBE`` with header lines, old-style runs;
- GIF: colour 480 x 640 (cv2), gray, interlaced, local table, a
  transparent frame inside a larger screen, an animation, GIF87a, code
  size 2, no colour table at all.

Each folder's ``digests.json`` holds the shape and sha256 of
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` at its top level and of
``cv2.imread(path)`` (B, G, R) under ``"colour"``, null where cv2 returns
None.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import _image_writers as w
from _image_fixtures import write
from _jpeg_fixtures import SIZE, colour_image

ROOT = Path(__file__).resolve().parent / "data"
SMALL = (48, 64)  # the uncompressed files
GIF_SMALL = (120, 160)


def _encode(ext: str, img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(ext, img)
    assert ok
    return buf.tobytes()


def _quantized(rgb: np.ndarray, colours: int):
    """(indices, (N, 3) R, G, B palette) of an RGB image, by PIL."""
    from PIL import Image

    img = Image.fromarray(rgb).quantize(colours)
    pal = np.array(img.getpalette()[:3 * colours], np.uint8).reshape(-1, 3)
    return np.array(img), pal


def bmp_fixtures() -> dict:
    bgr = colour_image(SMALL, seed=11)
    rgb = bgr[..., ::-1]
    h, width = bgr.shape[:2]
    rng = np.random.default_rng(11)
    index8, pal8 = _quantized(rgb, 256)
    index4, pal4 = _quantized(rgb, 16)
    bits = (bgr[..., 1] > 127).astype(np.uint8)
    v = bgr.astype(np.uint16)
    red, green, blue = v[..., 2], v[..., 1], v[..., 0]
    rgb555 = ((red >> 3) << 10) | ((green >> 3) << 5) | (blue >> 3)
    rgb565 = ((red >> 3) << 11) | ((green >> 2) << 5) | (blue >> 3)
    bgra = np.concatenate([bgr, bgr[..., :1]], -1)
    masks10 = np.uint32(0x3FF00000), np.uint32(0xFFC00), np.uint32(0x3FF)
    wide = ((v[..., 2].astype(np.uint32) * 4) << 20
            | (v[..., 1].astype(np.uint32) * 4) << 10
            | v[..., 0].astype(np.uint32) * 4)
    return {
        "rgb24.bmp": _encode(".bmp", bgr),
        "gray8.bmp": _encode(".bmp", bgr[..., 0]),
        "palette8.bmp": w.bmp(width, h, 8, w.bmp_rows(index8, 8),
                              palette=w.palette(pal8)),
        "palette4.bmp": w.bmp(width, h, 4, w.bmp_rows(index4, 4),
                              palette=w.palette(pal4), colours=16),
        "bits1.bmp": w.bmp(width, h, 1, w.bmp_rows(bits, 1),
                           palette=w.palette([[10, 20, 30], [250, 240, 200]])),
        "rle8.bmp": w.bmp(width, h, 8, w.rle(index8, 8, rng), 1,
                          w.palette(pal8)),
        "rle4.bmp": w.bmp(width, h, 4, w.rle(index4, 4, rng, False), 2,
                          w.palette(pal4)),
        "rgb555.bmp": w.bmp(width, h, 16, w.bmp_rows(
            rgb555.astype("<u2").view(np.uint8), 8)),
        "rgb565.bmp": w.bmp(width, h, 16, w.bmp_rows(
            rgb565.astype("<u2").view(np.uint8), 8), 3,
            after_header=np.array([0xF800, 0x7E0, 0x1F], "<u4").tobytes()),
        "bgra32.bmp": w.bmp(width, h, 32, w.bmp_rows(
            bgra.reshape(h, -1), 8)),
        "v5_masks32.bmp": w.bmp(width, h, 32, w.bmp_rows(
            wide.astype("<u4").view(np.uint8), 8), 3, header_size=124,
            header_extra=np.array([*masks10, 0], "<u4").tobytes()),
        "os2_palette8.bmp": w.bmp(width, h, 8, w.bmp_rows(index8, 8),
                                  palette=w.palette(pal8, 3),
                                  header_size=12),
        "top_down24.bmp": w.bmp(width, -h, 24, w.bmp_rows(
            bgr[::-1].reshape(h, -1), 8)),
        "v4_24.bmp": w.bmp(width, h, 24, w.bmp_rows(bgr.reshape(h, -1), 8),
                           header_size=108),
    }


def sunras_fixtures() -> dict:
    bgr = colour_image(SMALL, seed=12)
    h, width = bgr.shape[:2]
    index8, pal8 = _quantized(bgr[..., ::-1], 200)
    planes = pal8.T.tobytes()  # R, G, B planes
    bits = (bgr[..., 2] > 127).astype(np.uint8)
    xbgr = np.concatenate([bgr[..., :1] * 0 + 7, bgr], -1)
    return {
        "bgr24.ras": _encode(".ras", bgr),
        "map8.ras": w.sunras(width, h, 8, w.sunras_rows(index8, 8),
                             colour_map=planes),
        "gray8.ras": w.sunras(width, h, 8, w.sunras_rows(bgr[..., 1], 8)),
        "bits1.ras": w.sunras(width, h, 1, w.sunras_rows(bits, 1)),
        "map1.ras": w.sunras(width, h, 1, w.sunras_rows(bits, 1),
                             colour_map=bytes([20, 200, 40, 160, 60, 120])),
        "xbgr32.ras": w.sunras(width, h, 32, w.sunras_rows(
            xbgr.reshape(h, -1), 8)),
        "old_type24.ras": w.sunras(width, h, 24, w.sunras_rows(
            bgr.reshape(h, -1), 8), kind=0),
        "short_map8.ras": w.sunras(width, h, 8, w.sunras_rows(index8 % 64, 8),
                                   colour_map=pal8[:50].T.tobytes()),
    }


def pam_fixtures() -> dict:
    bgr = colour_image(SMALL, seed=13)
    h, width = bgr.shape[:2]
    rgb = bgr[..., ::-1]
    wide = rgb.astype(np.uint32) * 1000 // 255
    bits = np.packbits(bgr[..., 0] > 127, axis=1)
    column = bgr[:, :1]
    return {
        "rgb.pam": _encode(".pam", bgr),
        "gray.pam": _encode(".pam", bgr[..., 1]),
        "rgb16_max1000.pam": w.pam(width, h, 3, 1000,
                                   wide.astype(">u2").tobytes(), "RGB"),
        "black_and_white.pam": w.pam(width, h, 1, 1, np.concatenate(
            [bits, np.zeros((h, width - bits.shape[1]), np.uint8)], 1)
            .tobytes(), "BLACKANDWHITE"),
        "gray_alpha_column.pam": w.pam(1, h, 2, 255, np.concatenate(
            [column[..., :1], column[..., 1:2]], -1).tobytes(),
            "GRAYSCALE_ALPHA"),
        "rgb_alpha_column.pam": w.pam(1, h, 4, 255, np.concatenate(
            [column[..., ::-1], column[..., :1]], -1).tobytes(), "RGB_ALPHA",
            eol="\r"),
    }


def pfm_fixtures() -> dict:
    bgr = colour_image(SMALL, seed=14)
    values = bgr.astype(np.float32) / 255
    values[:4, :4] = [[-1.0], [1.5], [0.5 / 255], [np.inf]]
    return {
        "gray.pfm": _encode(".pfm", values[..., 0]),
        "rgb.pfm": _encode(".pfm", values),
        "gray_big_endian.pfm": w.pfm(values[..., 1] * 255, scale=1.0),
        "rgb_scaled.pfm": w.pfm(values[..., ::-1] * 1000, scale=-1000 / 255),
    }


def hdr_fixtures() -> dict:
    # colours in steps of 16, so that the scanlines hold runs
    bgr = colour_image(SIZE, seed=15) // 16 * 16
    small = colour_image(SMALL, seed=16).astype(np.float32) / 255
    small[:8, :8] *= 40.0  # past 1: saturated at 8 bits
    quads = w.rgbe(small[..., ::-1])
    old = quads.copy()
    old[5, 20] = old[5, 19]
    old[5, 21:24] = [1, 1, 1, 3]  # Ward's old-style run, read as pixels
    return {
        "rle_480x640.hdr": _encode(".hdr", bgr.astype(np.float32) / 255),
        "flat.hdr": w.hdr(quads, run_length=False),
        "rgbe_header.hdr": w.hdr(quads, magic="RGBE",
                                 extra="GAMMA=1.0\nEXPOSURE=1.0\n",
                                 rng=np.random.default_rng(16)),
        "old_style_runs.hdr": w.hdr(old, run_length=False),
    }


def gif_fixtures() -> dict:
    bgr = colour_image(SIZE, seed=17)
    small = colour_image(GIF_SMALL, seed=18)
    h, width = small.shape[:2]
    gray_table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    index, pal = _quantized(small[..., ::-1], 256)
    index16, pal16 = _quantized(small[..., ::-1], 16)
    index4 = np.minimum(small[..., 0] // 64, 3)
    pal4 = np.array([[0, 0, 0], [90, 30, 200], [30, 200, 90], [250, 250, 250]],
                    np.uint8)
    return {
        "colour_480x640.gif": _encode(".gif", bgr),
        "gray.gif": w.gif(width, h, [w.gif_frame(small[..., 1], min_size=8)],
                          gray_table),
        "interlaced.gif": w.gif(width, h, [w.gif_frame(
            index, interlace=True, min_size=8)], pal),
        "local_table.gif": w.gif(width, h, [w.gif_frame(
            index16, local_table=pal16, block=100)], pal4, background=1),
        "transparent_frame.gif": w.gif(width, h, [w.gif_frame(
            index16[20:90, 30:140], left=30, top=20, local_table=pal16,
            control={"disposal": 2, "transparent": int(index16[50, 60])})],
            pal4, background=2),
        "animation.gif": w.gif(width, h, [
            w.gif_frame(index4, control={"delay": 10}),
            w.gif_frame(3 - index4, control={"delay": 10})], pal4,
            extensions=b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"),
        "gif87a.gif": w.gif(width, h, [w.gif_frame(index4, clear_at=300)],
                            pal4, version=b"GIF87a"),
        "no_colour_table.gif": w.gif(width, h, [w.gif_frame(
            index16, min_size=4)]),
    }


def main() -> None:
    for folder, make in (("bmp", bmp_fixtures), ("sunras", sunras_fixtures),
                         ("pam", pam_fixtures), ("pfm", pfm_fixtures),
                         ("hdr", hdr_fixtures), ("gif", gif_fixtures)):
        write(ROOT / folder, make())


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main()
