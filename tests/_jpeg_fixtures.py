"""The JPEG fixtures of ``tests/data/jpeg/``: how they were made and the
digests of what cv2 reads from them.

    python tests/_jpeg_fixtures.py   # rewrites the files and digests.json

Each colour file carries three synthetic-shapes samples drawn by the
port's generator as its B, G, R planes (480 x 640 for the first seven and
the progressive 4:2:0 file, 240 x 320 for the others), encoded by
``cv2.imencode`` (libjpeg-turbo) or by PIL: baseline at 4:2:0, 4:2:2,
4:4:4, 4:4:0 and 4:1:1, gray, restart intervals, an odd size, EXIF
orientation 6; progressive colour and gray from cv2 and an optimized
progressive file with restart intervals from PIL; Adobe CMYK from PIL
and the same file marked YCCK (Adobe transform 2); a baseline file cut
at 60% of its bytes. Then the kinds libjpeg reads that no encoder on the
host writes, or that come of damage (one 480 x 640 file of each for
timing, the rest 240 x 320 or smaller): arithmetic-coded files
transcoded from baseline ones by ``_jpeg_writers.py`` (sequential,
progressive, with DAC conditioning and restart intervals, one cut short);
RGB-coded files from PIL's ``keep_rgb`` (with the Adobe marker, and with
only the component ids 'R' 'G' 'B'); progressive files block-smoothed by
libjpeg (cut inside a scan, or stopped at a scan boundary); a lossless
gray file (``_jpeg_writers.lossless_gray``, predictor 4); a missing,
a renumbered and an earlier restart marker (libjpeg's resync); stray
bytes before markers; and a PNG file named ``.jpg``, read through the
signature dispatch. ``digests.json`` holds the shape and sha256 of
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` of each file at its top level
and of ``cv2.imread(path)`` (B, G, R) under ``COLOUR`` (null where cv2
returns None: a colour read of the lossless file), so that a machine
without cv2 can hold a decoder to both.
"""

from __future__ import annotations

import hashlib
import json
import struct
from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent / "data" / "jpeg"
SIZE = (480, 640)
SMALL = (240, 320)
PRIMITIVES = ("draw_checkerboard", "draw_cube", "draw_star")
COLOUR = "colour"  # the key of the colour digests in digests.json


def orientation_app1(orientation: int) -> bytes:
    """An APP1 EXIF segment whose IFD0 holds one tag, the orientation."""
    tiff = (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_app1(data: bytes, segment: bytes) -> bytes:
    """``data`` with ``segment`` inserted after SOI and any APP0."""
    pos = 2
    if data[2:4] == b"\xff\xe0":
        pos = 4 + struct.unpack(">H", data[4:6])[0]
    return data[:pos] + segment + data[pos:]


def colour_image(size=SIZE, seed: int = 0) -> np.ndarray:
    from spnerf_tpu_torch.data.synthetic_draw import generate_sample
    from spnerf_tpu_torch.eval.cv_rng import CvRNG

    planes = []
    for i, primitive in enumerate(PRIMITIVES):
        img, _ = generate_sample(
            primitive, np.random.default_rng(seed + i), size,
            {"generate_background": {"min_kernel_size": 20,
                                     "max_kernel_size": 60}},
            cv_rng=CvRNG(seed + i + 1))
        planes.append(img)
    return np.stack(planes, axis=-1)


def fixtures() -> dict:
    """{file name: bytes} of every fixture."""
    import io

    import cv2
    from PIL import Image

    def enc(img, **kw):
        params = []
        for key, value in kw.items():
            params += [getattr(cv2, "IMWRITE_JPEG_" + key.upper()), value]
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        return buf.tobytes()

    def pil(img, mode, **kw):
        out = io.BytesIO()
        Image.fromarray(img, mode).save(out, "JPEG", **kw)
        return out.getvalue()

    def sampling(name):
        return getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + name)

    bgr = colour_image()
    small = colour_image(SMALL, seed=3)
    return {**_first_fixtures(enc, pil, sampling, bgr, small),
            **_damaged_and_rare(enc, pil, sampling, bgr, small)}


def _first_fixtures(enc, pil, sampling, bgr, small) -> dict:
    cmyk = pil(np.concatenate([small, small[::-1, ::-1, :1]], axis=-1),
               "CMYK", quality=85)
    adobe = cmyk.index(b"Adobe") + 11  # the transform byte: 0, CMYK
    baseline = enc(small, quality=90)
    return {
        "q95_420.jpg": enc(bgr, quality=95, sampling_factor=sampling("420")),
        "q80_422.jpg": enc(bgr, quality=80, sampling_factor=sampling("422")),
        "q90_444.jpg": enc(bgr, quality=90, sampling_factor=sampling("444")),
        "gray_q85.jpg": enc(bgr[..., 1], quality=85),
        "q75_420_rst.jpg": enc(bgr, quality=75, rst_interval=3),
        "odd_479x637.jpg": enc(bgr[:479, :637], quality=90),
        "exif6.jpg": with_app1(enc(bgr, quality=85), orientation_app1(6)),
        "prog_420.jpg": enc(bgr, quality=90, progressive=1),
        "prog_gray.jpg": enc(small[..., 2], quality=80, progressive=1),
        "prog_pil_opt_rst.jpg": pil(small[..., ::-1], "RGB", quality=75,
                                    progressive=True, optimize=True,
                                    restart_marker_blocks=5),
        "s440.jpg": enc(small, quality=85, sampling_factor=sampling("440")),
        "s411.jpg": enc(small, quality=85, sampling_factor=sampling("411")),
        "cmyk.jpg": cmyk,
        "ycck.jpg": cmyk[:adobe] + b"\x02" + cmyk[adobe + 1:],
        "cut60.jpg": baseline[:int(0.6 * len(baseline))],
    }


def _markers(data: bytes, codes) -> list:
    """Offsets of the markers FF xx with xx in ``codes``."""
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] in codes]


def _damaged_and_rare(enc, pil, sampling, bgr, small) -> dict:
    import cv2

    from _jpeg_writers import arithmetic, baseline_coefficients, lossless_gray

    rst = range(0xD0, 0xD8)
    big = enc(bgr, quality=75)
    small_444 = enc(small, quality=85, sampling_factor=sampling("444"))
    small_gray = enc(small[..., 1], quality=85)
    prog_big = enc(bgr, quality=75, progressive=1)
    prog_small = enc(small, quality=85, progressive=1)
    scans = _markers(prog_small, (0xDA,))
    rgb_prog = pil(small[..., ::-1], "RGB", quality=85, keep_rgb=True,
                   progressive=True)
    adobe = rgb_prog.index(b"\xff\xee")
    adobe_len = struct.unpack(">H", rgb_prog[adobe + 2:adobe + 4])[0]
    with_rst = enc(bgr, quality=75, rst_interval=4)
    small_rst = enc(small, quality=85, rst_interval=2)
    big_rsts, small_rsts = _markers(with_rst, rst), _markers(small_rst, rst)
    cut_rst, earlier = small_rsts[len(small_rsts) // 2], \
        small_rsts[len(small_rsts) // 3]
    dqt = small_gray.index(b"\xff\xdb")
    sos = small_gray.index(b"\xff\xda")
    ok, png = cv2.imencode(".png", small[::2, ::2])
    assert ok
    arith_prog_small = arithmetic(baseline_coefficients(small_444),
                                  progressive=True, restart=9)
    return {
        "arith_420.jpg": arithmetic(baseline_coefficients(big)),
        "arith_prog_420.jpg": arithmetic(baseline_coefficients(big),
                                         progressive=True),
        "arith_gray_dac_rst.jpg": arithmetic(
            baseline_coefficients(small_gray), restart=7,
            dac={"L": [2], "U": [4], "K": [9]}),
        "arith_prog_444_rst.jpg": arith_prog_small,
        "arith_prog_cut.jpg": arith_prog_small[:int(0.55 * len(
            arith_prog_small))],
        "rgb_444.jpg": pil(bgr[..., ::-1], "RGB", quality=75, keep_rgb=True),
        "rgb_ids_prog.jpg": rgb_prog[:adobe] + rgb_prog[adobe + 2
                                                        + adobe_len:],
        "prog_smooth_cut.jpg": prog_big[:int(0.45 * len(prog_big))],
        "prog_smooth_script.jpg": prog_small[:scans[4]] + b"\xff\xd9",
        "prog_smooth_dc_cut.jpg": prog_small[:(scans[0] + scans[1]) // 2],
        "rst_missing.jpg": with_rst[:big_rsts[len(big_rsts) // 2]]
        + with_rst[big_rsts[len(big_rsts) // 2] + 2:],
        "rst_renumbered.jpg": small_rst[:cut_rst + 1]
        + bytes([0xD0 + (small_rst[cut_rst + 1] - 0xCF) % 8])
        + small_rst[cut_rst + 2:],
        "rst_earlier.jpg": small_rst[:earlier + 1]
        + bytes([0xD0 + (small_rst[earlier + 1] - 0xD1) % 8])
        + small_rst[earlier + 2:],
        "stray_bytes.jpg": small_gray[:dqt] + b"\x00\x11\xff\x00"
        + small_gray[dqt:sos] + b"\x22" + small_gray[sos:-2] + b"\x33\x44"
        + small_gray[-2:],
        "png_as.jpg": png.tobytes(),
        # the luma plane at a quarter of the size blown up 4 x 4, so that
        # the lossless file stays small
        "lossless_gray.jpg": lossless_gray(np.repeat(np.repeat(
            bgr[::4, ::4, 1], 4, axis=0), 4, axis=1), predictor=4,
            restart=640 * 60),
    }


def digest(gray: np.ndarray) -> dict | None:
    """Shape and sha256 of an image; None where cv2 returned None (a
    colour read of a lossless file)."""
    if gray is None:
        return None
    return {"shape": list(gray.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(gray).tobytes())
            .hexdigest()}


def main() -> None:
    import cv2

    DIR.mkdir(parents=True, exist_ok=True)
    digests, colour = {}, {}
    for name, data in fixtures().items():
        (DIR / name).write_bytes(data)
        digests[name] = digest(cv2.imread(str(DIR / name),
                                          cv2.IMREAD_GRAYSCALE))
        colour[name] = digest(cv2.imread(str(DIR / name)))
    digests[COLOUR] = colour
    (DIR / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
