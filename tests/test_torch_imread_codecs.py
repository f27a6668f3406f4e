"""``cv2.imread`` for the files OpenCV reads with its own code, byte for
byte, gray and colour, through the port's signature dispatch
(``spnerf_tpu_torch/data/imread.py``): BMP, Sun raster, PAM, PFM,
Radiance HDR and GIF (``data/{bmp,sunras,pam,pfm,hdr,gif}.py``).

Files cv2 encodes, files the test-only writers of ``_image_writers.py``
write in every variant the decoders read, and at least 500 files a codec
mutated in header and data from a seed: each gives cv2's image, or raises
``signature.Unreadable`` where ``cv2.imread`` returns None (or raises,
for a size past its limits). The one known deviation (ROADMAP Queue 3):
a PAM colour read of gray + alpha or RGB + alpha, and a gray read of RGB
+ alpha at most widths, where cv2 leaves bytes of its image unwritten;
the port writes the rest as cv2 does and those bytes 0
(``test_pam_bytes_cv2_leaves_unwritten``), and the fuzzing skips them.
The committed fixtures are held to their digests in
``test_torch_imread_formats.py``.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

import _image_writers as w
from spnerf_tpu_torch.data import imread, pam, signature

READS = ((cv2.IMREAD_GRAYSCALE, imread.read_gray),
         (cv2.IMREAD_COLOR, lambda p: imread.read_rgb(p)[..., ::-1]))


def _noise(seed, shape, channels=3):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (channels,),
                                        np.uint8), (5, 5), 0)
    return img.reshape(shape + (channels,))


def _cv2(path: Path, flag: int):
    """``cv2.imread``; None where it returns None or raises."""
    try:
        return cv2.imread(str(path), flag)
    except cv2.error:
        return None


def _same_as_cv2(path: Path, skip=()) -> None:
    """``imread`` of ``path`` equals ``cv2.imread``, gray and colour
    (the flags in ``skip`` not compared); where cv2 gives None, the port
    raises ``Unreadable``."""
    for flag, read in READS:
        if flag in skip:
            continue
        want = _cv2(path, flag)
        if want is None:
            with pytest.raises(signature.Unreadable,
                               match="cv2.imread does not"):
                read(path)
            continue
        got = read(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def _write(tmp_path, name, data) -> Path:
    path = tmp_path / name
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("ext,channels", [
    (ext, channels)
    for ext in (".bmp", ".gif", ".ras", ".hdr", ".pam", ".pfm")
    for channels in (1, 3) if (ext, channels) != (".gif", 1)])
def test_files_cv2_writes_whatever_their_name(tmp_path, ext, channels):
    """What ``cv2.imencode`` writes of a gray and a colour image (no gray
    GIF: its encoder asserts on one), named ``.jpg``: the signature picks
    the decoder."""
    img = _noise(len(ext), (37, 53))[..., :channels]
    if ext in (".hdr", ".pfm"):
        img = img.astype(np.float32) / 200
    ok, buf = cv2.imencode(ext, img.squeeze())
    assert ok
    path = _write(tmp_path, "named.jpg", buf.tobytes())
    assert imread.format_of(buf.tobytes()) == {
        ".ras": "sunras"}.get(ext, ext[1:])
    _same_as_cv2(path)


# --------------------------------------------------------------------- BMP


def _bmp_pixels(rng, width, height, bits):
    if bits <= 8:
        return w.bmp_rows(rng.integers(0, 1 << bits, (height, width)), bits)
    return w.bmp_rows(rng.integers(0, 256, (height, width * bits // 8)), 8)


@pytest.mark.parametrize("header", [12, 40, 52, 56, 108, 124])
@pytest.mark.parametrize("bits", [1, 4, 8, 16, 24, 32])
def test_bmp_headers_and_depths(tmp_path, header, bits):
    """Every info header size at every depth, widths 1-13 (rows padded to
    4 bytes), full and short palettes, gray and colour ones (a gray
    palette makes OpenCV's decoder one-channel), bottom-up and top-down;
    an OS/2 file has no 16 bits, which cv2 refuses."""
    rng = np.random.default_rng(header * 100 + bits)
    for width in (1, 3, 13):
        for height, colours, gray in ((5, 0, False), (-4, 0, True),
                                      (3, 2, False)):
            if header == 12 and (height < 0 or colours):
                continue
            n = colours or 1 << bits if bits <= 8 else 0
            table = rng.integers(0, 256, (n, 3))
            if gray:
                table[:] = table[:, :1]
            data = w.bmp(width, height, bits, _bmp_pixels(
                rng, width, abs(height), bits),
                palette=w.palette(table, 3 if header == 12 else 4),
                header_size=header, colours=colours)
            _same_as_cv2(_write(tmp_path, f"{width}_{height}.bmp", data))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", range(4))
def test_bmp_run_lengths(tmp_path, bits, seed):
    """``BI_RLE8`` / ``BI_RLE4``: runs, literal runs padded to 16 bits,
    end of line, deltas, end of bitmap (RLE8 fills what it skips with
    entry 0; RLE4 ends only the row, so the file is cut for cv2), a run
    past its row, top-down files, and every cut of the data."""
    rng = np.random.default_rng(seed + bits)
    width, height = int(rng.integers(1, 40)), int(rng.integers(1, 9))
    index = rng.integers(0, 1 << bits, (height, width))
    table = w.palette(rng.integers(0, 256, (1 << bits, 3)))
    compression = 1 if bits == 8 else 2
    for escapes in (False, True):
        runs = w.rle(index, bits, rng, escapes)
        for h in (height, -height):
            data = w.bmp(width, h, bits, runs, compression, table)
            _same_as_cv2(_write(tmp_path, f"r{escapes}{h}.bmp", data))
    past = bytes([width + 1, 3]) + b"\0\1"
    _same_as_cv2(_write(tmp_path, "past.bmp", w.bmp(
        width, height, bits, past, compression, table)))
    data = w.bmp(width, height, bits, runs, compression, table)
    for cut in range(len(data) - len(runs), len(data), 3):
        _same_as_cv2(_write(tmp_path, f"c{cut}.bmp", data[:cut]))


@pytest.mark.parametrize("masks", [
    (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF00, 0xF0, 0xF),
    (0xFF0000, 0xFF00, 0xFF), (0x3FF00000, 0xFFC00, 0x3FF),
    (0xFF, 0xFF00, 0xFF0000), (0, 0xFF00, 0xFF),
    (0xF0F00000, 0xFFFF, 0x80000000)])
@pytest.mark.parametrize("header", [40, 52, 56, 108, 124])
def test_bmp_bitfields(tmp_path, masks, header):
    """``BI_BITFIELDS``: 16 bits takes 5-6-5 or 5-5-5 masks read after the
    whole info header and refuses others; 32 bits drops its fourth byte,
    or, from a 56-byte header on, scales each field of nonzero header
    masks to 0-255 in float32 and truncates (gray from those bytes in
    float32)."""
    rng = np.random.default_rng(header + sum(masks) % 1000)
    packed = np.array(masks, "<u4").tobytes()
    for bits in (16, 32):
        for where in ("after", "inside", "both"):
            data = w.bmp(
                7, 3, bits, _bmp_pixels(rng, 7, 3, bits), 3,
                header_size=header,
                header_extra=packed + b"\0\0\0\xff" if where != "after"
                else b"",
                after_header=packed if where != "inside" else b"")
            _same_as_cv2(_write(tmp_path, f"{bits}{where}.bmp", data))


def test_bmp_headers_cv2_refuses(tmp_path):
    """Compression 4 and 5, a header size of 16, a negative offset, a zero
    width, 256+ colours, a cut palette, and an offset past the pixels."""
    rng = np.random.default_rng(9)
    pixels = _bmp_pixels(rng, 5, 4, 8)
    table = w.palette(rng.integers(0, 256, (256, 3)))
    cases = [w.bmp(5, 4, 8, pixels, 4, table), w.bmp(5, 4, 24, pixels, 5),
             w.bmp(5, 4, 8, pixels, palette=table, header_size=16),
             w.bmp(5, 4, 8, pixels, palette=table, offset=-5),
             w.bmp(0, 4, 8, pixels, palette=table),
             w.bmp(5, 4, 8, pixels, palette=table, colours=300),
             w.bmp(5, 4, 8, b"", palette=table[:100]),
             w.bmp(5, 4, 8, pixels, palette=table, offset=2000),
             w.bmp(5, 4, 8, pixels[:-1], palette=table)]
    for i, data in enumerate(cases):
        path = _write(tmp_path, f"{i}.bmp", data)
        assert _cv2(path, cv2.IMREAD_COLOR) is None, i
        _same_as_cv2(path)

# -------------------------------------------------------------- Sun raster


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sunras_types_and_depths(tmp_path, depth, kind):
    """Old and standard files at every depth, with colour maps of every
    length and none (no map: a gray read is black), rows padded to 16
    bits; the byte-encoded and RGB types, which OpenCV's header check
    compares with its image type and so refuses."""
    rng = np.random.default_rng(depth * 10 + kind)
    for width in (1, 5, 8):
        pixels = w.sunras_rows(rng.integers(0, 1 << min(depth, 8), (
            3, width if depth <= 8 else width * depth // 8)), min(depth, 8))
        if depth == 1:
            pixels = w.sunras_rows(rng.integers(0, 2, (3, width)), 1)
        maps = [b""]
        if depth <= 8:
            full = 3 << depth
            maps += [rng.integers(0, 256, n, np.uint8).tobytes()
                     for n in (full, 3, full - 1, 7)]
            maps.append(np.repeat(rng.integers(0, 256, full // 3,
                                               np.uint8), 3).tobytes())
        for i, cmap in enumerate(maps):
            data = w.sunras(width, 3, depth, pixels, kind, cmap)
            _same_as_cv2(_write(tmp_path, f"{width}_{i}.ras", data))


def test_sunras_headers_cv2_refuses(tmp_path):
    rng = np.random.default_rng(3)
    pixels = w.sunras_rows(rng.integers(0, 256, (3, 6)), 8)
    for i, data in enumerate([
            w.sunras(6, 3, 8, pixels, colour_map=bytes(800)),
            w.sunras(6, 3, 24, pixels, colour_map=bytes(6)),
            w.sunras(6, 3, 8, pixels, map_type=2, colour_map=bytes(6)),
            w.sunras(6, 3, 16, pixels), w.sunras(0, 3, 8, pixels),
            w.sunras(6, 3, 8, pixels[:-1]),
            w.sunras(6, 3, 8, b"", colour_map=bytes(30))[:40]]):
        path = _write(tmp_path, f"{i}.ras", data)
        assert _cv2(path, cv2.IMREAD_COLOR) is None, i
        _same_as_cv2(path)

# --------------------------------------------------------------------- PAM


def _pam_partial(width: int, depth: int, maxval: int, flag: int) -> bool:
    """Whether cv2 leaves bytes of this read unwritten (``data/pam.py``)."""
    target = 1 if flag == cv2.IMREAD_GRAYSCALE else 3
    return (maxval != 1 and depth in (2, 4) and depth != target
            and 3 * -(-width // depth) < width * target)


@pytest.mark.parametrize("maxval", [1, 7, 255, 256, 1000, 65535])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_pam_depths_and_maxvals(tmp_path, depth, maxval):
    """Every DEPTH with its TUPLTYPE and without one (refused but for gray
    and RGB up to 255), maxval 1 (packed bits), 8 and 16 bits (high byte
    kept), line breaks ``\\n`` and ``\\r``, comments; the widths where cv2
    writes every byte of a read (the others are pinned below)."""
    rng = np.random.default_rng(depth * 7 + maxval)
    tupltype = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
                4: "RGB_ALPHA"}[depth]
    for width in (1, 2, 3, 5, 6, 9):
        samples = rng.integers(0, maxval + 1, (3, width, depth))
        data = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        for tt, eol, extra in ((tupltype, "\n", ""), (None, "\r", "#x\r"),
                               ("BLACKANDWHITE", "\n", "")):
            path = _write(tmp_path, f"{width}{eol == chr(13)}.pam", w.pam(
                width, 3, depth, maxval, data, tt, eol, extra))
            skip = [f for f, _ in READS if _pam_partial(width, depth, maxval,
                                                        f)]
            _same_as_cv2(path, skip)


def test_pam_bytes_cv2_leaves_unwritten(tmp_path):
    """OpenCV's ``basic_conversion`` converts ceil(WIDTH / DEPTH) pixels a
    row, three bytes each: the bytes it writes match, the ones it leaves
    hold what its heap held and are 0 in the port (ROADMAP Queue 3)."""
    rng = np.random.default_rng(1)
    for depth, tupltype in ((2, "GRAYSCALE_ALPHA"), (4, "RGB_ALPHA")):
        samples = rng.integers(0, 256, (3, 8, depth), np.uint8)
        path = _write(tmp_path, f"{depth}.pam", w.pam(
            8, 3, depth, 255, samples.tobytes(), tupltype))
        for flag, read in READS:
            if not _pam_partial(8, depth, 255, flag):
                continue
            want = _cv2(path, flag).reshape(3, -1)
            got = read(path).reshape(3, -1)
            n = 3 * -(-8 // depth)
            np.testing.assert_array_equal(got[:, :n], want[:, :n])
            assert not got[:, n:].any()


@pytest.mark.parametrize("header", [
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR \n",
    "P7\nWIDTH 04\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB  \nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL -5\nTUPLTYPE\nENDHDR\n",
    "P7\r\nWIDTH 4\r\nHEIGHT 2\r\nDEPTH 3\r\nMAXVAL 255\r\nENDHDR\r\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 0\n\n\n  ENDHDR\n",
    "P7\nWIDTH +4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 0x4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 4\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 65536\nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE rgb\nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nFOO 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\t\n",
    "P7 WIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n",
    "P7\nWIDTH -4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "P7\nWIDTH 2147483652\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n"])
def test_pam_headers(tmp_path, header):
    """OpenCV's ``ReadPAMHeaderLine`` and ``ParseInt``: a value after
    ``ENDHDR``, leading zeros, trailing blanks, ``\\r\\n`` (the ``\\n``
    then starts the samples), blank lines; ``+``, hex, duplicates, maxval
    past 65535, unknown names and tuple types, ``ENDHDR`` and a tab,
    ``P7`` and a space, a DEPTH against its TUPLTYPE, negative and huge
    sizes."""
    data = header.encode() + bytes(range(100, 124)) * 2
    _same_as_cv2(_write(tmp_path, "h.pam", data))

# --------------------------------------------------------------------- PFM


@pytest.mark.parametrize("scale", ["-1", "1", "-2.5", "0.7", "-0.003",
                                   "1e3", "inf", "0x10", "-1e-40"])
def test_pfm_scales_and_values(tmp_path, scale):
    """The scale's sign as the byte order, ``1 / |scale|`` in float32, no
    x255, halves to even, NaN, infinities and values past int32 to 0;
    a gray read of colour and a colour read of gray are cv2's None."""
    values = np.array([[0, 0.5, 1.0, 1.5, 2.5, 254.5],
                       [255.5, 256, -0.4, -0.6, 3e9, np.inf],
                       [np.nan, -np.inf, 1e-30, 0.4999999, 2**31 - 200,
                        2**31 + 1000.0]], np.float32)
    little = scale.startswith("-")
    for img in (values, np.stack([values, values * 2, values * 3], -1)):
        magic = "PF" if img.ndim == 3 else "Pf"
        data = f"{magic}\n6 3\n{scale}\n".encode() + img[::-1].astype(
            "<f4" if little else ">f4").tobytes()
        _same_as_cv2(_write(tmp_path, f"{magic}.pfm", data))


@pytest.mark.parametrize("header", [
    b"Pf\n6  3\n-1\n", b"Pf\n6\t3\n-1.0e0\n", b"Pf\n 6 3\n-1\n",
    b"Pf\n6 3\n-1", b"Pf\n6 3\n-1 ", b"Pf\n6 3\nnan\n", b"Pf\n6 3\n0\n",
    b"Pf\n6x 3\n-1\n", b"Pf\n+6 3\n-1\n", b"Pf\n6 3\n-1x\n",
    b"Pf\n6 3\n-1\n\n", b"Pf\n6 3\n-\xc01\n", b"Pf\n6 3\n-1\x00",
    b"Pf\n-6 3\n-1\n", b"Pf 6 3\n-1\n", b"Pf\r6 3\n-1\n",
    b"Pf\n6 3\n-" + b"1" * 3000 + b"\n"])
def test_pfm_headers(tmp_path, header):
    """OpenCV's ``read_number``: one whitespace byte ends a token (so two
    spaces make an empty height), ``atoi`` / ``atof`` parse it, a byte
    past 127 is an error, a token stops after 2,048 bytes."""
    values = np.arange(18, dtype=np.float32).reshape(3, 6)
    _same_as_cv2(_write(tmp_path, "h.pfm", header + values[::-1].astype(
        "<f4").tobytes()))

# ------------------------------------------------------------ Radiance HDR


@pytest.mark.parametrize("width", [1, 7, 8, 9, 40, 300])
def test_hdr_scanlines(tmp_path, width):
    """Run-length scanlines where the width is 8 to 32,767 (runs and
    literals cut at random), flat ones otherwise and after the first flat
    scanline, old-style runs read as pixels, exponents from 0 to 255
    (8-bit saturation, and 0 past int32), every cut of the data, a bad
    run count; a gray read converts the 8-bit colour with ``cvtColor``'s
    15-bit weights."""
    rng = np.random.default_rng(width)
    quads = rng.integers(0, 256, (3, width, 4), np.uint8)
    quads[..., :3] //= 32
    quads[..., :3] *= 32
    quads[..., 3] = rng.integers(120, 145, (3, width))
    quads[0, 0, 3] = 0
    quads[-1, -1] = [1, 1, 1, 3]
    quads[1, 0, 3] = 255
    for run_length in (True, False):
        data = w.hdr(quads, run_length, rng=rng)
        _same_as_cv2(_write(tmp_path, f"{run_length}.hdr", data))
    mixed = w.hdr(quads[:1], rng=rng) + quads[1:].tobytes()
    _same_as_cv2(_write(tmp_path, "mixed.hdr", mixed))
    for cut in range(len(data) - 40, len(data), 7):
        _same_as_cv2(_write(tmp_path, f"c{cut}.hdr", data[:cut]))
    if width >= 8:
        bad = bytearray(w.hdr(quads, rng=rng))
        bad[bad.index(b"\x02\x02") + 4] = 0  # a zero count
        _same_as_cv2(_write(tmp_path, "bad.hdr", bytes(bad)))


@pytest.mark.parametrize("header", [
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RGBE\nGAMMA=2.2\nEXPOSURE=4\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nfoo\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\n\0\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\n" + b"X" * 127 + b"\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 4 -Y 1\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y1+X4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n -Y 1 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 4" + b" " * 200 + b"\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4294967297 +X 4\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y -1 +X 4\n",
    b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 1 +X 4\r\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n-Y 1 +X 4\n"])
def test_hdr_headers(tmp_path, header):
    """Ward's header as OpenCV's ``rgbe.cpp`` reads it, by ``fgets`` into
    128 bytes and ``sscanf("-Y %d +X %d")``: only
    ``FORMAT=32-bit_rle_rgbe``, an empty line ends the header (a NUL
    byte does not), no other orientation."""
    pixels = bytes([128, 64, 32, 129, 255, 255, 255, 128, 1, 2, 3, 100,
                    0, 0, 0, 0])
    _same_as_cv2(_write(tmp_path, "h.hdr", header + pixels))

# --------------------------------------------------------------------- GIF


@pytest.mark.parametrize("min_size", [2, 3, 4, 7, 8, 9, 11])
def test_gif_code_sizes(tmp_path, min_size):
    """Minimum code sizes 2-11 (an index past 255 keeps its low byte),
    codes up to 12 bits, deferred and early clear codes, sub-blocks of 1
    to 255 bytes, interlaced and not."""
    rng = np.random.default_rng(min_size)
    n = 1 << min_size
    table = rng.integers(0, 256, (256, 3), np.uint8)
    for shape, clear_at in (((9, 13), 4096), ((90, 130), 4096),
                            ((90, 130), 4095), ((40, 50), n + 9)):
        index = rng.integers(0, n, shape)
        index[: shape[0] // 2] //= 7
        for interlace in (False, True):
            data = w.gif(shape[1], shape[0], [w.gif_frame(
                index, interlace=interlace, min_size=min_size,
                block=int(rng.integers(1, 256)), clear_at=clear_at)], table)
            _same_as_cv2(_write(tmp_path, f"{interlace}.gif", data))


def test_gif_canvas_and_tables(tmp_path):
    """The first frame on its canvas: the global table's background
    colour (black without one), transparency by the last Graphic Control
    Extension (the canvas shows), local tables falling back on the global
    one, the default table where there is none (gray i, index 1 white),
    every disposal method, GIF87a; an index past the tables, a background
    past the global table, a disposal past 3 and a frame outside the
    screen are cv2's None."""
    pal = (np.arange(24).reshape(8, 3) * 10 + 5).astype(np.uint8)
    index = np.array([[0, 1, 2], [3, 2, 1]])
    cases = [w.gif(5, 4, [w.gif_frame(index, 1, 1)], pal[:4], 2),
             w.gif(5, 4, [w.gif_frame(index, 1, 1)], None, 2)]
    for disposal in range(8):
        cases.append(w.gif(5, 4, [w.gif_frame(index, 1, 1, control={
            "disposal": disposal, "transparent": 1})], pal[:4], 2))
    cases += [
        w.gif(3, 2, [w.gif_frame(index, local_table=pal[4:6])], pal[:4]),
        w.gif(3, 2, [w.gif_frame(index, local_table=pal[4:6], control={
            "transparent": 3})], pal[:4]),
        w.gif(3, 2, [w.gif_frame(index, control={"transparent": 1})], None),
        w.gif(3, 2, [w.gif_frame(np.arange(64).reshape(8, 8) % 64)],
              None),
        w.gif(3, 2, [w.gif_frame(index)], pal[:4], version=b"GIF87a"),
        w.gif(3, 2, [w.gif_frame(index + 2, min_size=3)], pal[:4]),
        w.gif(3, 2, [w.gif_frame(index + 2, min_size=3, control={
            "transparent": 5})], pal[:4]),
        w.gif(3, 2, [w.gif_frame(index)], pal[:4], background=4),
        w.gif(3, 2, [w.gif_frame(index, left=1)], pal[:4]),
        w.gif(3, 2, [w.gif_frame(index), w.gif_frame(index, left=2)],
              pal[:4]),
        w.gif(3, 2, [b"\x21\xf9\x04\x01\x00\x00\x01\x00\x21\xf9\x04\x00\x00"
                     b"\x00\x02\x00" + w.gif_frame(index)], pal[:4]),
        w.gif(3, 2, [b"\x21\xf9\x05\x01\x00\x00\x01\x00\x00"
                     + w.gif_frame(index)], pal[:4])]
    for i, data in enumerate(cases):
        _same_as_cv2(_write(tmp_path, f"{i}.gif", data))


def test_gif_structure(tmp_path):
    """OpenCV walks every block to the trailer first: extensions of every
    kind, NETSCAPE2.0's loop count (after another application name it
    reads two bytes of a 3-byte sub-block and the third as the next
    length), an unknown block, a cut file, no trailer, bytes after it, no
    image."""
    pal = (np.arange(12).reshape(4, 3) * 20 + 10).astype(np.uint8)
    frame = w.gif_frame(np.array([[0, 1, 2], [3, 2, 1]]))
    app = b"\x21\xff\x0b"
    cases = [
        w.gif(3, 2, [frame], pal, extensions=b"\x21\xfe\x05hello\x00"),
        w.gif(3, 2, [frame], pal, extensions=b"\x21\x99\x02ab\x00"),
        w.gif(3, 2, [frame], pal, extensions=b"\x21\x01\x0c" + bytes(12)
              + b"\x02ab\x00"),
        w.gif(3, 2, [frame], pal, extensions=app + b"NETSCAPE2.0\x03\x02"
              b"\x00\x00\x00"),
        w.gif(3, 2, [frame], pal, extensions=app + b"XMP DataXMP\x05hello"
              b"\x00"),
        w.gif(3, 2, [frame], pal, extensions=app + b"ANIMEXTS1.0\x03\x01"
              b"\x00\x00\x00"),
        w.gif(3, 2, [frame, app + b"XXXXXXXX1.0\x03\xaa\xbb\x00" + frame],
              pal),
        w.gif(3, 2, [app + b"XXXXXXXX1.0\x03\xaa\xbb\x00" + frame], pal),
        w.gif(3, 2, [frame, b"\x99"], pal), w.gif(3, 2, [frame], pal,
                                                    trailer=False),
        w.gif(3, 2, [frame], pal) + b"garbage", w.gif(3, 2, [], pal)]
    whole = w.gif(3, 2, [frame, frame], pal)
    cases += [whole[:cut] for cut in range(13, len(whole), 5)]
    for i, data in enumerate(cases):
        _same_as_cv2(_write(tmp_path, f"{i}.gif", data))


def test_gif_lzw_edges(tmp_path):
    """OpenCV's ``lzwDecode`` on code streams no encoder writes: no
    clear code first, an end code early or mid-stream (decoding goes on),
    codes after a full frame (allowed only as the last of the data),
    a string past the frame, a code past the table, padding bits, codes
    in the table-full state."""
    rng = np.random.default_rng(4)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    index = rng.integers(0, 4, (6, 9))
    seq = index.reshape(-1)
    full = w.lzw(seq, 2)
    streams = [full[1:], w.lzw(seq[:13], 2), w.lzw(seq, 2, end=False),
               w.lzw(seq[:13], 2) + w.lzw(seq[13:], 2)[1:],
               w.lzw(seq[:30], 2) + w.lzw(seq[30:], 2),
               full + [(1, 3), (2, 3)], full[:-1] + [(0, 4)] * 3,
               full[:5] + [(5, full[5][1])] + full[5:],
               [(4, 3), (6, 3), (5, 3)], [(4, 3), (0, 3), (1, 3), (7, 3)],
               w.lzw(np.concatenate([seq, seq[:3]]), 2)]
    for i, codes in enumerate(streams):
        for extra in (b"", b"\0", b"\xff\xff"):
            data = w.gif(9, 6, [w.gif_frame(index, data=w.pack(codes)
                                            + extra)], pal[:4])
            _same_as_cv2(_write(tmp_path, f"{i}.gif", data))
    big = rng.integers(0, 256, (90, 100))
    for clear_at in (99999, 4096, 4095):
        data = w.gif(100, 90, [w.gif_frame(big, min_size=8,
                                           clear_at=clear_at)], pal)
        _same_as_cv2(_write(tmp_path, f"full{clear_at}.gif", data))

# ----------------------------------------------------------------- fuzzing


def _mutate(data: bytes, rng, header: int) -> bytes:
    """1-3 bytes changed, in the first ``header`` bytes or anywhere, and
    the file cut at a random point one time in four."""
    out = bytearray(data)
    kind = int(rng.integers(0, 4))
    for _ in range(1 + int(rng.integers(0, 3))):
        span = min(len(out), header) if kind == 0 else len(out)
        out[int(rng.integers(0, span))] = int(rng.integers(0, 256))
    if kind == 3:
        out = out[:int(rng.integers(1, len(out) + 1))]
    return bytes(out)


def _bmp_case(rng):
    bits = int(rng.choice([1, 4, 8, 16, 24, 32, 4, 8]))
    width, height = int(rng.integers(1, 14)), int(rng.integers(1, 6))
    compression = 0
    if bits in (4, 8) and rng.random() < 0.5:
        compression = 2 if bits == 4 else 1
    if bits in (16, 32) and rng.random() < 0.4:
        compression = 3
    header = int(rng.choice([40, 40, 12, 52, 56, 108, 124]))
    if header == 12 and (compression or bits == 16):
        header = 40
    table, colours = b"", 0
    if bits <= 8:
        n = 1 << bits
        if header != 12 and rng.random() < 0.3:
            n = colours = int(rng.integers(1, n + 1))
        table = w.palette(rng.integers(0, 256, (n, 3)),
                          3 if header == 12 else 4)
    extra = after = b""
    if compression == 3:
        masks = [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F),
                 (0xFF0000, 0xFF00, 0xFF)][int(rng.integers(0, 3))]
        after = np.array(masks, "<u4").tobytes()
        if bits == 32 and header >= 56:
            extra = rng.integers(0, 2**32, 4, np.uint64).astype(
                "<u4").tobytes()
    if compression in (1, 2):
        pixels = w.rle(rng.integers(0, 1 << bits, (height, width)), bits,
                       rng, bool(rng.random() < 0.5))
    else:
        pixels = _bmp_pixels(rng, width, height, bits)
    if header != 12 and rng.random() < 0.25:
        height = -height
    data = w.bmp(width, height, bits, pixels, compression, table, header,
                 colours, extra, after)
    return data, 54


def _sunras_case(rng):
    depth = int(rng.choice([1, 8, 24, 32]))
    width, height = int(rng.integers(1, 12)), int(rng.integers(1, 5))
    cmap = b""
    if depth <= 8 and rng.random() < 0.6:
        cmap = rng.integers(0, 256, int(rng.integers(1, (3 << depth) + 1)),
                            np.uint8).tobytes()
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    pixels = rng.integers(0, 256, pitch * height, np.uint8).tobytes()
    return w.sunras(width, height, depth, pixels,
                    int(rng.choice([0, 1, 1, 2, 3])), cmap), 32


def _pam_case(rng):
    depth, width = int(rng.integers(1, 5)), int(rng.integers(1, 10))
    height, maxval = int(rng.integers(1, 5)), int(rng.choice(
        [1, 255, 100, 1000, 65535, 256]))
    tupltype = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
                4: "RGB_ALPHA"}[depth] if rng.random() < 0.5 else None
    samples = rng.integers(0, 256, width * height * depth
                           * (2 if maxval > 255 else 1), np.uint8)
    data = w.pam(width, height, depth, maxval, samples.tobytes(), tupltype,
                 str(rng.choice(["\n", "\r"])))
    return data, len(data) - samples.size


def _pfm_case(rng):
    shape = (int(rng.integers(1, 6)), int(rng.integers(1, 7)))
    if rng.random() < 0.5:
        shape += (3,)
    values = rng.standard_normal(shape) * rng.choice([1, 100, 1e10])
    return w.pfm(values, float(rng.choice([-1, 1, -2.5, 0.7, -0.003]))), 12


def _hdr_case(rng):
    width, height = int(rng.choice([1, 3, 7, 8, 9, 12, 20, 40])), \
        int(rng.integers(1, 4))
    quads = rng.integers(0, 256, (height, width, 4), np.uint8)
    if rng.random() < 0.5:
        quads[..., :3] = quads[..., :3] // 32 * 32
    quads[..., 3] = rng.integers(120, 145, (height, width))
    data = w.hdr(quads, bool(rng.random() < 0.7), str(rng.choice(
        ["RADIANCE", "RGBE"])), rng=rng)
    return data, data.index(b"+X") + 6


def _gif_case(rng):
    width, height = int(rng.integers(1, 20)), int(rng.integers(1, 12))
    table = None
    if rng.random() < 0.8:
        table = rng.integers(0, 256, (2 << int(rng.integers(0, 8)), 3),
                             np.uint8)
    frames = []
    for _ in range(int(rng.integers(1, 3))):
        fw, fh = int(rng.integers(1, width + 1)), int(rng.integers(
            1, height + 1))
        local = None
        if rng.random() < 0.3 or table is None and rng.random() < 0.7:
            local = rng.integers(0, 256, (2 << int(rng.integers(0, 8)), 3),
                                 np.uint8)
        n = len(local if local is not None else table if table is not None
                else range(256))
        min_size = max(2, (n - 1).bit_length())
        index = rng.integers(0, n, (fh, fw))
        control = None
        if rng.random() < 0.5:
            control = {"disposal": int(rng.integers(0, 4)),
                       "transparent": int(rng.integers(0, n))
                       if rng.random() < 0.6 else None}
        frames.append(w.gif_frame(
            index, int(rng.integers(0, width - fw + 1)),
            int(rng.integers(0, height - fh + 1)), local,
            bool(rng.random() < 0.3), min_size, control,
            block=int(rng.integers(1, 256))))
    background = int(rng.integers(0, len(table) if table is not None
                                  else 256))
    return w.gif(width, height, frames, table, background), 13 + int(
        rng.integers(0, 60))


CASES = {"bmp": _bmp_case, "sunras": _sunras_case, "pam": _pam_case,
         "pfm": _pfm_case, "hdr": _hdr_case, "gif": _gif_case}


@pytest.mark.parametrize("codec", sorted(CASES))
def test_fuzzed_files(tmp_path, codec):
    """600 files a codec from a seed, every other one with bytes of its
    header or data changed or cut: the port gives cv2's image or raises
    ``Unreadable`` where cv2 gives None; for PAM, the reads cv2 leaves
    partly unwritten are not compared (pinned above)."""
    rng = np.random.default_rng(sorted(CASES).index(codec))
    refused = 0
    for i in range(600):
        data, header = CASES[codec](rng)
        if i % 2:
            data = _mutate(data, rng, header)
        path = _write(tmp_path, f"f{i}.jpg", data)
        skip = ()
        if codec == "pam":
            try:
                width, _, depth, maxval, _, _ = pam._header(data, "f")
                skip = [f for f, _ in READS
                        if _pam_partial(width, depth, maxval, f)]
            except signature.Unreadable:
                pass
        _same_as_cv2(path, skip)
        refused += _cv2(path, cv2.IMREAD_COLOR) is None
    assert 30 < refused < 570, refused  # both outcomes are exercised
