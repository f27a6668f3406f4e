"""``cv2.imread`` for every JPEG, PNG and PNM file it reads, byte for
byte, gray and colour, through the port's signature dispatch
(``spnerf_tpu_torch/data/imread.py``):

- the committed fixtures of ``tests/data/{jpeg,png,pnm}`` and of OpenCV's
  own six decoders, ``tests/data/{bmp,sunras,pam,pfm,hdr,gif}``, against
  their digests (and the test process's cv2 against them; the six are
  tested further in ``test_torch_imread_codecs.py``);
- the decoder chosen by the file's first bytes, not its name (a PNG named
  ``.jpg``, a JPEG named ``.png``); the formats cv2 decodes through
  libraries of their own (TIFF, WebP, JPEG 2000, AVIF) raise
  ``NotPorted`` naming ROADMAP Queue 1 item 7; bytes no decoder claims
  raise ``Unreadable`` beside cv2's None;
- JPEG: block-smoothed progressive files (cut inside and between scans,
  short scan scripts), libjpeg's marker recovery (missing, renumbered and
  earlier restart markers, stray bytes), RGB-coded colour, arithmetic
  coding (transcoded by ``tests/_jpeg_writers.py``: sequential and
  progressive, restart intervals, DAC conditioning, cut progressive
  files), and the kinds cv2 refuses pinned beside its None;
- PNG: gray at 1, 2 and 4 bits, palettes with and without ``tRNS``, gray
  + alpha, 16-bit samples, ``tRNS`` colour keys, Adam7, ``gAMA`` /
  ``sRGB`` in gray reads, ``eXIf`` orientations;
- PNM: P1-P6, maxvals, 16-bit samples, comments, cut files;
- the loaders of both packages (COCO, ``NeRFDataset``,
  ``eval/pose.load_gray``) over one folder of mixed, misnamed files, one
  of each of the nine formats.
"""

import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from _image_fixtures import adam7, exif_orientation, with_chunk
from _jpeg_fixtures import COLOUR, digest
import _image_writers as writers
from _jpeg_writers import (arithmetic, baseline_coefficients, lossless,
                           lossless_gray)
from spnerf_tpu_torch.data import imread, jpeg, signature

DATA = Path(__file__).resolve().parent / "data"


def _noise(seed, shape, channels=3):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (channels,),
                                        np.uint8), (5, 5), 0)
    return img.reshape(shape + (channels,))


def _same_as_cv2(path: Path, damaged: bool = False) -> None:
    """``imread`` of ``path`` equals ``cv2.imread``, gray and colour; for
    a ``damaged`` file cv2 may return None, and the port must raise."""
    for flag, read in ((cv2.IMREAD_GRAYSCALE, imread.read_gray),
                       (cv2.IMREAD_COLOR,
                        lambda p: imread.read_rgb(p)[..., ::-1])):
        want = cv2.imread(str(path), flag)
        if want is None and damaged:
            with pytest.raises(ValueError):
                read(path)
            continue
        assert want is not None, path
        got = read(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def _write(tmp_path, name, data) -> Path:
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _jpeg(img, quality=85, *extra) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality]
                           + list(extra))
    assert ok
    return buf.tobytes()


def _pil_jpeg(img, **kw) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", **kw)
    return out.getvalue()


def _markers(data: bytes, codes) -> list:
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] in codes]


# ---------------------------------------------------------------- fixtures


@pytest.mark.parametrize("folder", ["jpeg", "png", "pnm", "bmp", "sunras",
                                    "pam", "pfm", "hdr", "gif"])
def test_fixtures_equal_their_digests(folder):
    """Every committed fixture through ``imread`` (so misnamed files go
    through the signature dispatch) to the digests cv2 gave, gray and
    colour; the test process's cv2 gives them too. A null digest is
    cv2's None (a colour read of a lossless JPEG, a gray read of a colour
    PFM), for which the port raises ``Unreadable``."""
    digests = json.loads((DATA / folder / "digests.json").read_text())
    colour = digests.pop(COLOUR)
    files = sorted(p.name for p in (DATA / folder).iterdir()
                   if p.name != "digests.json")
    assert files == sorted(digests) == sorted(colour)
    for name in files:
        path = DATA / folder / name
        for want, flag, read in (
                (digests[name], cv2.IMREAD_GRAYSCALE, imread.read_gray),
                (colour[name], cv2.IMREAD_COLOR,
                 lambda p: imread.read_rgb(p)[..., ::-1])):
            if want is None:  # cv2's read is None
                assert cv2.imread(str(path), flag) is None, name
                with pytest.raises(signature.Unreadable):
                    read(path)
                continue
            assert digest(read(path)) == want, name
            assert digest(cv2.imread(str(path), flag)) == want, name


# --------------------------------------------------------------- dispatch


@pytest.mark.parametrize("kind,name", [("png", "a.jpg"), ("jpeg", "b.png"),
                                       ("pnm", "c.jpg"), ("png", "d"),
                                       ("jpeg", "e.JPEG.bak")])
def test_the_signature_chooses_the_decoder(tmp_path, kind, name):
    img = _noise(len(name), (29, 43))
    ext = {"png": ".png", "jpeg": ".jpg", "pnm": ".ppm"}[kind]
    ok, buf = cv2.imencode(ext, img)
    assert ok
    path = _write(tmp_path, name, buf.tobytes())
    assert imread.format_of(path.read_bytes()) == kind
    _same_as_cv2(path)


@pytest.mark.parametrize("ext", [".tif", ".webp", ".avif", ".jp2"])
def test_formats_only_cv2_decodes_raise_not_ported(tmp_path, ext):
    """cv2 reads the file through a library of its own; the port names
    ROADMAP Queue 1 item 7, whatever the file is called (64 x 96: OpenJPEG
    writes no smaller file at its default resolutions)."""
    img = _noise(3, (64, 96))
    ok, buf = cv2.imencode(ext, img)
    assert ok
    path = _write(tmp_path, "named.jpg", buf.tobytes())
    assert cv2.imread(str(path)) is not None
    for read in (imread.read_gray, imread.read_rgb):
        with pytest.raises(signature.NotPorted, match="Queue 1 item 7"):
            read(path)
    with pytest.raises(NotImplementedError, match="named.jpg"):
        imread.read_gray(path)


def test_other_signatures():
    """The signatures cv2 5.0's codecs claim that no encoder here writes."""
    cases = {b"\0\0\0\x0cjP  \r\n\x87\n": "jpeg2000",
             b"\xff\x4f\xff\x51\0": "jpeg2000", b"PF\n2 2\n": "pfm",
             b"Pf 2 2": "pfm", b"MM\0*\0\0": "tiff", b"GIF87a": "gif",
             b"#?RGBE\n": "hdr", b"P7\nWIDTH": "pam", b"P5\n1 1": "pnm",
             b"\x89PNG\r\n\x1a\n": "png", b"\xff\xd8\xff": "jpeg",
             b"P5x": None, b"\xff\xd8": None, b"": None, b"hello": None}
    for head, kind in cases.items():
        assert signature.kind(head) == kind, head


@pytest.mark.parametrize("data", [b"", b"hello, world", b"\xff\xd8",
                                  b"P9\n1 1\n"])
def test_bytes_no_decoder_claims_are_unreadable(tmp_path, data):
    path = _write(tmp_path, "x.jpg", data)
    assert cv2.imread(str(path)) is None
    for read in (imread.read_gray, imread.read_rgb):
        with pytest.raises(signature.Unreadable, match="cv2.imread does not"):
            read(path)
    with pytest.raises(FileNotFoundError):
        imread.read_gray(tmp_path / "missing.jpg")


# ------------------------------------------------------------------- JPEG


@pytest.mark.parametrize("seed,shape,encoder", [
    (0, (64, 96), "cv2"), (1, (37, 53), "pil420"), (2, (16, 16), "pilgray"),
    (3, (75, 41), "pil444"), (4, (9, 130), "cv2"), (5, (3, 2), "cv2")])
def test_block_smoothing(tmp_path, seed, shape, encoder):
    """Progressive files cut between scans and inside them (coefficients
    1-9 not all sent): libjpeg-turbo's block smoothing, with its 5 x 5 DC
    neighbourhood and the previous scan's state past the cut."""
    img = _noise(seed, shape)
    if encoder == "cv2":
        data = _jpeg(img, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    else:
        data = _pil_jpeg(img[..., 0] if encoder == "pilgray" else img,
                         quality=80, progressive=True,
                         subsampling=0 if encoder == "pil444" else 2)
    scans = _markers(data, (0xDA,))
    cuts = [s for s in scans[1:]] + [
        int(len(data) * f) for f in (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)]
    for cut in cuts:
        _same_as_cv2(_write(tmp_path, f"cut{cut}.jpg", data[:cut]), True)
    # a scan script that stops early, the file ending in its EOI
    for s in scans[1::2]:
        _same_as_cv2(_write(tmp_path, f"short{s}.jpg",
                            data[:s] + b"\xff\xd9"))


@pytest.mark.parametrize("damage", ["delete", "stray", "eoi", "invalid",
                                    *(f"distance{d}" for d in range(1, 8))])
@pytest.mark.parametrize("progressive", [False, True])
def test_restart_marker_recovery(tmp_path, capfd, damage, progressive):
    """A restart marker missing, renumbered by each distance, preceded by
    stray bytes, replaced by EOI or by an invalid marker code: libjpeg's
    next_marker and jpeg_resync_to_restart, one warning on stderr."""
    img = _noise(7, (48, 67))
    data = (_pil_jpeg(img, quality=80, progressive=True,
                      restart_marker_blocks=3) if progressive
            else _jpeg(img, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    rsts = _markers(data, range(0xD0, 0xD8))
    for i in rsts[len(rsts) // 4::max(1, len(rsts) // 3)]:
        n = data[i + 1] - 0xD0
        if damage == "delete":
            bad = data[:i] + data[i + 2:]
        elif damage == "stray":
            bad = data[:i] + b"\x12\xff\x00\x34" + data[i:]
        elif damage == "eoi":
            bad = data[:i + 1] + b"\xd9" + data[i + 2:]
        elif damage == "invalid":
            bad = data[:i + 1] + b"\x05" + data[i + 2:]
        else:
            d = int(damage[-1])
            bad = data[:i + 1] + bytes([0xD0 + (n + d) % 8]) + data[i + 2:]
        path = _write(tmp_path, f"r{i}.jpg", bad)
        capfd.readouterr()
        _same_as_cv2(path)
        if damage != "distance8":
            assert capfd.readouterr().err.count("jpeg: ") == 2  # gray, colour


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restart",
                                  "pil_restart", "arithmetic"])
def test_corrupted_bytes(tmp_path, kind):
    """Bytes after the first scan header changed (a later header, a
    stuffed FF 00 turned into a marker, garbage coefficients past 16 bits
    once dequantized, bad Huffman codes), some files cut too: libjpeg's
    header checks, its 17-bit bad codes, and its SIMD inverse DCT's
    wrapping and saturating, as the port's copies of them."""
    rng = np.random.default_rng(len(kind))
    for seed in range(8):
        img = _noise(seed, (int(rng.integers(8, 48)), int(rng.integers(8, 72))))
        quality = int(rng.integers(5, 100))
        if kind == "pil_restart":
            data = _pil_jpeg(img, quality=quality, progressive=True,
                             restart_marker_blocks=2)
        else:
            data = _jpeg(img, quality, cv2.IMWRITE_JPEG_PROGRESSIVE,
                         int(kind == "progressive"),
                         cv2.IMWRITE_JPEG_RST_INTERVAL,
                         2 if kind == "restart" else 0)
        if kind == "arithmetic":
            data = arithmetic(baseline_coefficients(data),
                              progressive=bool(seed % 2), restart=seed % 3)
        start = data.index(b"\xff\xda") + 14
        for k in range(4):
            bad = bytearray(data)
            for _ in range(1 + k % 3):
                bad[int(rng.integers(start, len(bad) - 2))] = int(
                    rng.integers(0, 256))
            if k == 3:
                bad = bad[:int(rng.integers(start, len(bad)))]
            _same_as_cv2(_write(tmp_path, f"c{seed}_{k}.jpg", bytes(bad)),
                         True)


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restart",
                                  "arithmetic"])
def test_corrupted_headers(tmp_path, kind):
    """Bytes of the headers changed (a marker's FF or code, a segment's
    length, a table): libjpeg's marker reading (unknown markers and a
    second SOI are errors), its segment lengths, the standard Huffman
    tables a sequential Huffman file falls back on; cv2's None or its
    image, and the port's the same."""
    rng = np.random.default_rng(len(kind) + 100)
    for seed in range(10):
        img = _noise(seed, (24, 40))
        data = _jpeg(img, int(rng.integers(5, 100)),
                     cv2.IMWRITE_JPEG_PROGRESSIVE,
                     int(kind == "progressive"),
                     cv2.IMWRITE_JPEG_RST_INTERVAL,
                     2 if kind == "restart" else 0)
        if kind == "arithmetic":
            data = arithmetic(baseline_coefficients(data),
                              progressive=bool(seed % 2))
        end = data.rindex(b"\xff\xda")  # the last scan header
        for k in range(4):
            bad = bytearray(data)
            for _ in range(1 + k % 2):
                bad[int(rng.integers(3, end))] = int(rng.integers(0, 256))
            _same_as_cv2(_write(tmp_path, f"h{seed}_{k}.jpg", bytes(bad)),
                         True)


def test_motion_jpeg_without_huffman_tables(tmp_path):
    """A baseline file without its DHT segments (as Motion JPEG frames
    come) reads through libjpeg's standard tables (T.81 K.3-K.6); a
    lossless one without them is cv2's None."""
    data = _jpeg(_noise(22, (24, 40)), 75)
    while b"\xff\xc4" in data:
        i = data.index(b"\xff\xc4")
        data = data[:i] + data[i + 2 + struct.unpack(">H",
                                                     data[i + 2:i + 4])[0]:]
    _same_as_cv2(_write(tmp_path, "mjpeg.jpg", data))
    data = lossless_gray(_noise(23, (8, 8))[..., 0])
    i = data.index(b"\xff\xc4")
    path = _write(tmp_path, "lossless.jpg", data[:i] + data[
        i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]:])
    assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None
    with pytest.raises(signature.Unreadable):
        imread.read_gray(path)


def test_arithmetic_sequential_cut(tmp_path):
    """A sequential arithmetic-coded file cut short decodes on from zeros
    (no MCU is left as it stood), coefficients past 16 bits among them."""
    for sampling in ("444", "420"):
        source = _jpeg(_noise(21, (48, 64)), 85,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_"
                               + sampling))
        data = arithmetic(baseline_coefficients(source))
        start = data.index(b"\xff\xda") + 14
        for cut in range(start, len(data), 37):
            _same_as_cv2(_write(tmp_path, f"s{sampling}_{cut}.jpg",
                                data[:cut]), True)


def test_stray_bytes_before_markers(tmp_path, capfd):
    img = _noise(8, (40, 56))
    data = _jpeg(img)
    dqt, sos = data.index(b"\xff\xdb"), data.index(b"\xff\xda")
    bad = (data[:dqt] + b"\x01\xff\x00\x02" + data[dqt:sos] + b"\x03"
           + data[sos:-2] + b"\x04\x05" + data[-2:])
    path = _write(tmp_path, "stray.jpg", bad)
    capfd.readouterr()
    _same_as_cv2(path)
    assert "extraneous bytes" in capfd.readouterr().err


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (1, 1), (2, 3),
                                   (17, 200), (99, 2)])
def test_rgb_coded(shape):
    """RGB-coded colour: Adobe transform 0 (PIL's keep_rgb), and the
    component ids 'R' 'G' 'B' alone; colour RGB -> BGR, gray by
    rgb_gray_convert's fixed point."""
    img = _noise(sum(shape), shape)
    for kw in ({}, {"progressive": True}, {"restart_marker_blocks": 2}):
        data = _pil_jpeg(img, quality=85, keep_rgb=True, **kw)
        i = data.index(b"\xff\xee")
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        for variant in (data, data[:i] + data[i + 2 + length:]):
            for flag, read in ((cv2.IMREAD_GRAYSCALE, jpeg.decode_gray),
                               (cv2.IMREAD_COLOR, jpeg.decode_bgr)):
                want = cv2.imdecode(np.frombuffer(variant, np.uint8), flag)
                np.testing.assert_array_equal(read(variant), want)


@pytest.mark.parametrize("sampling", ["420", "444", "422", "gray"])
@pytest.mark.parametrize("shape", [(32, 48), (17, 3), (41, 29)])
def test_arithmetic_coding(sampling, shape):
    """Arithmetic-coded files transcoded from cv2's baseline ones:
    sequential and progressive, restart intervals, DAC conditioning. cv2
    reads each as it reads its source, and the port as cv2."""
    img = _noise(len(sampling) + shape[0], shape)
    params = [] if sampling == "gray" else [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)]
    source = _jpeg(img[..., 0] if sampling == "gray" else img, 85, *params)
    frame = baseline_coefficients(source)
    dac = {"L": [1, 2], "U": [3, 4], "K": [2, 9]}
    for progressive, restart, conditioning in (
            (False, 0, None), (False, 3, dac), (True, 0, None),
            (True, 2, dac)):
        data = arithmetic(frame, progressive=progressive, restart=restart,
                          dac=conditioning)
        assert data[data.index(b"\xff\xc9" if not progressive
                               else b"\xff\xca")] == 0xFF
        for flag, read in ((cv2.IMREAD_GRAYSCALE, jpeg.decode_gray),
                           (cv2.IMREAD_COLOR, jpeg.decode_bgr)):
            want = cv2.imdecode(np.frombuffer(source, np.uint8), flag)
            got_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            np.testing.assert_array_equal(got_cv2, want)
            np.testing.assert_array_equal(read(data), want)


def test_arithmetic_progressive_cut(tmp_path):
    img = _noise(9, (64, 96))
    frame = baseline_coefficients(_jpeg(img))
    for restart in (0, 2):
        data = arithmetic(frame, progressive=True, restart=restart)
        for f in np.linspace(0.15, 0.95, 9):
            _same_as_cv2(_write(tmp_path, f"a{restart}_{f:.2f}.jpg",
                                data[:int(len(data) * f)]), True)


def _sof_edit(data: bytes, marker: int = None, precision: int = None):
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[sof + 1] = marker
    if precision is not None:
        out[sof + 4] = precision
    return bytes(out)


def test_kinds_cv2_refuses(tmp_path):
    """cv2.imread returns None; the port raises ``Unreadable`` saying cv2
    does not read it either: hierarchical frames, 12- and 16-bit samples,
    a DC Huffman value past 15, lossless arithmetic coding, 2 components,
    a file that ends in its header or has no scan."""
    base = _jpeg(_noise(10, (32, 48)), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    sos = base.index(b"\xff\xda")
    lossless_scan = base[:sos + 11] + b"\x01\x00\x00" + base[sos + 14:]
    sof = base.index(b"\xff\xc0")
    length = struct.unpack(">H", base[sof + 2:sof + 4])[0]
    two = (base[:sof + 2] + struct.pack(">H", length - 3)
           + base[sof + 4:sof + 9] + b"\x02" + base[sof + 10:sof + 16]
           + base[sof + 2 + length:sos] + base[sos:sos + 2]
           + struct.pack(">H", 10) + b"\x02" + base[sos + 5:sos + 9]
           + base[sos + 11:])
    cases = {f"sof{m:x}": _sof_edit(base, m)
             for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)}
    dht = base.index(b"\xff\xc4")
    big_dc = bytearray(base)
    big_dc[dht + 5 + 16] = 16  # the first DC value: category 16
    cases.update({"12bit": _sof_edit(base, 0xC1, 12),
                  "dc_value_16": bytes(big_dc),
                  "16bit": _sof_edit(base, 0xC1, 16),
                  "lossless_arith": _sof_edit(lossless_scan, 0xCB),
                  "two_components": two, "cut_header": base[:sos - 10],
                  "no_scan": base[:sos] + b"\xff\xd9"})
    for name, data in cases.items():
        path = _write(tmp_path, f"{name}.jpg", data)
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None, name
        assert cv2.imread(str(path)) is None, name
        for read in (imread.read_gray, imread.read_rgb):
            with pytest.raises(signature.Unreadable,
                               match="cv2.imread does not read it either"):
                read(path)


@pytest.mark.parametrize("shape", [(20, 30), (1, 1), (3, 2), (17, 41)])
def test_lossless(tmp_path, shape):
    """Lossless (SOF3) files of one component, every predictor, restart
    intervals of one and two rows: cv2 gives back the image read gray,
    and so does the port; a colour read is cv2's None."""
    img = _noise(sum(shape), shape)[..., 0]
    img[0, 0] = 255
    for predictor in range(1, 8):
        for restart in (0, shape[1], 2 * shape[1]):
            path = _write(tmp_path, f"l{predictor}_{restart}.jpg",
                          lossless_gray(img, predictor, restart))
            np.testing.assert_array_equal(
                cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
            np.testing.assert_array_equal(imread.read_gray(path), img)
    assert cv2.imread(str(path)) is None
    with pytest.raises(signature.Unreadable, match="cv2.imread does not"):
        imread.read_rgb(path)


@pytest.mark.parametrize("sampling", [
    ((1, 1),) * 3, ((2, 2), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1)),
    ((4, 1), (2, 1), (1, 1)), ((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2))])
@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
def test_lossless_colour(sampling, adobe):
    """Interleaved lossless files of 3 or 4 components at any integral
    sampling: libjpeg-turbo converts no colour in lossless mode and
    upsamples by replication, so cv2 reads RGB (ids 1, 2, 3 without a
    marker, or Adobe transform 0) in colour alone and CMYK both ways, and
    returns None for the rest and for a restart interval of part of an
    MCU row; the port the same."""
    channels = len(sampling)
    img = np.random.default_rng(channels).integers(0, 256, (9, 13, 4),
                                                   np.uint8)
    mcus_per_row = -(-13 // max(h for h, _ in sampling))
    for predictor, restart in ((1, 2 * mcus_per_row), (6, 0), (2, 3)):
        data = lossless(img[..., :channels], predictor, restart, adobe,
                        sampling)
        for flag, read in ((cv2.IMREAD_GRAYSCALE, jpeg.decode_gray),
                           (cv2.IMREAD_COLOR, jpeg.decode_bgr)):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if want is None:
                with pytest.raises(signature.Unreadable):
                    read(data)
            else:
                np.testing.assert_array_equal(read(data), want)


def test_fractional_sampling(tmp_path):
    """3 x 2 luma beside 2 x 1 and 1 x 1 chroma: libjpeg has no upsampler
    for 3 : 2, so cv2's colour read is None (the port's ``Unreadable``),
    while its gray read needs the luma alone and decodes."""
    base = _jpeg(_noise(12, (32, 48)), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    comp = base.index(b"\xff\xc0") + 10
    frac = bytearray(base)
    frac[comp + 1], frac[comp + 4] = 0x32, 0x21  # 3 x 2 luma, 2 x 1 Cb
    path = _write(tmp_path, "frac.jpg", bytes(frac))
    np.testing.assert_array_equal(imread.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert cv2.imread(str(path)) is None
    with pytest.raises(signature.Unreadable, match="fractional"):
        imread.read_rgb(path)


# -------------------------------------------------------------------- PNG


def _png(pixels: np.ndarray, depth: int, colour: int, extra=b"",
         interlace: int = 0) -> bytes:
    """A PNG of (H, W, C) samples at ``depth`` bits (packed below 8),
    every row under filter 0; Adam7 where ``interlace``."""
    height, width, _ = pixels.shape

    def rows(sub):
        out = b""
        for row in sub:
            if depth == 16:
                out += b"\0" + row.astype(">u2").tobytes()
            elif depth == 8:
                out += b"\0" + row.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(row.astype(np.uint8).reshape(-1, 1),
                                     axis=1)[:, 8 - depth:].reshape(-1)
                out += b"\0" + np.packbits(bits).tobytes()
        return out

    if interlace:
        raw = b"".join(rows(pixels[y0::dy, x0::dx]) for x0, y0, dx, dy in
                       ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                        (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                        (0, 1, 1, 2))
                       if pixels[y0::dy, x0::dx].size)
    else:
        raw = rows(pixels)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                         colour, 0, 0, interlace))
            + extra + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("width", [1, 2, 3, 13])
def test_png_every_depth_and_colour_type(tmp_path, interlace, width):
    """Gray 1-16 bits, palettes 1-8 bits with and without tRNS, gray +
    alpha and RGB(A) at 8 and 16 bits, tRNS colour keys; Adam7 or not;
    widths 1-3 and 13, 11 rows."""
    rng = np.random.default_rng(width + 10 * interlace)
    h = 11
    palette = _chunk(b"PLTE", rng.integers(0, 256, 3 * 256,
                                           np.uint8).tobytes())
    cases = []
    for depth in (1, 2, 4, 8, 16):
        gray = rng.integers(0, 1 << depth, (h, width, 1))
        cases.append((gray, depth, 0, b""))
        cases.append((gray, depth, 0, _chunk(b"tRNS", struct.pack(">H", 1))))
        if depth <= 8:
            index = rng.integers(0, 1 << depth, (h, width, 1))
            cases.append((index, depth, 3, palette))
            cases.append((index, depth, 3, palette + _chunk(
                b"tRNS", bytes(range(0, 256, 37)))))
    for depth in (8, 16):
        top = (1 << depth) - 1
        cases.append((rng.integers(0, top + 1, (h, width, 2)), depth, 4, b""))
        rgb = rng.integers(0, top + 1, (h, width, 3))
        rgb[0] = rgb[0, :, :1]  # equal R, G, B: libpng keeps them
        cases.append((rgb, depth, 2, b""))
        cases.append((rgb, depth, 2, _chunk(b"tRNS", struct.pack(
            ">HHH", *rgb[1, 0]))))
        cases.append((rng.integers(0, top + 1, (h, width, 4)), depth, 6,
                      b""))
    for i, (pixels, depth, colour, extra) in enumerate(cases):
        _same_as_cv2(_write(tmp_path, f"p{i}.png",
                            _png(pixels, depth, colour, extra, interlace)))


@pytest.mark.parametrize("gamma", [b"sRGB", 45455, 80000, 100000, 220000])
def test_png_gamma_in_gray_reads(tmp_path, gamma):
    """A colour PNG read gray goes through libpng's 8-bit gamma tables
    where its gAMA or sRGB chunk names a gamma that is not 1; after PLTE
    libpng ignores the chunk ("out of place")."""
    img = _noise(13, (23, 31))
    body = _png(img[..., ::-1], 8, 2)
    extra = (_chunk(b"sRGB", b"\0") if gamma == b"sRGB"
             else _chunk(b"gAMA", struct.pack(">I", gamma)))
    _same_as_cv2(_write(tmp_path, "g.png", body[:33] + extra + body[33:]))
    index = np.arange(23 * 31).reshape(23, 31, 1) % 200
    plte = _chunk(b"PLTE", _noise(14, (1, 256))[0].tobytes())
    for order in (extra + plte, plte + extra):
        _same_as_cv2(_write(tmp_path, "p.png", _png(index, 8, 3, order)))


@pytest.mark.parametrize("gamma", [b"sRGB", 45455, 80000, 220000])
def test_png_16bit_gamma_in_gray_reads(tmp_path, gamma):
    """16-bit colour read gray with a gamma: libpng's 11-bit-indexed 16-bit
    tables (gamma_shift 5, as stripping to 8 bits sets it) to linear light
    and back, and its 16-to-8 table for equal R, G, B."""
    rng = np.random.default_rng(len(str(gamma)))
    rgb = rng.integers(0, 65536, (21, 17, 3))
    rgb[:4] = rgb[:4, :, :1]  # equal channels
    rgb[4:6] = rng.integers(0, 65536, (2, 17, 1)) // 257 * 257
    extra = (_chunk(b"sRGB", b"\0") if gamma == b"sRGB"
             else _chunk(b"gAMA", struct.pack(">I", gamma)))
    _same_as_cv2(_write(tmp_path, "g16.png", _png(rgb, 16, 2, extra)))


def test_png_damaged_chunks(tmp_path):
    """An ancillary chunk with a bad CRC is dropped (its gamma too), as
    libpng drops it; a critical one, a cut file or no IEND is cv2's None
    and the port's ``Unreadable``; bytes after IEND and IDAT split in two
    change nothing."""
    img = _noise(20, (8, 9))
    good = _png(img[..., ::-1], 8, 2, _chunk(b"gAMA", struct.pack(
        ">I", 45455)) + _chunk(b"tEXt", b"a\0b"))
    i = good.index(b"gAMA")
    bad_gamma = bytearray(good)
    bad_gamma[i + 4] ^= 1
    _same_as_cv2(_write(tmp_path, "a.png", bytes(bad_gamma)))
    _same_as_cv2(_write(tmp_path, "b.png", good + b"trailing"))
    j = good.index(b"IDAT")
    length = struct.unpack(">I", good[j - 4:j])[0]
    body = good[j + 4:j + 4 + length]
    _same_as_cv2(_write(tmp_path, "c.png", good[:j - 4]
                        + _chunk(b"IDAT", body[:7]) + _chunk(b"IDAT", body[7:])
                        + good[j + 8 + length:]))
    bad_idat = bytearray(good)
    bad_idat[j + 4 + length] ^= 1
    for name, data in (("d.png", bytes(bad_idat)), ("e.png", good[:-12]),
                       ("f.png", good[:j + 20])):
        path = _write(tmp_path, name, data)
        assert cv2.imread(str(path)) is None
        with pytest.raises(signature.Unreadable):
            imread.read_gray(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, orientation):
    img = _noise(orientation, (13, 21))
    data = with_chunk(_png(img[..., ::-1], 8, 2), b"eXIf",
                      exif_orientation(orientation))
    _same_as_cv2(_write(tmp_path, "o.png", data))


def test_png_adam7_writer_of_the_fixtures(tmp_path):
    img = _noise(16, (19, 5))
    _same_as_cv2(_write(tmp_path, "a.png", adam7(img)))


# -------------------------------------------------------------------- PNM


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65535])
def test_pnm_every_magic_and_maxval(tmp_path, maxval):
    """P2 / P3 (ASCII, values past maxval clamped, scaled to 255 at 8
    bits), P5 / P6 (binary, raw at 8 bits), >> 8 at 16 bits, with
    comments; P1 / P4 bitmaps."""
    rng = np.random.default_rng(maxval)
    h, w = 5, 7
    for channels, (ascii_magic, binary_magic) in ((1, ("P2", "P5")),
                                                   (3, ("P3", "P6"))):
        values = rng.integers(0, maxval + 1, (h, w, channels))
        values.flat[0] = maxval + 1 if maxval < 65535 else maxval
        header = f"\n# a comment\n{w} {h}\n{maxval}\n"
        text = " ".join(str(v) for v in values.reshape(-1)) + "\n"
        _same_as_cv2(_write(tmp_path, "a.pnm", (ascii_magic + header
                                                + text).encode()))
        values.flat[0] = maxval
        dtype = ">u2" if maxval > 255 else np.uint8
        _same_as_cv2(_write(tmp_path, "b.pnm", (binary_magic + header)
                            .encode() + values.astype(dtype).tobytes()))
    bits = rng.integers(0, 2, (h, 13))
    _same_as_cv2(_write(tmp_path, "c.pbm", b"P1\n13 5\n" + "\n".join(
        "".join(str(b) for b in row) for row in bits).encode() + b"\n"))
    _same_as_cv2(_write(tmp_path, "d.pbm", b"P4\n13 5\n"
                        + np.packbits(bits.astype(np.uint8), axis=1)
                        .tobytes()))


@pytest.mark.parametrize("data", [b"P5\n4 1\n255\n\x00\x01\x02",
                                  b"P2\n4 1\n100\n0 1 50 100",
                                  b"P5\n4 1\n0\n\x00\x01\x02\x03",
                                  b"P2\n2 1\n9\n1 x\n"])
def test_pnm_cv2_refuses(tmp_path, data):
    """Cut short, ending on a digit, maxval 0, a stray character: cv2's
    None beside the port's ``Unreadable``."""
    path = _write(tmp_path, "x.pgm", data)
    assert cv2.imread(str(path)) is None
    with pytest.raises(signature.Unreadable):
        imread.read_gray(path)


# ---------------------------------------------------------------- loaders


def _mixed_folder(folder: Path) -> list:
    """Files of every kind the port reads, some misnamed; returns their
    names."""
    folder.mkdir(parents=True)
    img = _noise(17, (48, 64))
    files = {
        "a_baseline.jpg": _jpeg(img),
        "b_png_named.jpg": cv2.imencode(".png", img)[1].tobytes(),
        "c_jpeg_named.png": _jpeg(img[..., 0]),
        "d_prog_cut.jpg": _jpeg(img, 85, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                1)[:900],
        "e_arith.jpg": arithmetic(baseline_coefficients(_jpeg(img)),
                                  progressive=True),
        "f_rgb.jpg": _pil_jpeg(img, quality=85, keep_rgb=True),
        "g_palette.png": _png(np.arange(48 * 64).reshape(48, 64, 1) % 97, 8,
                              3, _chunk(b"PLTE", _noise(18, (1, 256))[0]
                                        .tobytes())),
        "h_gray16.png": _png(np.arange(48 * 64).reshape(48, 64, 1) * 21, 16,
                             0, interlace=1),
        "i_ascii.pgm": b"P2 64 48 100\n" + " ".join(
            str(v % 101) for v in range(48 * 64)).encode() + b"\n",
        "j_ppm_named.png": cv2.imencode(".ppm", img)[1].tobytes(),
        "p_bmp_rle8.bmp": writers.bmp(64, 48, 8, writers.rle(
            np.arange(48 * 64).reshape(48, 64) % 37, 8,
            np.random.default_rng(5)), 1, writers.palette(
                _noise(21, (1, 256))[0])),
        "q_ras.ras": cv2.imencode(".ras", img)[1].tobytes(),
        "r_pam_named.jpg": cv2.imencode(".pam", img)[1].tobytes(),
        "s_pfm.pfm": writers.pfm(img[..., 0].astype(np.float32) * 0.9),
        "t_hdr.hdr": cv2.imencode(".hdr", img.astype(np.float32) / 300)[1]
        .tobytes(),
        "u_gif.gif": cv2.imencode(".gif", img)[1].tobytes(),
    }
    for name, data in files.items():
        (folder / name).write_bytes(data)
    return sorted(files)


def test_loaders_of_both_packages_over_a_mixed_folder(tmp_path,
                                                      monkeypatch):
    """COCO (``iterdir``), NeRFDataset (``glob('*')``) and
    ``eval/pose.load_gray`` of the JAX package (cv2) and of the port
    (``imread``) return equal arrays over one folder of mixed, misnamed
    files; and (None, None) for the same files in the pose loader: a
    missing one, one no decoder claims, one cv2 refuses, one whose
    Huffman table libjpeg stops at, one whose image data zlib rejects."""
    from spnerf_tpu import settings as jsettings
    from spnerf_tpu.data import coco as jcoco
    from spnerf_tpu.data import nerf_dataset as jnerf
    from spnerf_tpu.eval import pose as jpose
    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.data import coco as tcoco
    from spnerf_tpu_torch.data import nerf_dataset as tnerf
    from spnerf_tpu_torch.eval import pose as tpose

    for module in (settings, jcoco, jnerf, jsettings):
        if hasattr(module, "DATA_PATH"):
            monkeypatch.setattr(module, "DATA_PATH", tmp_path / "data")
        if hasattr(module, "EXPER_PATH"):
            monkeypatch.setattr(module, "EXPER_PATH", tmp_path / "exper")
    names = _mixed_folder(tmp_path / "data" / "COCO" / "images"
                          / "training")
    config = {"name": "COCO", "preprocessing": {"resize": [40, 56]},
              "augmentation": {"photometric": {"enable": False}}}
    got, want = tcoco.COCO(config, "training"), jcoco.COCO(config,
                                                           "training")
    assert len(got) == len(want) == len(names)
    for i in range(len(names)):
        np.testing.assert_array_equal(got[i]["image"], want[i]["image"],
                                      err_msg=names[i])

    scene = tmp_path / "data" / "NeRF" / "Mixed"
    _mixed_folder(scene / "images" / "training")
    (scene / "camera_transforms" / "training").mkdir(parents=True)
    (scene / "depth" / "training").mkdir(parents=True)
    for name in names:
        stem = Path(name).stem
        np.save(scene / "camera_transforms" / "training" / f"{stem}.npy",
                np.eye(4, dtype=np.float32))
        np.save(scene / "depth" / "training" / f"{stem}.npy",
                np.ones((48, 64), np.float32))
    nerf_config = {"name": "NeRF", "data_dir": "Mixed", "fov": 44,
                   "warped_pair": False,
                   "augmentation": {"photometric": {"enable": False}}}
    got, want = tnerf.NeRFDataset(nerf_config, "training"), \
        jnerf.NeRFDataset(nerf_config, "training")
    assert len(got) == len(want) == len(names)
    for i in range(len(names)):
        np.testing.assert_array_equal(got[i]["image"], want[i]["image"],
                                      err_msg=names[i])

    folder = tmp_path / "data" / "COCO" / "images" / "training"
    (folder / "k_text.jpg").write_bytes(b"not an image")
    (folder / "l_hierarchical.jpg").write_bytes(
        _sof_edit(_jpeg(_noise(19, (16, 16))), 0xC5))
    broken = bytearray(_jpeg(_noise(20, (16, 16))))
    broken[broken.index(b"\xff\xc4") + 5] = 0xFF  # 255 codes of length 1
    (folder / "n_bad_table.jpg").write_bytes(bytes(broken))
    (folder / "o_bad_zlib.png").write_bytes(_png(
        np.zeros((4, 4, 1)), 8, 0)[:41] + b"\0" * 20)
    for name in names + ["k_text.jpg", "l_hierarchical.jpg",
                         "n_bad_table.jpg", "o_bad_zlib.png",
                         "m_missing.png"]:
        for spec in ([40], [-1]):
            g, gs = tpose.load_gray(folder / name, spec)
            w, ws = jpose.load_gray(folder / name, spec)
            assert (g is None) == (w is None), name
            assert gs == ws, name
            if w is not None:
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert tpose.load_gray(folder / "k_text.jpg", [40]) == (None, None)
