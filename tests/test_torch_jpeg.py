"""The port's JPEG decoder (``spnerf_tpu_torch/data/jpeg.py`` over
``spnerf_tpu_torch/native/jpeg.cpp``) against ``cv2.imread`` (cv2 5.0's
libjpeg-turbo), gray and colour, byte for byte: the committed fixtures of
``tests/data/jpeg/`` (their digests too), files encoded by
``cv2.imencode`` at qualities 5-100, sizes that are not multiples of 8 or
16 and widths of 1-3 pixels, every chroma sampling cv2 writes, gray,
restart intervals, progressive files from cv2 and from PIL (a test-only
dependency: the port never imports it) with and without ``optimize`` and
restart intervals, Adobe CMYK and YCCK, EXIF orientations 1-8, and
sequential files cut inside their scans (read from a file, as
``cv2.imread`` reads them: ``cv2.imdecode`` refuses them). Cut
progressive files (block-smoothed), arithmetic-coded and RGB-coded files
decode as cv2 decodes them; what cv2 refuses (12-bit samples, files cut
inside their headers) raises. ``test_torch_imread_formats.py`` covers the
rest of what libjpeg reads."""

import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from _jpeg_fixtures import COLOUR, DIR, digest, orientation_app1, with_app1
from spnerf_tpu_torch.data import imread, jpeg
from spnerf_tpu_torch.utils import native

SAMPLINGS = {
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
}
READS = ((cv2.IMREAD_GRAYSCALE, jpeg.decode_gray),
         (cv2.IMREAD_COLOR, jpeg.decode_bgr))


def _colour(seed, shape):
    """Smooth colour content with edges: blurred noise plus a bar."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (3,)).astype(np.uint8),
                           (5, 5), 0)
    img[shape[0] // 3: shape[0] // 2] = rng.integers(0, 256, 3)
    return img


def _same(data: bytes):
    """Gray and colour reads of ``data`` equal ``cv2.imdecode``'s."""
    for flag, read in READS:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = read(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _pil(img, mode="RGB", **kw) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(img, mode).save(out, "JPEG", **kw)
    return out.getvalue()


def _encode(img, quality, *extra) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality]
                           + list(extra))
    assert ok
    return buf.tobytes()


def test_fixtures_and_digests():
    """Every fixture through ``imread`` (``png_as.jpg`` is a PNG) equal to
    cv2's read and to its digest; the lossless file's colour digest is
    null, cv2's None."""
    digests = json.loads((DIR / "digests.json").read_text())
    colour = digests.pop(COLOUR)
    names = sorted(p.name for p in DIR.glob("*.jpg"))
    assert names == sorted(digests) == sorted(colour) and len(names) == 31
    assert sum((DIR / n).stat().st_size for n in names) < 1.5e6
    for name in names:
        for flag, want_digest, read in (
                (cv2.IMREAD_GRAYSCALE, digests[name], imread.read_gray),
                (cv2.IMREAD_COLOR, colour[name],
                 lambda p: imread.read_rgb(p)[..., ::-1])):
            want = cv2.imread(str(DIR / name), flag)
            assert digest(want) == want_digest, name
            if want is None:
                with pytest.raises(ValueError, match="does not read it"):
                    read(DIR / name)
                continue
            np.testing.assert_array_equal(read(DIR / name), want,
                                          err_msg=name)
    assert digests["exif6.jpg"]["shape"] == [640, 480]
    assert colour["exif6.jpg"]["shape"] == [640, 480, 3]
    assert digests["odd_479x637.jpg"]["shape"] == [479, 637]
    assert colour["prog_420.jpg"]["shape"] == [480, 640, 3]


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("shape", [(48, 64), (61, 83), (17, 9), (1, 1),
                                   (33, 130), (9, 1), (6, 2), (11, 3)])
def test_cv2_encoded(sampling, shape):
    img = _colour(shape[0], shape)
    for quality in (5, 30, 75, 95, 100):
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
        _same(buf.tobytes())


@pytest.mark.parametrize("rst", [1, 2, 5, 64])
def test_restart_intervals(rst):
    for gray in (False, True):
        img = _colour(rst, (45, 70))
        ok, buf = cv2.imencode(".jpg", img[..., 0] if gray else img, [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        _same(buf.tobytes())


@pytest.mark.parametrize("quality", [5, 50, 100])
def test_gray_and_optimized(quality):
    img = _colour(quality, (37, 59))
    for extra in ([], [cv2.IMWRITE_JPEG_OPTIMIZE, 1]):
        ok, buf = cv2.imencode(".jpg", img[..., 1],
                               [cv2.IMWRITE_JPEG_QUALITY, quality] + extra)
        _same(buf.tobytes())


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation):
    """An APP1 segment inserted by bytes, and one written by PIL."""
    from PIL import Image

    img = _colour(orientation, (24, 40))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = with_app1(buf.tobytes(), orientation_app1(orientation))
    assert jpeg.exif_orientation(data) == orientation
    _same(data)
    exif = Image.Exif()
    exif[0x0112] = orientation
    out = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(out, "JPEG", quality=85,
                                          exif=exif.tobytes())
    _same(out.getvalue())
    raw = jpeg.decode_gray(buf.tobytes())
    assert raw.shape == (24, 40)
    np.testing.assert_array_equal(jpeg.decode_gray(data),
                                  jpeg.apply_orientation(raw, orientation))


def test_pil_written_files():
    from PIL import Image

    img = _colour(3, (50, 75))
    for mode, kw in (("RGB", {"quality": 90}),
                     ("RGB", {"quality": 60, "subsampling": 0}),
                     ("RGB", {"quality": 60, "subsampling": 1}),
                     ("RGB", {"quality": 40, "optimize": True}),
                     ("L", {"quality": 70})):
        pil = Image.fromarray(img[:, :, ::-1] if mode == "RGB"
                              else img[..., 0])
        out = io.BytesIO()
        pil.save(out, "JPEG", **kw)
        _same(out.getvalue())


@pytest.mark.parametrize("quality", [10, 50, 90, 100])
def test_progressive_cv2(quality):
    """cv2's progressive script at every sampling, gray, with optimized
    tables and with restart intervals."""
    img = _colour(quality, (45, 70))
    for sampling in SAMPLINGS.values():
        _same(_encode(img, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling))
    for extra in ([cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                  [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]):
        _same(_encode(img, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *extra))
        _same(_encode(img[..., 0], quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      *extra))


@pytest.mark.parametrize("kw", [
    {"quality": 90},
    {"quality": 60, "optimize": True},
    {"quality": 75, "optimize": True, "restart_marker_blocks": 3},
    {"quality": 40, "subsampling": 0, "restart_marker_rows": 1},
    {"quality": 95, "subsampling": 1, "restart_marker_blocks": 1}],
    ids=["plain", "optimize", "optimize-rst", "444-rst-rows", "422-rst1"])
def test_progressive_pil(kw):
    img = _colour(7, (50, 75))
    _same(_pil(img[:, :, ::-1], progressive=True, **kw))
    _same(_pil(img[..., 0], "L", progressive=True, **kw))


@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_cmyk_and_ycck(quality, subsampling):
    """PIL's Adobe CMYK (transform 0), the same file marked YCCK
    (transform 2), and a progressive CMYK file: cv2's CMYK-to-BGR and
    CMYK-to-gray formulas after libjpeg's YCCK-to-CMYK."""
    cmyk = np.concatenate([_colour(quality, (37, 53)),
                           _colour(subsampling, (37, 53))[..., :1]], -1)
    data = _pil(cmyk, "CMYK", quality=quality, subsampling=subsampling)
    adobe = data.index(b"Adobe") + 11
    assert data[adobe] == 0
    _same(data)
    _same(data[:adobe] + b"\x02" + data[adobe + 1:])
    _same(_pil(cmyk, "CMYK", quality=quality, subsampling=subsampling,
               progressive=True))


@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("rst", [0, 2])
def test_cut_inside_the_scan(tmp_path, capfd, sampling, rst):
    """A sequential file cut at 30-99.9% of its bytes reads as
    ``cv2.imread`` reads the file (the MCUs past the cut gray), with one
    warning on stderr; so does a file without its EOI marker."""
    data = _encode(_colour(1, (64, 96)), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   SAMPLINGS[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    for cut in (0.3, 0.45, 0.6, 0.8, 0.999, (len(data) - 2) / len(data)):
        path = tmp_path / "cut.jpg"
        path.write_bytes(data[:int(len(data) * cut)])
        for flag, read in ((cv2.IMREAD_GRAYSCALE, jpeg.read_gray),
                           (cv2.IMREAD_COLOR,
                            lambda p: jpeg.read_rgb(p)[..., ::-1])):
            want = cv2.imread(str(path), flag)
            capfd.readouterr()
            got = read(path)
            assert capfd.readouterr().err.count("Premature end") == 1
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(cut))
    # the last MCU rows stay gray where the data ran out early
    assert (jpeg.decode_gray(data[:len(data) // 3])[-8:] == 128).all()


def test_unsupported_files_raise(tmp_path):
    """What raised before and now decodes as cv2 decodes it: a progressive
    file cut short (libjpeg block-smooths it), an arithmetic-coded frame
    header over Huffman data (libjpeg decodes it, into garbage), an
    RGB-coded colour file. What still raises, beside cv2's None: 12-bit
    samples, a file cut inside its headers, bytes that are not a JPEG
    file."""
    img = _colour(4, (32, 48))
    data = _encode(img, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(data[:len(data) // 2])
    np.testing.assert_array_equal(jpeg.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(jpeg.read_rgb(path)[..., ::-1],
                                  cv2.imread(str(path)))
    baseline = _encode(img, 90)
    sof = baseline.index(b"\xff\xc0")
    _same(baseline[:sof + 1] + b"\xc9" + baseline[sof + 2:])
    _same(_pil(img[:, :, ::-1], quality=90, keep_rgb=True))
    twelve = baseline[:sof + 4] + b"\x0c" + baseline[sof + 5:]
    for bad, message in ((twelve, "12-bit"), (baseline[:100], "header"),
                         (b"\x89PNG\r\n\x1a\n", "not a JPEG")):
        assert cv2.imdecode(np.frombuffer(bad, np.uint8),
                            cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=message):
            jpeg.decode_bgr(bad)


def test_builds_its_own_source_into_build():
    jpeg.decode_gray((DIR / "gray_q85.jpg").read_bytes())
    lib = Path(native.BUILD_DIR) / "libjpeg.so"
    assert lib.is_file()
    assert native.BUILD_DIR == Path(__file__).resolve().parents[1] / \
        "build/spnerf_tpu_torch/native"


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load("broken")
