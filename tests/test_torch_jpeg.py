"""The port's gray JPEG decoder (``spnerf_tpu_torch/data/jpeg.py`` over
``spnerf_tpu_torch/native/jpeg_gray.cpp``) against
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (cv2 5.0's libjpeg-turbo),
byte for byte: the committed fixtures of ``tests/data/jpeg/`` (their
digests too), files encoded by ``cv2.imencode`` at qualities 5-100,
sizes that are not multiples of 8 or 16, every chroma sampling cv2
writes, gray, restart intervals, files written by PIL (a test-only
dependency: the port never imports it), and EXIF orientations 1-8. Progressive
and CMYK files raise naming the ROADMAP item."""

import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from _jpeg_fixtures import DIR, digest, orientation_app1, with_app1
from spnerf_tpu_torch.data import jpeg
from spnerf_tpu_torch.utils import native

SAMPLINGS = {
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
}


def _colour(seed, shape):
    """Smooth colour content with edges: blurred noise plus a bar."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (3,)).astype(np.uint8),
                           (5, 5), 0)
    img[shape[0] // 3: shape[0] // 2] = rng.integers(0, 256, 3)
    return img


def _same(data: bytes):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    got = jpeg.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fixtures_and_digests():
    digests = json.loads((DIR / "digests.json").read_text())
    names = sorted(p.name for p in DIR.glob("*.jpg"))
    assert names == sorted(digests) and 7 <= len(names) <= 8
    assert sum((DIR / n).stat().st_size for n in names) < 1.5e6
    for name in names:
        want = cv2.imread(str(DIR / name), cv2.IMREAD_GRAYSCALE)
        assert digest(want) == digests[name], name
        got = jpeg.read_gray(DIR / name)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert digests["exif6.jpg"]["shape"] == [640, 480]
    assert digests["odd_479x637.jpg"]["shape"] == [479, 637]


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("shape", [(48, 64), (61, 83), (17, 9), (1, 1),
                                   (33, 130)])
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


def test_unsupported_files_raise(tmp_path):
    from PIL import Image

    img = _colour(4, (32, 48))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = tmp_path / "progressive.jpg"
    path.write_bytes(buf.tobytes())
    with pytest.raises(ValueError, match=r"progressive.jpg: progressive.*"
                                         r"Queue 1 item 7"):
        jpeg.read_gray(path)
    out = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(out, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        jpeg.decode_gray(out.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_gray(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_gray(buf.tobytes()[:100])


def test_builds_its_own_source_into_build():
    jpeg.decode_gray((DIR / "gray_q85.jpg").read_bytes())
    lib = Path(native.BUILD_DIR) / "libjpeg_gray.so"
    assert lib.is_file()
    assert native.BUILD_DIR == Path(__file__).resolve().parents[1] / \
        "build/spnerf_tpu_torch/native"


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load("broken")
