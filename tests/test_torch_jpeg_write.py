"""``data.jpeg.write_gray`` / ``encode_gray`` against cv2: the same bytes
as ``cv2.imencode('.jpg', img)`` (libjpeg-turbo at cv2's defaults), and
read back by ``data.jpeg.read_gray`` as ``cv2.imread`` reads them."""

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.data import jpeg
from spnerf_tpu_torch.demo.standin_data import fresh_cv_rng, make_composite

SHAPES = [(480, 640), (37, 45), (1, 1), (8, 8), (121, 163)]


def images(shape, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    flat = np.full(shape, 255, np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
            % 256).astype(np.uint8)
    return {"noise": noise, "blurred": cv2.GaussianBlur(noise, (7, 7), 0),
            "flat": flat, "ramp": ramp}


@pytest.mark.parametrize("shape", SHAPES)
def test_bytes_equal_cv2(shape, tmp_path):
    for name, img in images(shape, sum(shape)).items():
        want = cv2.imencode(".jpg", img)[1].tobytes()
        assert jpeg.encode_gray(img) == want, name
        path = tmp_path / f"{name}.jpg"
        jpeg.write_gray(path, img)
        assert path.read_bytes() == want, name
        np.testing.assert_array_equal(
            jpeg.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_quality_equal_cv2(quality):
    img = images((64, 88), quality)["blurred"]
    want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1]
    assert jpeg.encode_gray(img, quality) == want.tobytes()


@pytest.mark.parametrize("size", [(480, 640), (250, 333)])
def test_standin_composites_equal_cv2(size):
    """The demo's stand-in images, as ``demo/make_standin_data.py`` writes
    them (a composite at 480 x 640 and one at a size that is no multiple
    of 8)."""
    fresh_cv_rng()
    for seed in range(2):
        img = make_composite(np.random.default_rng(seed), size)
        assert jpeg.encode_gray(img) == cv2.imencode(".jpg", img)[1].tobytes()
        np.testing.assert_array_equal(
            jpeg.decode_gray(jpeg.encode_gray(img)),
            cv2.imdecode(cv2.imencode(".jpg", img)[1], cv2.IMREAD_GRAYSCALE))


def test_rejects_what_cv2_would_not_write_gray():
    with pytest.raises(ValueError):
        jpeg.encode_gray(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        jpeg.encode_gray(np.zeros((4, 4), np.float32))
