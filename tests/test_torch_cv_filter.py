"""The port's copies of cv2's filters (``spnerf_tpu_torch/data/cv_filter.py``)
against cv2 (5.0) as the tests run it: the uint8 box and Gaussian blurs byte-equal
(kernels larger than the image and even box sizes included, which
take other paths in OpenCV), the float32 filters within pinned bounds on
the 0-255 scale (measured: at most 1.4e-4 for ``gaussian_blur_f32`` at k
51-151 on images up to 96 x 128, 3.1e-5 for ``filter2d_f32`` with
kernels up to 7)."""

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.data import cv_filter

GAUSS_F32_TOL = 2e-4
FILTER2D_TOL = 5e-5
SHAPES = [(30, 40), (17, 23), (1, 7), (5, 1), (61, 83), (96, 128)]


def _images(seed, shape):
    """A noise image and a smooth one (many exact ties in the sums)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    smooth = np.full(shape, int(rng.integers(0, 256)), np.uint8)
    smooth[:, : shape[1] // 2] = int(rng.integers(0, 256))
    return noise, smooth


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_u8_byte_equal(shape):
    ks = list(range(1, 34)) + [37, 48, 50, 64, 100, 128, 150, 257]
    for i, k in enumerate(ks):
        for img in _images(i, shape):
            np.testing.assert_array_equal(cv_filter.blur_u8(img, k),
                                          cv2.blur(img, (k, k)), err_msg=k)


def test_blur_u8_full_size_background_kernels():
    """magicpoint_syn.yaml's sizes: 960 x 1280, k 128 and 150-500."""
    img = np.random.default_rng(3).integers(0, 256, (960, 1280)).astype(
        np.uint8)
    for k in (128, 150, 333, 499):
        np.testing.assert_array_equal(cv_filter.blur_u8(img, k),
                                      cv2.blur(img, (k, k)), err_msg=k)


@pytest.mark.parametrize("shape", SHAPES + [(240, 320)])
def test_gaussian_blur_u8_byte_equal(shape):
    for i, k in enumerate((1, 3, 5, 7, 9, 11, 13, 15, 21, 25, 31, 51)):
        for img in _images(10 + i, shape):
            np.testing.assert_array_equal(
                cv_filter.gaussian_blur_u8(img, k),
                cv2.GaussianBlur(img, (k, k), 0), err_msg=k)


def test_gaussian_taps_sum_to_one_and_match_cv2_impulse():
    """The 8-bit taps, read back from cv2 by an impulse of 255 on a 2-D
    image: out = round(255 t_i t_j / 2^16)."""
    for k in (3, 11, 21, 31):
        taps = cv_filter.gaussian_taps_u8(k)
        assert taps.sum() == 256 and np.array_equal(taps, taps[::-1])
        img = np.zeros((2 * k + 1, 2 * k + 1), np.uint8)
        img[k, k] = 255
        want = cv2.GaussianBlur(img, (k, k), 0)
        outer = np.zeros(img.shape, np.int64)
        a = k // 2
        outer[k - a:k + a + 1, k - a:k + a + 1] = np.outer(taps, taps) * 255
        np.testing.assert_array_equal((outer + (1 << 15)) >> 16, want)


def test_gaussian_kernel_is_cv2s():
    for k in (3, 5, 7, 9, 21, 51, 101, 151):
        np.testing.assert_array_equal(
            cv_filter.gaussian_kernel(k).astype(np.float32),
            cv2.getGaussianKernel(k, 0, cv2.CV_32F).ravel())


@pytest.mark.parametrize("shape", [(30, 40), (60, 80), (96, 128)])
def test_gaussian_blur_f32_within_bound(shape):
    rng = np.random.default_rng(shape[0])
    mask = np.zeros(shape, np.uint8)
    for _ in range(6):
        cv2.ellipse(mask, (int(rng.integers(0, shape[1])),
                           int(rng.integers(0, shape[0]))),
                    (int(rng.integers(3, 30)), int(rng.integers(3, 30))),
                    float(rng.uniform(0, 90)), 0, 360, 255, -1)
    for img in (mask.astype(np.float32),
                rng.uniform(0, 255, shape).astype(np.float32)):
        for k in (51, 75, 101, 125, 151):
            got = cv_filter.gaussian_blur_f32(img, k)
            want = cv2.GaussianBlur(img, (k, k), 0)
            assert got.dtype == np.float32
            assert np.abs(got - want).max() <= GAUSS_F32_TOL, k


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_filter2d_f32_within_bound(k):
    rng = np.random.default_rng(k)
    img = rng.uniform(0, 255, (45, 67)).astype(np.float32)
    c = (k - 1) // 2
    for kind in ("h", "v", "d1", "d2", "random"):
        kernel = np.zeros((k, k), np.float32)
        if kind == "h":
            kernel[c, :] = 1
        elif kind == "v":
            kernel[:, c] = 1
        elif kind == "d1":
            np.fill_diagonal(kernel, 1)
        elif kind == "d2":
            np.fill_diagonal(np.fliplr(kernel), 1)
        else:
            kernel = rng.uniform(0, 1, (k, k)).astype(np.float32)
        kernel /= kernel.sum()
        got = cv_filter.filter2d_f32(img, kernel)
        want = cv2.filter2D(img, -1, kernel)
        assert np.abs(got - want).max() <= FILTER2D_TOL, kind


def test_filters_refuse_other_dtypes():
    with pytest.raises(ValueError, match="uint8"):
        cv_filter.blur_u8(np.zeros((4, 4), np.float32), 3)
    with pytest.raises(ValueError, match="float32"):
        cv_filter.gaussian_blur_f32(np.zeros((4, 4), np.uint8), 3)
    with pytest.raises(ValueError, match="not odd"):
        cv_filter.gaussian_kernel(4)
