"""``data.cv_warp.warp_perspective_u8`` against ``cv2.warpPerspective
(..., INTER_LINEAR)`` with its constant-0 border, byte for byte: on the
demo's stand-in images and viewpoint homographies
(``demo/make_standin_data.py``), and at widths whose last columns take
OpenCV's scalar tail; ``invert3`` against ``cv2.invert``."""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.data.cv_warp import invert3, warp_perspective_u8
from spnerf_tpu_torch.demo import standin_data

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from demo import make_standin_data  # noqa: E402


def homography(rng, h, w, strength):
    return make_standin_data.random_pixel_homography(rng, h, w, strength)


def test_demo_scene_warps_equal_cv2():
    """A stand-in HPatches scene: its base and the five warps of
    make_standin_data, homographies from the demo's own function."""
    standin_data.fresh_cv_rng()
    rng = np.random.default_rng(3)
    base = standin_data.make_composite(rng)
    h, w = base.shape
    for i in range(5):
        H = homography(rng, h, w, 0.15)
        np.testing.assert_array_equal(
            standin_data.random_pixel_homography(
                np.random.default_rng(i), h, w),
            make_standin_data.random_pixel_homography(
                np.random.default_rng(i), h, w))
        want = cv2.warpPerspective(base, H, (w, h), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(warp_perspective_u8(base, H, (w, h)),
                                      want)


@pytest.mark.parametrize("shape", [(480, 640), (300, 47), (37, 45),
                                   (120, 15), (64, 200)])
def test_random_warps_equal_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    img = cv2.GaussianBlur(rng.integers(0, 256, shape, dtype=np.uint8),
                           (3, 3), 0)
    for strength in (0.15, 0.3):
        H = homography(rng, h, w, strength)
        want = cv2.warpPerspective(img, H, (w, h), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(warp_perspective_u8(img, H, (w, h)),
                                      want)
        assert np.array_equal(invert3(H), cv2.invert(H)[1])


def test_other_output_size_equal_cv2():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (90, 130), dtype=np.uint8)
    H = homography(rng, 90, 130, 0.2)
    for dsize in ((77, 61), (200, 150)):
        want = cv2.warpPerspective(img, H, dsize, flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(warp_perspective_u8(img, H, dsize),
                                      want)
