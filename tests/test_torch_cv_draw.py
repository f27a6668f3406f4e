"""The port's copies of cv2's integer rasteriser, perspective transforms
and random fill (``spnerf_tpu_torch/data/cv_draw.py``,
``spnerf_tpu_torch/eval/cv_rng.py``) against cv2 (5.0) as the tests run it: every
image byte-equal, every matrix and transformed point bit-equal, every
``randu`` draw equal. Shapes come from seeded numpy draws on 60 x 80
images, a third of them crossing the border."""

import subprocess
import sys

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.data import cv_draw
from spnerf_tpu_torch.eval import cv_rng

H, W = 60, 80
SEEDS = range(8)
N = 40  # shapes per seed


def _point(rng, margin):
    return (int(rng.integers(-margin, W + margin)),
            int(rng.integers(-margin, H + margin)))


def _margin(i):
    return 25 if i % 3 == 0 else 0


def _assert_same(draw_cv, draw_port, rng_seed, n=N):
    for i in range(n):
        want = np.zeros((H, W), np.uint8)
        got = want.copy()
        draw_cv(want, np.random.default_rng((rng_seed, i)), _margin(i))
        draw_port(got, np.random.default_rng((rng_seed, i)), _margin(i))
        assert np.array_equal(got, want), (rng_seed, i,
                                           int((got != want).sum()))


@pytest.mark.parametrize("seed", SEEDS)
def test_lines_thickness_1_to_12(seed):
    def args(rng, m):
        return _point(rng, m), _point(rng, m), 200, int(rng.integers(1, 13))

    _assert_same(lambda im, r, m: cv2.line(im, *args(r, m)),
                 lambda im, r, m: cv_draw.line(im, *args(r, m)), seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_filled_circles_radius_0_to_40(seed):
    def args(rng, m):
        return _point(rng, m), int(rng.integers(0, 41))

    _assert_same(lambda im, r, m: cv2.circle(im, *args(r, m), 200, -1),
                 lambda im, r, m: cv_draw.circle(im, *args(r, m), 200), seed)


def _polygon(rng, m):
    kind = int(rng.integers(0, 3))
    k = int(rng.integers(3, 9))
    if kind == 0:  # convex: angles sorted around a centre
        c = np.array(_point(rng, m), np.float64)
        r = rng.uniform(3, 30)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        pts = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
        return [pts.astype(np.int32)]
    if kind == 1:  # non-convex, self-crossing: random vertices
        return [np.array([_point(rng, m) for _ in range(k)], np.int32)]
    # degenerate: repeated vertices, collinear runs, one or two points,
    # and a second polygon filled together with the first
    p = np.array([_point(rng, m) for _ in range(2)], np.int32)
    line = np.array([p[0], (p[0] + p[1]) // 2, p[1]], np.int32)
    return [line, np.repeat(p[:1], int(rng.integers(1, 4)), 0),
            np.array([_point(rng, m) for _ in range(k)], np.int32)]


@pytest.mark.parametrize("seed", SEEDS)
def test_fill_poly_convex_nonconvex_degenerate(seed):
    _assert_same(lambda im, r, m: cv2.fillPoly(im, _polygon(r, m), 200),
                 lambda im, r, m: cv_draw.fill_poly(im, _polygon(r, m), 200),
                 seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_filled_ellipses_fractional_angles(seed):
    def args(rng, m):
        return (_point(rng, m), (int(rng.integers(0, 45)),
                                 int(rng.integers(0, 45))),
                float(rng.uniform(-400, 400)))

    # half-degree angles too: cv2 rounds them half to even
    def cv(im, r, m):
        c, ax, a = args(r, m)
        cv2.ellipse(im, c, ax, a if m else np.floor(a) + 0.5, 0, 360, 200, -1)

    def port(im, r, m):
        c, ax, a = args(r, m)
        cv_draw.ellipse(im, c, ax, a if m else np.floor(a) + 0.5, 200)

    _assert_same(cv, port, seed)


def test_sin_table_is_opencvs():
    """ellipse2Poly's vertices at axes 10^7 read OpenCV's table of sines
    to its 7 decimals."""
    pts = cv2.ellipse2Poly((0, 0), (10 ** 7, 10 ** 7), 0, 0, 450, 1)
    got = np.rint(cv_draw.SIN_TABLE.astype(np.float64) * 1e7)
    np.testing.assert_array_equal(pts[:, 1], got[:len(pts)])
    np.testing.assert_array_equal(pts[:361, 0], got[90:451])


@pytest.mark.parametrize("seed", range(4))
def test_perspective_transforms_and_int32_truncations(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        src = rng.uniform(-50, 400, (4, 2)).astype(np.float32)
        dst = src + rng.uniform(-60, 60, (4, 2)).astype(np.float32)
        want = cv2.getPerspectiveTransform(src, dst)
        got = cv_draw.get_perspective_transform(src, dst)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        pts = rng.uniform(-100, 500, (1, 64, 2)).astype(np.float32)
        want_p = cv2.perspectiveTransform(pts, want)
        got_p = cv_draw.perspective_transform(pts, got)
        assert got_p.dtype == np.float32
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_p.astype(np.int32),
                                      want_p.astype(np.int32))


def test_perspective_transform_at_infinity():
    m = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0]], np.float64)
    pts = np.array([[[0, 5], [1e-9, 2], [2, 3]]], np.float32)
    np.testing.assert_array_equal(cv_draw.perspective_transform(pts, m),
                                  cv2.perspectiveTransform(pts, m))


@pytest.mark.parametrize("low,high", [(0, 255), (17, 57), (59, 99), (0, 3)])
def test_randu_matches_cv2(low, high):
    for seed in (1, 12345, 2 ** 31 - 5):
        cv2.setRNGSeed(seed)
        cv_rng.set_rng_seed(seed)
        for shape in ((37, 53), (1, 5), (120, 160)):
            want = np.zeros(shape, np.uint8)
            got = want.copy()
            cv2.randu(want, low, high)
            cv_rng.randu(got, low, high)
            np.testing.assert_array_equal(got, want)
        # an explicit generator draws the same stream
        cv2.setRNGSeed(seed)
        want = np.zeros((9, 11), np.uint8)
        cv2.randu(want, low, high)
        got = np.zeros((9, 11), np.uint8)
        cv_rng.randu(got, low, high, cv_rng.CvRNG(seed))
        np.testing.assert_array_equal(got, want)


def test_randu_refuses_power_of_two_ranges():
    img = np.zeros((4, 4), np.uint8)
    for low, high in ((0, 256), (3, 7), (5, 6)):
        with pytest.raises(ValueError, match="not reproduced"):
            cv_rng.randu(img, low, high)


PROBE = """
import sys, numpy as np
sys.path.insert(0, {root!r})
if sys.argv[1] == "cv2":
    import cv2
    img = np.zeros((6, 7), np.uint8); cv2.randu(img, 10, 50)
else:
    from spnerf_tpu_torch.eval import cv_rng
    img = np.zeros((6, 7), np.uint8); cv_rng.randu(img, 10, 50)
    assert "cv2" not in sys.modules
print(img.tobytes().hex())
"""


def test_global_generator_starts_as_in_a_fresh_process():
    """A fresh process's first ``randu`` draws from state 0xffffffff in
    both, which ``CvRNG()``'s default (uint64)-1 does not give."""
    from pathlib import Path

    probe = PROBE.format(root=str(Path(__file__).resolve().parents[1]))
    outs = [subprocess.run([sys.executable, "-c", probe, which],
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout for which in ("cv2", "port")]
    assert outs[0] == outs[1]
    first = np.zeros((6, 7), np.uint8)
    cv_rng.randu(first, 10, 50, cv_rng.CvRNG(0xffffffff))
    assert first.tobytes().hex() == outs[0].strip()
    other = np.zeros((6, 7), np.uint8)
    cv_rng.randu(other, 10, 50, cv_rng.CvRNG())
    assert other.tobytes().hex() != outs[0].strip()
