"""The port's essential-matrix RANSAC and pose recovery
(``eval/essential.py``, ``eval/cv_rng.py``) against cv2 on the CPU.

Tolerances: the five-point solver's Es satisfy the cubic constraints
within 1e-9 and hold the true E within 1e-9; they equal cv2's solution
set within 1e-9 (cv2 finds its roots by ``solvePoly``, the port by the
companion matrix). ``find_essential_mat`` draws cv2's samples: on 20
seeded match sets (100-400 matches, 1e-3 noise, 30% outliers) the
inlier masks are equal and E equals cv2's up to sign within 1e-7 (1.1e-8
measured: cv2's iterated roots are the less exact), as after 1, 2 and 5
iterations. ``recover_pose`` equals
``cv2.recoverPose`` on the same E and mask: the count and mask equal, R
and t within 1e-9, wherever one candidate leads (with equal counts the
first in cv2's order wins, and cv2's SVD signs, not numpy's, label R1,
R2 and t: the distances below leave 47 or more points counted).
"""

import cv2
import numpy as np
import pytest

from spnerf_tpu_torch.eval import essential
from spnerf_tpu_torch.eval.cv_rng import CvRNG, draw_subset


def _rotation(rng, scale=0.2):
    w = rng.normal(0, scale, 3)
    theta = np.linalg.norm(w)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def _matches(seed, n, noise=1e-3, outliers=0.3):
    """Normalized matches of n points seen by two cameras, with
    Gaussian noise and a share of random outliers: (p1, p2, R, t)."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, n)]
    R = _rotation(rng)
    t = rng.normal(0, 1, 3)
    t *= 0.5 / np.linalg.norm(t)
    X2 = X @ R.T + t
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform(-0.5, 0.5, (int(bad.sum()), 2))
    return p1, p2, R, t


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def _sign_dist(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.mark.parametrize("seed", range(5))
def test_five_point_on_exact_sets(seed):
    p1, p2, R, t = _matches(100 + seed, 5, noise=0.0, outliers=0.0)
    Es, owner = essential.five_point(p1[None], p2[None])
    assert len(Es) >= 1 and (owner == 0).all()
    truth = _skew(t) @ R
    truth /= np.linalg.norm(truth)
    assert min(_sign_dist(E, truth) for E in Es) < 1e-9
    h1, h2 = np.c_[p1, np.ones(5)], np.c_[p2, np.ones(5)]
    for E in Es:
        assert abs(np.linalg.norm(E) - 1) < 1e-12
        assert abs(np.linalg.det(E)) < 1e-9
        EEt = E @ E.T
        assert np.abs(2 * EEt @ E - np.trace(EEt) * E).max() < 1e-9
        assert np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max() < 1e-9
    want, mask = cv2.findEssentialMat(p1, p2, np.eye(3), method=cv2.RANSAC,
                                      prob=0.99999, threshold=1e-3)
    got, got_mask = essential.find_essential_mat(p1, p2, 1e-3, prob=0.99999)
    assert len(got) == len(want) // 3 == len(Es)
    for E in want.reshape(-1, 3, 3):
        assert min(_sign_dist(E, F) for F in got) < 1e-9
    np.testing.assert_array_equal(got_mask, mask)


@pytest.fixture(scope="module")
def match_sets():
    rng = np.random.default_rng(7)
    return [_matches(seed, int(rng.integers(100, 400))) for seed in range(20)]


def test_find_essential_mat_against_cv2(match_sets):
    worst = 0.0
    for p1, p2, _, _ in match_sets:
        want, want_mask = cv2.findEssentialMat(
            p1, p2, np.eye(3), method=cv2.RANSAC, prob=0.99999,
            threshold=2e-3)
        got, mask = essential.find_essential_mat(p1, p2, 2e-3, prob=0.99999)
        assert got.shape == (1, 3, 3) and mask.shape == (len(p1), 1)
        assert mask.dtype == np.uint8
        np.testing.assert_array_equal(mask, want_mask)
        worst = max(worst, _sign_dist(got[0], want))
    assert worst < 1e-7


@pytest.mark.parametrize("max_iters", [1, 2, 5])
def test_find_essential_mat_draws_cv2_samples(match_sets, max_iters):
    for p1, p2, _, _ in match_sets[:6]:
        want, want_mask = cv2.findEssentialMat(
            p1, p2, np.eye(3), method=cv2.RANSAC, prob=0.99999,
            threshold=2e-3, maxIters=max_iters)
        got, mask = essential.find_essential_mat(
            p1, p2, 2e-3, prob=0.99999, max_iters=max_iters)
        np.testing.assert_array_equal(mask, want_mask)
        assert _sign_dist(got[0], want) < 1e-7


@pytest.mark.parametrize("distance", [50.0, 10.0])
def test_recover_pose_equals_cv2(match_sets, distance):
    """The same E and mask into both; also without a mask."""
    for p1, p2, _, _ in match_sets:
        E, mask = cv2.findEssentialMat(p1, p2, np.eye(3), method=cv2.RANSAC,
                                       prob=0.99999, threshold=2e-3)
        for given in (mask, None):
            kw = {} if given is None else {"mask": given.copy()}
            n, R, t, m, _ = cv2.recoverPose(E, p1, p2, np.eye(3),
                                            distanceThresh=distance, **kw)
            got = essential.recover_pose(E, p1, p2, distance, given)
            assert got[0] == n
            np.testing.assert_array_equal(got[3], m)
            np.testing.assert_allclose(got[1], R, rtol=0, atol=1e-9)
            np.testing.assert_allclose(got[2], t, rtol=0, atol=1e-9)


def test_fewer_than_five_points_give_none():
    p1, p2, _, _ = _matches(3, 4)
    assert essential.find_essential_mat(p1, p2, 1e-3) == (None, None)
    assert cv2.findEssentialMat(p1, p2, np.eye(3), method=cv2.RANSAC,
                                threshold=1e-3) == (None, None)


def test_generators():
    """OpenCV's generator and subset draws; a numpy generator may stand in
    for the draws; ``find_essential_mat`` seeds OpenCV's afresh at every
    call, so its results repeat, as cv2's do."""
    rng = CvRNG()  # state (2^32 - 1) * 4164903690 + (2^32 - 1), ...
    assert [rng.next() for _ in range(3)] == [
        130063605, 3133359004, 2578348940]
    assert CvRNG(0).state == 2**32 - 1
    rng = CvRNG()
    idx = draw_subset(rng, 3, 3)
    assert sorted(idx.tolist()) == [0, 1, 2]
    a = draw_subset(np.random.default_rng(5), 40, 5)
    assert len(set(a.tolist())) == 5
    np.testing.assert_array_equal(
        a, draw_subset(np.random.default_rng(5), 40, 5))
    p1, p2, _, _ = _matches(11, 150)
    first = essential.find_essential_mat(p1, p2, 2e-3, prob=0.99999)
    second = essential.find_essential_mat(p1, p2, 2e-3, prob=0.99999)
    np.testing.assert_array_equal(first[0], second[0])
    np.testing.assert_array_equal(first[1], second[1])
    _, want_mask = cv2.findEssentialMat(p1, p2, np.eye(3), method=cv2.RANSAC,
                                        prob=0.99999, threshold=2e-3)
    np.testing.assert_array_equal(first[1], want_mask)


@pytest.mark.parametrize("seed", range(4))
def test_find_essential_mat_on_row_aligned_matches(seed):
    """Matches of a sideways motion on integer pixels, most on the same
    row in both images: samples whose polynomial loses its leading
    coefficient or keeps a root near infinity. The masks as cv2's."""
    rng = np.random.default_rng(50 + seed)
    n, f = 160, 120.0
    y = rng.integers(4, 92, n).astype(float)
    x0 = rng.integers(4, 124, n).astype(float)
    x1 = x0 - rng.integers(1, 12, n)
    y1 = y.copy()
    bad = rng.random(n) < 0.15
    x1[bad], y1[bad] = rng.integers(4, 124, bad.sum()), rng.integers(
        4, 92, bad.sum())
    p1 = np.stack([(x0 - 64) / f, (y - 48) / f], -1)
    p2 = np.stack([(x1 - 64) / f, (y1 - 48) / f], -1)
    want, want_mask = cv2.findEssentialMat(
        p1, p2, np.eye(3), method=cv2.RANSAC, prob=0.99999,
        threshold=1 / f)
    got, mask = essential.find_essential_mat(p1, p2, 1 / f, prob=0.99999)
    np.testing.assert_array_equal(mask, want_mask)
    assert _sign_dist(got[0], want) < 1e-7
