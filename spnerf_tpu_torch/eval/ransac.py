"""RANSAC homography estimation in numpy: the port's counterpart of
``cv2.findHomography(src, dst, cv2.RANSAC, 3.0, maxIters=3000)``.

It follows OpenCV's estimator (``calib3d/src/fundam.cpp``, ``ptsetreg.cpp``):

- 4-point samples drawn from an explicit ``np.random.Generator``; a
  sample is skipped when three of its points are collinear in either
  image, or when the orientation of its triangles agrees between the two
  images for some and not for others (a folded quadrilateral);
- the model of a sample by the normalised DLT: both point sets moved to
  their centroid and scaled by their mean absolute deviation per axis,
  H the eigenvector of the smallest eigenvalue of L^T L, normalised to
  H[2, 2] = 1;
- inliers where the squared reprojection error dst - H(src) is at most
  the threshold squared; the best model is the one with the most;
- the iteration count adapted to the best inlier share at confidence
  0.995 (``RANSACUpdateNumIters``), at most ``max_iters``;
- the best model refit by the same DLT on all its inliers.

OpenCV then polishes H by 10 Levenberg-Marquardt steps on the inliers'
reprojection error; that step is not taken here. Its own random draws
cannot be repeated, so estimates agree with cv2's within a tolerance, not
to the bit.
"""

from __future__ import annotations

import math

import numpy as np

_FLT_EPSILON = float(np.finfo(np.float32).eps)
_MAX_SAMPLE_TRIES = 10000  # OpenCV's draws for one valid sample
_TRIANGLES = ((0, 1, 2), (1, 2, 3), (0, 2, 3), (0, 1, 3))


def dlt_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
    """The homography mapping ``src`` (N, 2) onto ``dst`` (N, 2), N >= 4,
    by the normalised DLT; None for a degenerate point set."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    c_src, c_dst = src.mean(0), dst.mean(0)
    s_src = np.abs(src - c_src).sum(0)
    s_dst = np.abs(dst - c_dst).sum(0)
    if (s_src < _FLT_EPSILON).any() or (s_dst < _FLT_EPSILON).any():
        return None
    s_src, s_dst = n / s_src, n / s_dst
    X, Y = ((src - c_src) * s_src).T
    x, y = ((dst - c_dst) * s_dst).T
    zeros, ones = np.zeros(n), np.ones(n)
    lx = np.stack([X, Y, ones, zeros, zeros, zeros, -x * X, -x * Y, -x], 1)
    ly = np.stack([zeros, zeros, zeros, X, Y, ones, -y * X, -y * Y, -y], 1)
    ltl = lx.T @ lx + ly.T @ ly
    _, vecs = np.linalg.eigh(ltl)
    h0 = vecs[:, 0].reshape(3, 3)
    inv_norm_dst = np.array([[1 / s_dst[0], 0, c_dst[0]],
                             [0, 1 / s_dst[1], c_dst[1]], [0, 0, 1]])
    norm_src = np.array([[s_src[0], 0, -c_src[0] * s_src[0]],
                         [0, s_src[1], -c_src[1] * s_src[1]], [0, 0, 1]])
    H = inv_norm_dst @ h0 @ norm_src
    if abs(H[2, 2]) < np.finfo(np.float64).tiny:
        return None
    return H / H[2, 2]


def _collinear(pts: np.ndarray) -> bool:
    """Whether any three of the points lie on a line (OpenCV's test)."""
    n = len(pts)
    for k in range(n):
        for i in range(k):
            for j in range(i):
                d1 = pts[i] - pts[j]
                d2 = pts[k] - pts[j]
                if abs(d2[0] * d1[1] - d2[1] * d1[0]) <= _FLT_EPSILON * (
                        abs(d1[0]) + abs(d1[1]) + abs(d2[0]) + abs(d2[1])):
                    return True
    return False


def _valid_sample(src: np.ndarray, dst: np.ndarray) -> bool:
    if _collinear(src) or _collinear(dst):
        return False
    negative = 0
    for t in _TRIANGLES:
        a = np.c_[src[list(t)], np.ones(3)]
        b = np.c_[dst[list(t)], np.ones(3)]
        negative += np.linalg.det(a) * np.linalg.det(b) < 0
    return negative in (0, 4)


def reprojection_errors(H: np.ndarray, src: np.ndarray,
                        dst: np.ndarray) -> np.ndarray:
    """Squared distances between ``dst`` and ``src`` mapped by ``H``."""
    w = 1.0 / (src @ H[2, :2] + H[2, 2])
    px = (src @ H[0, :2] + H[0, 2]) * w
    py = (src @ H[1, :2] + H[1, 2]) * w
    return (px - dst[:, 0]) ** 2 + (py - dst[:, 1]) ** 2


def update_num_iters(confidence: float, outlier_share: float,
                     model_points: int, max_iters: int) -> int:
    """OpenCV's ``RANSACUpdateNumIters``."""
    p = min(max(confidence, 0.0), 1.0)
    ep = min(max(outlier_share, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def find_homography(src, dst, rng: np.random.Generator,
                    threshold: float = 3.0, confidence: float = 0.995,
                    max_iters: int = 3000):
    """(H (3, 3) float64 with H[2, 2] = 1, inlier mask (N,) uint8) of the
    RANSAC homography from ``src`` (N, 2) to ``dst`` (N, 2), or (None,
    None) where none is found (fewer than 4 points, no valid sample)."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    n = len(src)
    if n < 4 or len(dst) != n:
        return None, None
    limit = threshold * threshold
    best, best_mask, best_count = None, None, 0
    niters, it = max_iters, 0
    while it < niters:
        if n > 4:
            for _ in range(_MAX_SAMPLE_TRIES):
                idx = rng.choice(n, 4, replace=False)
                if _valid_sample(src[idx], dst[idx]):
                    break
            else:
                if it == 0:
                    return None, None
                break
        else:
            idx = np.arange(4)
        H = dlt_homography(src[idx], dst[idx])
        if H is not None:
            mask = reprojection_errors(H, src, dst) <= limit
            count = int(mask.sum())
            if count > max(best_count, 3):
                best, best_mask, best_count = H, mask, count
                niters = update_num_iters(confidence, (n - count) / n, 4,
                                          niters)
        it += 1
    if best is None:
        return None, None
    refit = dlt_homography(src[best_mask], dst[best_mask])
    if refit is not None:
        best = refit
    return best, best_mask.astype(np.uint8)
