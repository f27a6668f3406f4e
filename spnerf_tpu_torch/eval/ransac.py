"""RANSAC homography estimation in numpy: the port's counterpart of
``cv2.findHomography(src, dst, cv2.RANSAC, 3.0, maxIters=3000)``.

It follows OpenCV 5.0's estimator (``findHomography`` and
``RANSACPointSetRegistrator``):

- 4-point samples drawn by OpenCV's own generator, seeded afresh at
  every call (``eval/cv_rng.py``), so the samples are cv2's; a sample is
  redrawn (up to 10,000 times) when its last point is collinear with two
  others in either image, or when the orientation of its triangles
  agrees between the two images for some and not for others (a folded
  quadrilateral);
- the model of a sample by the normalised DLT: both point sets moved to
  their centroid and scaled by their mean absolute deviation per axis,
  H the eigenvector of the smallest eigenvalue of L^T L, normalised to
  H[2, 2] = 1;
- inliers where the squared reprojection error dst - H(src), computed in
  float32 from H rounded to float32, is at most the threshold squared;
  the best model is the first with the most;
- the iteration count adapted to the best inlier share at confidence
  0.995 (``RANSACUpdateNumIters``), at most ``max_iters``;
- the best model refit by the same DLT on all its inliers, polished by at
  most 10 Levenberg-Marquardt steps on their reprojection error, and the
  inliers taken again under the polished H.

The Levenberg-Marquardt steps are OpenCV 4's (``LMSolver``); OpenCV 5
stops its own solver by other rules, so the polished H lies within about
1e-5 (relative) of cv2's and an inlier whose error lies that close to
the threshold may differ. Everything before the polish repeats cv2 to
rounding. A ``np.random.Generator`` passed as ``rng`` replaces OpenCV's
generator (the draws then differ from cv2's).
"""

from __future__ import annotations

import math

import numpy as np

from spnerf_tpu_torch.eval.cv_rng import CvRNG, draw_subset

_FLT_EPSILON = float(np.finfo(np.float32).eps)
_DBL_EPSILON = float(np.finfo(np.float64).eps)
_MAX_SAMPLE_TRIES = 10000  # OpenCV's draws for one valid sample
_TRIANGLES = ((0, 1, 2), (1, 2, 3), (0, 2, 3), (1, 3, 0))
_LM_STEPS = 10


def dlt_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
    """The homography mapping ``src`` (N, 2) onto ``dst`` (N, 2), N >= 4,
    by the normalised DLT; None for a degenerate point set."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    c_src, c_dst = src.mean(0), dst.mean(0)
    s_src = np.abs(src - c_src).sum(0)
    s_dst = np.abs(dst - c_dst).sum(0)
    if (s_src < _DBL_EPSILON).any() or (s_dst < _DBL_EPSILON).any():
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
    """Whether the last point lies on a line through two of the others
    (OpenCV's ``haveCollinearPoints``)."""
    i = len(pts) - 1
    for j in range(i):
        d1 = pts[j] - pts[i]
        for k in range(j):
            d2 = pts[k] - pts[i]
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
    """Squared distances between ``dst`` and ``src`` mapped by ``H``
    (H[2, 2] = 1), in float32 from H rounded to float32, as OpenCV's
    ``HomographyEstimatorCallback::computeError``."""
    h = H.ravel().astype(np.float32)
    M = src.astype(np.float32)
    m = dst.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = np.float32(1) / (h[6] * M[:, 0] + h[7] * M[:, 1] + np.float32(1))
        dx = (h[0] * M[:, 0] + h[1] * M[:, 1] + h[2]) * w - m[:, 0]
        dy = (h[3] * M[:, 0] + h[4] * M[:, 1] + h[5]) * w - m[:, 1]
        return dx * dx + dy * dy


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


def _refine_residuals(h: np.ndarray, src: np.ndarray, dst: np.ndarray,
                      jacobian: bool):
    """Residuals (2N,) of H = [h, 1] and their (2N, 8) Jacobian
    (OpenCV's ``HomographyRefineCallback``)."""
    mx, my = src[:, 0], src[:, 1]
    w = h[6] * mx + h[7] * my + 1.0
    small = np.abs(w) <= _DBL_EPSILON
    w = np.where(small, 0.0, 1.0 / np.where(small, 1.0, w))
    xi = (h[0] * mx + h[1] * my + h[2]) * w
    yi = (h[3] * mx + h[4] * my + h[5]) * w
    r = np.stack([xi - dst[:, 0], yi - dst[:, 1]], 1).ravel()
    if not jacobian:
        return r, None
    J = np.zeros((len(src), 2, 8))
    J[:, 0, 0], J[:, 0, 1], J[:, 0, 2] = mx * w, my * w, w
    J[:, 0, 6], J[:, 0, 7] = -mx * w * xi, -my * w * xi
    J[:, 1, 3], J[:, 1, 4], J[:, 1, 5] = mx * w, my * w, w
    J[:, 1, 6], J[:, 1, 7] = -mx * w * yi, -my * w * yi
    return r, J.reshape(-1, 8)


def polish_homography(H: np.ndarray, src: np.ndarray, dst: np.ndarray,
                      max_steps: int = _LM_STEPS) -> np.ndarray:
    """H refined by OpenCV 4's Levenberg-Marquardt (``LMSolver``, eps
    FLT_EPSILON) on the reprojection error of ``src`` -> ``dst``."""
    x = H.ravel()[:8].copy()
    r, J = _refine_residuals(x, src, dst, True)
    S = r @ r
    A, v = J.T @ J, J.T @ r
    D = np.diag(A).copy()
    lam, lc = 1.0, 0.75
    for step in range(1, max_steps + 1):
        try:
            d = np.linalg.solve(A + np.diag(lam * D), v)
        except np.linalg.LinAlgError:
            d = np.linalg.pinv(A + np.diag(lam * D)) @ v
        xd = x - d
        rd, _ = _refine_residuals(xd, src, dst, False)
        Sd = rd @ rd
        dS = d @ (2 * v - A @ d)
        R = (S - Sd) / (dS if abs(dS) > _DBL_EPSILON else 1.0)
        if R > 0.75:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif R < 0.25:
            t = d @ v
            nu = min(max((Sd - S) / (t if abs(t) > _DBL_EPSILON else 1.0)
                         + 2.0, 2.0), 10.0)
            if lam == 0.0:
                inv = np.linalg.inv(A)
                lam = lc = 1.0 / max(_DBL_EPSILON, np.abs(np.diag(inv)).max())
                nu *= 0.5
            lam *= nu
        if Sd < S:
            S, x = Sd, xd
            r, J = _refine_residuals(x, src, dst, True)
            A, v = J.T @ J, J.T @ r
        if np.abs(d).max() < _FLT_EPSILON or np.abs(r).max() < _FLT_EPSILON:
            break
    return np.append(x, 1.0).reshape(3, 3)


def find_homography(src, dst, rng=None, threshold: float = 3.0,
                    confidence: float = 0.995, max_iters: int = 3000):
    """(H (3, 3) float64 with H[2, 2] = 1, inlier mask (N,) uint8) of the
    RANSAC homography from ``src`` (N, 2) to ``dst`` (N, 2), or (None,
    None) where none is found (fewer than 4 points, no valid sample).
    ``rng``: None for OpenCV's draws, else a ``CvRNG`` or a
    ``np.random.Generator`` that the draws continue from."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    n = len(src)
    if n < 4 or len(dst) != n:
        return None, None
    if n == 4:
        H = dlt_homography(src, dst)
        return (None, None) if H is None else (H, np.ones(4, np.uint8))
    rng = CvRNG() if rng is None else rng
    limit = np.float32(threshold * threshold)
    best, best_mask, best_count = None, None, 0
    niters, it = max(max_iters, 1), 0
    while it < niters:
        for _ in range(_MAX_SAMPLE_TRIES):
            idx = draw_subset(rng, n, 4)
            if _valid_sample(src[idx], dst[idx]):
                break
        else:
            if it == 0:
                return None, None
            break
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
    best = polish_homography(best, src[best_mask], dst[best_mask])
    mask = reprojection_errors(best, src, dst) <= limit
    return best, mask.astype(np.uint8)
