"""Essential-matrix RANSAC and pose recovery in numpy: the port's
counterparts of ``cv2.findEssentialMat(p0, p1, np.eye(3),
method=cv2.RANSAC, prob=p, threshold=t)`` and ``cv2.recoverPose(E, p0,
p1, np.eye(3), ..., mask=m)`` on normalized image coordinates.

What cv2 5.0 runs for ``method=cv2.RANSAC`` is the classic registrator
(``RANSACPointSetRegistrator`` over ``EMEstimatorCallback``), not USAC:
its result is one of the minimal solutions of the samples that OpenCV's
generator draws, seeded afresh at every call (``eval/cv_rng.py``), and
this module draws the same samples. Per iteration:

- five distinct matches (no sample test);
- the five-point solver (``five_point``, after OpenCV's
  ``five-point.cpp``): the 4-dimensional null space of the 5 x 9
  epipolar system, the 10 x 20 matrix of the cubic constraints det E = 0
  and 2 E E^T E - tr(E E^T) E = 0 reduced by Gauss-Jordan, a degree-10
  polynomial in z from a 3 x 3 determinant, and one E per real root
  (|imag| <= 1e-10), normalized;
- each model scored by the squared Sampson error of every match,
  rounded to float32, against the threshold squared; the first model
  with the most inliers (at least 5) is kept;
- the iteration count adapted to the best inlier share
  (``RANSACUpdateNumIters``, 5-point models), at most ``max_iters``.

The best model is returned as it is, with its inlier mask: cv2 takes no
refit after this RANSAC. Five matches exactly return every solution.

The roots come from the eigenvalues of the companion matrix
(``np.roots``' route) where OpenCV iterates ``solvePoly``; the null
space comes from numpy's SVD. Both are other routes to the same numbers,
so the models agree with cv2's to rounding (1e-15 to 1e-8 on the tests'
sets), and a match whose error lies that close to the threshold may
decide otherwise. Two more of ``solvePoly``'s ways are kept, which
decide on degenerate samples (for instance matches on the same image row
in both images, which a sideways motion fits exactly): leading
coefficients within DBL_EPSILON of zero are dropped and their root slots
hold 0, a real root; and a root near infinity (|z| > 1e8, where the
(x, y, 1) null vector of the 3 x 3 system has its last entry below
1e-10), which ``solvePoly``'s iteration leaves large but finite and so
keeps, gives its E in homogeneous form. The roots come in another order
than ``solvePoly``'s, so of two models of one sample with equal counts
(and of the several Es of exactly five matches) another may come first.
"""

from __future__ import annotations

import numpy as np

from spnerf_tpu_torch.eval.cv_rng import CvRNG, draw_subset
from spnerf_tpu_torch.eval.ransac import update_num_iters

MODEL_POINTS = 5
_CHUNK = 128  # samples solved at once
_HUGE_ROOT = 1e8
_DBL_EPSILON = float(np.finfo(np.float64).eps)

# Monomials of the cubic constraints in x, y, z, in the elimination
# order: after Gauss-Jordan on the first ten columns, rows 4-9 pair up as
# (m z, m) for m = x^2, y^2, xy, which yields the 3 x 3 system in z.
_MONOMIALS = ("xxx", "yyy", "xxy", "xyy", "xxz", "xx", "yyz", "yy", "xyz",
              "xy", "xzz", "xz", "x", "yzz", "yz", "y", "zzz", "zz", "z", "")
_LINEAR = ("x", "y", "z", "")


def _product_table(left, right, out):
    index = {"".join(sorted(m)): i for i, m in enumerate(out)}
    table = np.zeros((len(left), len(right), len(out)))
    for i, a in enumerate(left):
        for j, b in enumerate(right):
            table[i, j, index["".join(sorted(a + b))]] = 1.0
    return table


_QUADRATIC = tuple(sorted({"".join(sorted(a + b)) for a in _LINEAR
                           for b in _LINEAR}))
_MUL_11 = _product_table(_LINEAR, _LINEAR, _QUADRATIC)
_MUL_21 = _product_table(_QUADRATIC, _LINEAR, _MONOMIALS)


def _mul(a, b, table):
    return np.einsum("...i,...j,ijk->...k", a, b, table)


def _cubic_constraints(null: np.ndarray) -> np.ndarray:
    """(B, 4, 9) null-space rows (the E of x, y, z and 1) -> (B, 10, 20)
    coefficients of det E and 2 E E^T E - tr(E E^T) E."""
    E = null.transpose(0, 2, 1).reshape(-1, 3, 3, 4)
    EEt = sum(_mul(E[:, :, None, k], E[:, None, :, k], _MUL_11)
              for k in range(3))
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    cubic = (2 * sum(_mul(EEt[:, :, None, k], E[:, None, k, :], _MUL_21)
                     for k in range(3))
             - _mul(trace[:, None, None], E, _MUL_21))

    def minor(r0, c0, r1, c1):
        return (_mul(E[:, 1, r0], E[:, 2, c0], _MUL_11)
                - _mul(E[:, 1, r1], E[:, 2, c1], _MUL_11))

    det = (_mul(minor(1, 2, 2, 1), E[:, 0, 0], _MUL_21)
           - _mul(minor(0, 2, 2, 0), E[:, 0, 1], _MUL_21)
           + _mul(minor(0, 1, 1, 0), E[:, 0, 2], _MUL_21))
    return np.concatenate([det[:, None], cubic.reshape(-1, 9, 20)], 1)


def _polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Products of ascending coefficient arrays (B, n) and (B, m)."""
    out = np.zeros(a.shape[:-1] + (a.shape[-1] + b.shape[-1] - 1,))
    for i in range(a.shape[-1]):
        out[..., i:i + b.shape[-1]] += a[..., i:i + 1] * b
    return out


_PERMUTATIONS = (((0, 1, 2), 1), ((1, 2, 0), 1), ((2, 0, 1), 1),
                 ((0, 2, 1), -1), ((2, 1, 0), -1), ((1, 0, 2), -1))


def _real_roots(coeffs: np.ndarray):
    """Roots of each degree-10 polynomial (B, 11), ascending coefficients:
    (B, 10) real parts and a mask of the real ones (|imag| <= 1e-10).
    As OpenCV's ``solvePoly``, leading coefficients within DBL_EPSILON of
    zero are dropped and their root slots hold 0, a real root."""
    roots = np.zeros(coeffs.shape[:1] + (10,), complex)
    full = np.isfinite(coeffs).all(1) & (np.abs(coeffs[:, 10]) > _DBL_EPSILON)
    if full.any():
        companion = np.zeros((int(full.sum()), 10, 10))
        companion[:, 0] = -coeffs[full, 9::-1] / coeffs[full, 10:]
        companion[:, np.arange(1, 10), np.arange(9)] = 1.0
        roots[full] = np.linalg.eigvals(companion)
    for b in np.flatnonzero(~full):
        c = coeffs[b]
        if not np.isfinite(c).all():
            roots[b] = np.nan
            continue
        n = 10
        while n > 1 and abs(c[n]) <= _DBL_EPSILON:
            n -= 1
        roots[b, :n] = np.roots(c[n::-1]) if n > 1 or c[1] else np.nan
    real = np.abs(roots.imag) <= 1e-10
    return roots.real, real


def five_point(p1: np.ndarray, p2: np.ndarray):
    """Essential matrices of (B, 5, 2) normalized matches p1 -> p2 (x2^T E
    x1 = 0): ((M, 3, 3) unit-norm Es, (M,) index of each E's sample), in
    each sample's root order."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    Q = np.stack([x1 * x2, y1 * x2, x2, x1 * y2, y1 * y2, y2, x1, y1,
                  np.ones_like(x1)], -1)
    null = np.linalg.svd(Q, full_matrices=True)[2][:, 5:9]
    A = _cubic_constraints(null)
    lead, rest = A[:, :, :10], A[:, :, 10:]
    ok = np.abs(np.linalg.det(lead)) > 0
    G = np.zeros_like(rest)
    if ok.any():
        G[ok] = np.linalg.solve(lead[ok], rest[ok])
    # rows (m z, m) -> (z^3..1 of x, z^3..1 of y, z^4..1), descending
    upper, lower = G[:, 4::2], G[:, 5::2]
    Bz = np.zeros(G.shape[:1] + (3, 13))
    Bz[..., 1:4], Bz[..., 5:8], Bz[..., 9:13] = \
        upper[..., 0:3], upper[..., 3:6], upper[..., 6:10]
    Bz[..., 0:3] -= lower[..., 0:3]
    Bz[..., 4:7] -= lower[..., 3:6]
    Bz[..., 8:12] -= lower[..., 6:10]
    cols = [Bz[..., 3::-1], Bz[..., 7:3:-1], Bz[..., 12:7:-1]]  # ascending
    det = np.zeros(G.shape[:1] + (11,))
    for perm, sign in _PERMUTATIONS:
        term = _polymul(_polymul(cols[perm[0]][:, 0], cols[perm[1]][:, 1]),
                        cols[perm[2]][:, 2])
        det[:, :term.shape[1]] += sign * term
    z, real = _real_roots(det)
    real &= ok[:, None]
    sample, k = np.nonzero(real)
    z = z[sample, k]
    powers = z[:, None] ** np.arange(4, -1, -1)  # z^4..1
    Bs = Bz[sample]
    M3 = np.stack([(Bs[:, :, 0:4] * powers[:, None, 1:]).sum(-1),
                   (Bs[:, :, 4:8] * powers[:, None, 1:]).sum(-1),
                   (Bs[:, :, 8:13] * powers[:, None, :]).sum(-1)], -1)
    xy1 = np.linalg.svd(M3)[2][:, -1] if len(M3) else np.zeros((0, 3))
    v = xy1[:, 2]
    at_infinity = (np.abs(z) > _HUGE_ROOT) & (np.abs(v) < 1e-10)
    keep = (np.abs(v) >= 1e-10) | at_infinity
    sample, z, xy1, at_infinity = (sample[keep], z[keep], xy1[keep],
                                   at_infinity[keep])
    # the E of (x, y, z, 1); a root at infinity in homogeneous form (w -> 0)
    w = np.where(at_infinity, xy1[:, 2], 1.0)
    scale = np.where(at_infinity, 1.0, xy1[:, 2])
    coef = np.stack([xy1[:, 0] / scale, xy1[:, 1] / scale, z * w, w], 1)
    basis = null[sample]
    e = sum(basis[:, k] * coef[:, k:k + 1] for k in range(4))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e.reshape(-1, 3, 3), sample


def sampson_errors(E: np.ndarray, p1: np.ndarray,
                   p2: np.ndarray) -> np.ndarray:
    """(M, N) float32 squared Sampson errors of the (N, 2) matches under
    each of the (M, 3, 3) models, in the order of OpenCV's
    ``EMEstimatorCallback::computeError``."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    e = E[:, :, :, None]
    ex = [e[:, r, 0] * x1 + e[:, r, 1] * y1 + e[:, r, 2] for r in range(3)]
    etx = [e[:, 0, c] * x2 + e[:, 1, c] * y2 + e[:, 2, c] for c in range(2)]
    r = x2 * ex[0] + y2 * ex[1] + ex[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        err = r * r / (ex[0] * ex[0] + ex[1] * ex[1] + etx[0] * etx[0]
                       + etx[1] * etx[1])
    return err.astype(np.float32)


def find_essential_mat(points1, points2, threshold: float,
                       prob: float = 0.999, max_iters: int = 1000):
    """(E (k, 3, 3), inlier mask (N, 1) uint8) of the RANSAC essential
    matrix of normalized matches ``points1`` -> ``points2`` (N, 2), as
    ``cv2.findEssentialMat(points1, points2, np.eye(3),
    method=cv2.RANSAC, prob=prob, threshold=threshold,
    maxIters=max_iters)`` returns it (k = 1 but for exactly five matches);
    (None, None) where none is found."""
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    n = len(p1)
    if n < MODEL_POINTS or len(p2) != n:
        return None, None
    if n == MODEL_POINTS:
        Es, _ = five_point(p1[None], p2[None])
        if not len(Es):
            return None, None
        return Es, np.ones((n, 1), np.uint8)
    rng = CvRNG()
    limit = np.float32(threshold * threshold)
    niters = max(max_iters, 1)
    samples = np.stack([draw_subset(rng, n, MODEL_POINTS)
                        for _ in range(niters)])
    best, best_mask, best_count = None, None, 0
    it = 0
    while it < niters:
        stop = min(it + _CHUNK, niters)
        Es, owner = five_point(p1[samples[it:stop]], p2[samples[it:stop]])
        masks = sampson_errors(Es, p1, p2) <= limit
        counts = masks.sum(1)
        owner += it
        for i in range(it, stop):
            if i >= niters:
                break
            for m in np.flatnonzero(owner == i):
                if counts[m] > max(best_count, MODEL_POINTS - 1):
                    best, best_mask = Es[m], masks[m]
                    best_count = int(counts[m])
                    niters = update_num_iters(prob, (n - best_count) / n,
                                              MODEL_POINTS, niters)
            it = i + 1
    if best is None:
        return None, None
    return best[None], best_mask.astype(np.uint8)[:, None]


def decompose_essential(E: np.ndarray):
    """(R1, R2, t) of ``cv2.decomposeEssentialMat``: E = U S V^T with U
    and V^T made proper rotations, R1 = U W V^T, R2 = U W^T V^T, t =
    U[:, 2]."""
    U, _, Vt = np.linalg.svd(np.asarray(E, np.float64).reshape(3, 3))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2].copy()


def triangulate(P0: np.ndarray, P1: np.ndarray, p0: np.ndarray,
                p1: np.ndarray) -> np.ndarray:
    """(4, N) homogeneous points by the linear method of
    ``cv2.triangulatePoints``: the right singular vector of the smallest
    singular value of each point's 4 x 4 system."""
    rows = []
    for P, p in ((P0, p0), (P1, p1)):
        rows.append(p[:, :1] * P[2] - P[0])
        rows.append(p[:, 1:] * P[2] - P[1])
    return np.linalg.svd(np.stack(rows, 1))[2][:, -1].T


def recover_pose(E, points1, points2, distance_thresh: float = 50.0,
                 mask=None):
    """(count, R (3, 3), t (3, 1), mask (N, 1) uint8) of
    ``cv2.recoverPose(E, points1, points2, np.eye(3), distanceThresh,
    mask=mask)`` on normalized matches: the candidate of the four (R,
    +-t) with the most matches in front of both cameras and nearer than
    ``distance_thresh`` (among ``mask``'s nonzero entries), the first in
    cv2's order on a tie (where cv2's SVD signs, which label R1, R2 and
    t, may pick another). The mask keeps ``mask``'s value (255 without
    one) where a match counts, else 0."""
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    R1, R2, t = decompose_essential(E)
    P0 = np.eye(3, 4)
    keep = (np.full((len(p1), 1), 255, np.uint8) if mask is None
            else np.asarray(mask, np.uint8).reshape(-1, 1))
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        P = np.c_[R, tt]
        Q = triangulate(P0, P, p1, p2)
        with np.errstate(divide="ignore", invalid="ignore"):
            ok = Q[2] * Q[3] > 0
            Q = Q / Q[3]
            ok &= Q[2] < distance_thresh
            depth = P[2] @ Q
            ok &= (depth > 0) & (depth < distance_thresh)
        good = np.where(ok[:, None], keep, 0).astype(np.uint8)
        count = int(np.count_nonzero(good))
        if best is None or count > best[0]:
            best = (count, R, tt.reshape(3, 1), good)
    return best
