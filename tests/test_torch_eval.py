"""The port's HPatches evaluation (``eval/detector.py``,
``eval/descriptor.py``, ``eval/ransac.py``, ``eval/on_the_fly.py``)
against the JAX package's numpy code and cv2 on the CPU.

Tolerances: the detector metrics, the shared points and the mutual
matches exactly equal. The RANSAC homography draws cv2's samples (OpenCV's
generator, seeded at every call); its Levenberg-Marquardt polish is
OpenCV 4's, which cv2 5.0 stops by other rules. On 20 seeded match sets of
about 200 matches, 30% outliers and rounding noise (|e| <= 0.5 px per
axis) the inlier masks equal cv2's, as after 1, 2 and 5 iterations, and
the corners that H maps lie within 1e-4 px of cv2's after a full run
(2e-5 px measured; after 1-5 iterations the best model may hold only 5
or 6 inliers, where the two polishes part by up to 60 px, so only the
masks are held there),
so the reference's mean corner distance is met within 1e-4 px and its
``correctness`` on every set. With an explicit ``np.random.Generator``
(other draws) the estimate lies within 1 px mean corner error of the
true H wherever cv2's does.
"""

import cv2
import numpy as np
import pytest

from spnerf_tpu.eval import descriptor as jdesc
from spnerf_tpu.eval import detector as jdet
from spnerf_tpu.eval import on_the_fly as jotf
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.eval import descriptor as tdesc
from spnerf_tpu_torch.eval import detector as tdet
from spnerf_tpu_torch.eval import on_the_fly as totf
from spnerf_tpu_torch.eval import ransac

SHAPE = (120, 160)


def _heatmap(rng, shape=SHAPE, n=150, ties=False):
    prob = np.zeros(shape, np.float32)
    ys, xs = rng.integers(0, shape[0], n), rng.integers(0, shape[1], n)
    vals = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if ties:
        vals[: n // 3] = vals[0]
    prob[ys, xs] = vals
    return prob


def _homography(rng, scale=1.0):
    return np.eye(3) + scale * rng.normal(
        0, [[0.03, 0.03, 3.0], [0.03, 0.03, 3.0], [1e-4, 1e-4, 0]])


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (got != got and want != want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_detector_metrics_equal_jax(seed, ties):
    rng = np.random.default_rng(seed)
    prob, warped = _heatmap(rng, ties=ties), _heatmap(rng, ties=ties)
    kmap = _heatmap(rng, n=60) > 0
    H = _homography(rng)
    for k, d in ((300, 3), (50, 1), (10, 5)):
        _equal(tdet.repeatability_pair(prob, warped, H, k, d),
               jdet.repeatability_pair(prob, warped, H, k, d))
    _equal(tdet.repeatability_pair(np.zeros(SHAPE), warped, H),
           jdet.repeatability_pair(np.zeros(SHAPE), warped, H))
    for t, d in ((0.5, 2), (0.1, 4)):
        _equal(tdet.localization_error_pair(prob, kmap, t, d),
               jdet.localization_error_pair(prob, kmap, t, d))
    _equal(tdet.tp_fp_pair(prob, kmap), jdet.tp_fp_pair(prob, kmap))
    _equal(tdet.tp_fp_pair(prob, np.zeros(SHAPE, bool)),
           jdet.tp_fp_pair(prob, np.zeros(SHAPE, bool)))
    samples = [(prob, kmap), (warped, kmap), (np.zeros(SHAPE), kmap)]
    _equal(tdet.compute_pr_map(samples, 3), jdet.compute_pr_map(samples, 3))


def test_compute_repeatability_over_bundles_equals_jax(tmp_path,
                                                       monkeypatch):
    out = tmp_path / "repeatability" / "exp"
    out.mkdir(parents=True)
    rng = np.random.default_rng(9)
    for i in range(4):
        np.savez(out / f"p{i}.npz", prob=_heatmap(rng),
                 warped_prob=_heatmap(rng) * (i != 3),
                 homography=_homography(rng))
    monkeypatch.setattr(settings, "EXPER_PATH", tmp_path)
    monkeypatch.setattr(jdet, "EXPER_PATH", tmp_path)
    for k in (300, 20):
        assert tdet.compute_repeatability("exp", k) == \
            jdet.compute_repeatability("exp", k)


@pytest.mark.parametrize("seed", range(3))
def test_shared_points_and_mutual_matches_equal_jax(seed):
    rng = np.random.default_rng(seed + 10)
    prob, H = _heatmap(rng, ties=True), _homography(rng, 3.0)
    for k in (1000, 40):
        _equal(tdesc.keep_shared_points(prob, H, k),
               jdesc.keep_shared_points(prob, H, k))
    d1 = rng.standard_normal((70, 32)).astype(np.float32)
    d2 = np.concatenate([d1[:40] + 0.05 * rng.standard_normal((40, 32)),
                         rng.standard_normal((25, 32))]).astype(np.float32)
    _equal(tdesc.mutual_nn_match(d1, d2), jdesc.mutual_nn_match(d1, d2))
    _equal(tdesc.mutual_nn_match(d1[:0], d2), jdesc.mutual_nn_match(d1[:0],
                                                                     d2))


def _corner_error(H, H_true, shape=SHAPE):
    c = np.array([[0, 0, 1], [shape[1] - 1, 0, 1], [0, shape[0] - 1, 1],
                  [shape[1] - 1, shape[0] - 1, 1]], np.float64)
    a, b = c @ H_true.T, c @ H.T
    return float(np.linalg.norm(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:],
                                axis=1).mean())


def _match_set(seed, n=200, outliers=0.3, dim=32):
    """Heatmaps and dense descriptors of one pair whose ``n`` mutual
    matches hold ``outliers`` of wrong partners: (prob, warped_prob, desc,
    warped_desc, H)."""
    rng = np.random.default_rng(seed)
    H = _homography(rng, 2.0)
    h, w = SHAPE
    flat = rng.choice(h * w, 4 * n, replace=False)
    src = np.stack([flat // w, flat % w], -1)  # (y, x)
    proj = np.c_[src[:, ::-1], np.ones(len(src))] @ H.T
    dst = np.rint(proj[:, 1::-1] / proj[:, 2:]).astype(int)
    inside = ((dst >= 0) & (dst < SHAPE)).all(1)
    src, dst = src[inside], dst[inside]
    _, first = np.unique(dst[:, 0] * w + dst[:, 1], return_index=True)
    keep = np.sort(first)[:n]
    src, dst = src[keep], dst[keep]
    bad = rng.random(len(src)) < outliers
    taken = set(map(tuple, dst[~bad]))
    for i in np.flatnonzero(bad):
        while True:
            q = (int(rng.integers(0, h)), int(rng.integers(0, w)))
            if q not in taken:
                taken.add(q)
                dst[i] = q
                break
    prob = np.zeros(SHAPE, np.float32)
    warped = np.zeros(SHAPE, np.float32)
    prob[src[:, 0], src[:, 1]] = rng.uniform(0.1, 1, len(src))
    warped[dst[:, 0], dst[:, 1]] = rng.uniform(0.1, 1, len(dst))
    d = rng.standard_normal((len(src), dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    desc = np.zeros(SHAPE + (dim,), np.float32)
    wdesc = np.zeros(SHAPE + (dim,), np.float32)
    desc[src[:, 0], src[:, 1]] = d
    wdesc[dst[:, 0], dst[:, 1]] = d + 0.02 * rng.standard_normal(d.shape)
    return prob, warped, desc, wdesc, H


@pytest.fixture(scope="module")
def match_sets():
    return [_match_set(seed) for seed in range(20)]


def _matched_points(match_set):
    prob, warped, desc, wdesc, H = match_set
    m1 = tdesc.keep_shared_points(prob, H)
    m2 = tdesc.keep_shared_points(warped, np.linalg.inv(H))
    i1, i2 = tdesc.mutual_nn_match(desc[m1[:, 0], m1[:, 1]],
                                   wdesc[m2[:, 0], m2[:, 1]])
    return (m1[i1][:, ::-1].astype(np.float32),
            m2[i2][:, ::-1].astype(np.float32))


def _corner_distance(H1, H2, shape=SHAPE):
    """Largest distance between the image corners mapped by H1 and H2."""
    c = np.array([[0, 0, 1], [shape[1] - 1, 0, 1], [0, shape[0] - 1, 1],
                  [shape[1] - 1, shape[0] - 1, 1]], np.float64)
    a, b = c @ H1.T, c @ H2.T
    return float(np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max())


def test_ransac_homography_against_cv2(match_sets):
    """The estimator on the matched points alone against cv2's: OpenCV's
    draws give cv2's inliers and H; a numpy generator other draws."""
    worst, worst_rng = 0.0, 0.0
    for match_set in match_sets:
        H = match_set[-1]
        src, dst = _matched_points(match_set)
        assert len(src) >= 150
        want, want_mask = cv2.findHomography(src, dst, cv2.RANSAC,
                                             maxIters=3000)
        got, mask = ransac.find_homography(src, dst)
        assert got.shape == (3, 3) and got[2, 2] == 1.0
        assert mask.dtype == np.uint8 and mask.shape == (len(src),)
        np.testing.assert_array_equal(mask, want_mask.ravel())
        worst = max(worst, _corner_distance(got, want))
        got, _ = ransac.find_homography(src, dst, np.random.default_rng(0))
        e_cv2, e_port = _corner_error(want, H), _corner_error(got, H)
        if e_cv2 <= 1.0:
            assert e_port <= 1.0, (e_port, e_cv2)
        worst_rng = max(worst_rng, abs(e_port - e_cv2))
    assert worst < 1e-4
    assert worst_rng < 0.5


@pytest.mark.parametrize("max_iters", [1, 2, 5])
def test_ransac_homography_draws_cv2_samples(match_sets, max_iters):
    for match_set in match_sets[:8]:
        src, dst = _matched_points(match_set)
        _, want_mask = cv2.findHomography(src, dst, cv2.RANSAC,
                                          maxIters=max_iters)
        _, mask = ransac.find_homography(src, dst, max_iters=max_iters)
        np.testing.assert_array_equal(mask, want_mask.ravel())


def test_ransac_refuses_too_few_or_degenerate_points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, (3, 2))
    assert ransac.find_homography(pts, pts, rng) == (None, None)
    line = np.stack([np.arange(10.0), 2 * np.arange(10.0)], -1)
    assert ransac.find_homography(line, line + 1, rng) == (None, None)
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10.0]])
    H, mask = ransac.find_homography(square, square * 2 + 5, rng)
    np.testing.assert_allclose(H, [[2, 0, 5], [0, 2, 5], [0, 0, 1]],
                               atol=1e-9)
    assert mask.tolist() == [1, 1, 1, 1]
    assert ransac.update_num_iters(0.995, 0.3, 4, 3000) == int(round(
        np.log(0.005) / np.log(1 - 0.7 ** 4)))
    assert ransac.update_num_iters(0.995, 0.99, 4, 3000) == 3000


def test_homography_estimation_against_jax(match_sets):
    """compute_homography_estimation: the same points, matches, matching
    score, inliers and correctness as the reference (cv2 inside), the
    mean corner distance within 1e-4 px."""
    for prob, warped, desc, wdesc, H in match_sets:
        want = jdesc.compute_homography_estimation(prob, warped, desc, wdesc,
                                                   H)
        got = tdesc.compute_homography_estimation(prob, warped, desc, wdesc,
                                                  H)
        for key in ("keypoints1", "keypoints2", "matches"):
            _equal(got[key], want[key])
        np.testing.assert_array_equal(got["inliers"], want["inliers"])
        assert got["matching_score"] == want["matching_score"]
        assert got["correctness"] == want["correctness"]
        assert abs(got["mean_dist"] - want["mean_dist"]) < 1e-4


def test_homography_estimation_over_bundles(tmp_path, monkeypatch,
                                            match_sets):
    out = tmp_path / "descriptors" / "exp"
    out.mkdir(parents=True)
    for i, (prob, warped, desc, wdesc, H) in enumerate(match_sets[:3]):
        np.savez(out / f"p{i}.npz", prob=prob, warped_prob=warped, desc=desc,
                 warped_desc=wdesc, homography=H)
    monkeypatch.setattr(settings, "EXPER_PATH", tmp_path)
    monkeypatch.setattr(jdesc, "EXPER_PATH", tmp_path)
    got = tdesc.homography_estimation("exp")
    assert got == jdesc.homography_estimation("exp")
    assert got == tdesc.homography_estimation("exp")  # repeatable


def test_bootstrap_ci_equals_jax():
    rng = np.random.default_rng(0)
    for vals in (rng.uniform(0.4, 0.8, 30), [0.5], [0.5, 0.5, 0.5], []):
        _equal(totf.bootstrap_ci(vals), jotf.bootstrap_ci(vals))


def test_json_out_appends_tagged_record(tmp_path, monkeypatch):
    import json

    cfg = tmp_path / "c.yaml"
    cfg.write_text("pretrained: 'x/x_1.ckpt'\n")
    monkeypatch.setattr(totf, "run_repeatability",
                        lambda config, k, d, device: {
                            "repeatability": 0.5, "device": device,
                            "repeatability_ci95": [0.4, 0.6], "pairs": 3})
    out = tmp_path / "q.jsonl"
    for _ in range(2):  # appends, never truncates
        totf.main(["--config-path", str(cfg), "--mode", "repeatability",
                   "--json-out", str(out), "--device", "cpu"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2
    assert recs[0] == {"mode": "repeatability", "pretrained": "x/x_1.ckpt",
                       "repeatability": 0.5, "device": "cpu",
                       "repeatability_ci95": [0.4, 0.6], "pairs": 3}
