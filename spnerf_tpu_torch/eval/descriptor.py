"""Descriptor evaluation: homography estimation correctness + matching
score (``spnerf_tpu/eval/descriptor.py``).

Mutual-nearest-neighbor (cross-check) matching is a dense distance
matrix + argmin both ways in numpy, host-side by design, like the RANSAC
homography. Where the reference calls ``cv2.findHomography`` with RANSAC,
the port runs its own estimator (``eval/ransac.py``) with cv2's defaults,
drawing OpenCV's samples.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.eval.detector import select_k_best, warp_keypoints_yx
from spnerf_tpu_torch.eval.ransac import find_homography


def keep_shared_points(keypoint_map, H, keep_k_points=1000):
    """Top-k detections that remain inside the other view under H
    (reference descriptor_evaluation.py:17-54). Returns int (N, 2) (y, x)."""
    ys, xs = np.where(keypoint_map > 0)
    prob = keypoint_map[ys, xs]
    pts = np.stack([ys, xs, prob], axis=-1)
    if len(pts):
        warped = warp_keypoints_yx(pts[:, :2], H)
        shape = keypoint_map.shape
        m = (
            (warped[:, 0] >= 0) & (warped[:, 0] < shape[0])
            & (warped[:, 1] >= 0) & (warped[:, 1] < shape[1])
        )
        pts = pts[m]
    pts = select_k_best(pts, keep_k_points) if len(pts) else np.zeros((0, 2))
    return pts.astype(int)


def mutual_nn_match(desc1: np.ndarray, desc2: np.ndarray):
    """Cross-checked nearest-neighbor matches (equivalent of
    cv2.BFMatcher(NORM_L2, crossCheck=True).match). Returns (idx1, idx2)."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    # ||a-b||^2 = |a|^2 + |b|^2 - 2ab
    d2 = (
        (desc1**2).sum(1)[:, None]
        + (desc2**2).sum(1)[None]
        - 2.0 * desc1 @ desc2.T
    )
    nn12 = d2.argmin(1)
    nn21 = d2.argmin(0)
    idx1 = np.arange(len(desc1))
    mutual = nn21[nn12] == idx1
    return idx1[mutual], nn12[mutual]


def compute_homography_estimation(
    prob: np.ndarray,
    warped_prob: np.ndarray,
    desc: np.ndarray,
    warped_desc: np.ndarray,
    real_H: np.ndarray,
    keep_k_points: int = 1000,
    correctness_thresh: float = 3.0,
) -> dict:
    """One-pair homography estimation (reference
    descriptor_evaluation.py:55-128): shared top-k points, mutual-NN
    match on dense descriptors, RANSAC homography (OpenCV's samples),
    corner-error correctness + matching score."""
    shape = prob.shape
    keypoints = keep_shared_points(prob, real_H, keep_k_points)
    warped_keypoints = keep_shared_points(
        warped_prob, np.linalg.inv(real_H), keep_k_points
    )
    if len(keypoints) == 0 or len(warped_keypoints) == 0:
        return {"correctness": 0.0, "matching_score": 0.0, "homography": None,
                "keypoints1": keypoints, "keypoints2": warped_keypoints,
                "matches": np.zeros((0, 2), int), "inliers": np.zeros(0)}

    d1 = desc[keypoints[:, 0], keypoints[:, 1]]
    d2 = warped_desc[warped_keypoints[:, 0], warped_keypoints[:, 1]]
    i1, i2 = mutual_nn_match(d1.astype(np.float32), d2.astype(np.float32))
    if len(i1) < 4:
        return {"correctness": 0.0, "matching_score": 0.0, "homography": None,
                "keypoints1": keypoints, "keypoints2": warped_keypoints,
                "matches": np.stack([i1, i2], -1), "inliers": np.zeros(0)}

    m1 = keypoints[i1]
    m2 = warped_keypoints[i2]
    H, inliers = find_homography(
        m1[:, ::-1].astype(np.float32), m2[:, ::-1].astype(np.float32),
        max_iters=3000,
    )
    if H is None:
        return {"correctness": 0.0, "matching_score": 0.0, "homography": None,
                "keypoints1": keypoints, "keypoints2": warped_keypoints,
                "matches": np.stack([i1, i2], -1), "inliers": np.zeros(0)}

    corners = np.array(
        [[0, 0, 1], [shape[1] - 1, 0, 1], [0, shape[0] - 1, 1],
         [shape[1] - 1, shape[0] - 1, 1]], np.float64,
    )
    real_warped = corners @ real_H.T
    real_warped = real_warped[:, :2] / real_warped[:, 2:]
    est_warped = corners @ H.T
    est_warped = est_warped[:, :2] / est_warped[:, 2:]
    mean_dist = float(np.mean(np.linalg.norm(real_warped - est_warped, axis=1)))

    return {
        "correctness": float(mean_dist <= correctness_thresh),
        "matching_score": len(m1) / len(keypoints),
        "mean_dist": mean_dist,
        "homography": H,
        "keypoints1": keypoints,
        "keypoints2": warped_keypoints,
        "matches": np.stack([i1, i2], -1),
        "inliers": inliers.flatten() if inliers is not None else np.zeros(0),
    }


def homography_estimation(
    exper_name: str, keep_k_points: int = 1000, correctness_thresh: float = 3.0,
):
    """Mean correctness + matching score over an exported experiment
    (reference descriptor_evaluation.py:129-143); the RANSAC samples are
    OpenCV's."""
    paths = sorted(Path(settings.EXPER_PATH, "descriptors", exper_name)
                   .glob("*.npz"))
    correctness, mscores = [], []
    for path in paths:
        data = np.load(path)
        est = compute_homography_estimation(
            data["prob"], data["warped_prob"], data["desc"],
            data["warped_desc"], data["homography"],
            keep_k_points, correctness_thresh,
        )
        correctness.append(est["correctness"])
        mscores.append(est["matching_score"])
    return (
        float(np.mean(correctness)) if correctness else 0.0,
        float(np.mean(mscores)) if mscores else 0.0,
    )
