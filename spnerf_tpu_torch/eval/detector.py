"""Offline detector evaluation: PR / mAP / localization error /
repeatability (``spnerf_tpu/eval/detector.py``, the same numpy code).

Host-side numpy over exported ``.npz`` bundles, with array-level APIs so
the same metrics run in memory in tests and in the on-the-fly evaluation
(``eval/on_the_fly.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings


def warp_keypoints_xy(points_xy: np.ndarray, H: np.ndarray) -> np.ndarray:
    homog = np.concatenate([points_xy, np.ones((len(points_xy), 1))], axis=1)
    warped = homog @ H.T
    return warped[:, :2] / warped[:, 2:]


def warp_keypoints_yx(points_yx: np.ndarray, H: np.ndarray) -> np.ndarray:
    return warp_keypoints_xy(points_yx[:, ::-1], H)[:, ::-1]


def filter_keypoints(points: np.ndarray, shape) -> np.ndarray:
    mask = (
        (points[:, 0] >= 0)
        & (points[:, 0] < shape[0])
        & (points[:, 1] >= 0)
        & (points[:, 1] < shape[1])
    )
    return points[mask]


def select_k_best(points_with_prob: np.ndarray, k: int) -> np.ndarray:
    """Keep the k highest-probability (y, x, prob) rows; strip prob."""
    sorted_pts = points_with_prob[points_with_prob[:, 2].argsort(), :2]
    start = min(k, len(points_with_prob))
    return sorted_pts[len(sorted_pts) - start :]


def heatmap_to_points(prob: np.ndarray, min_prob: float = 0.0) -> np.ndarray:
    """(H, W) heatmap -> (N, 3) [y, x, prob] rows of strictly-positive pixels."""
    ys, xs = np.where(prob > min_prob)
    return np.stack([ys, xs, prob[ys, xs]], axis=-1)


def repeatability_pair(
    prob: np.ndarray,
    warped_prob: np.ndarray,
    H: np.ndarray,
    keep_k_points: int = 300,
    distance_thresh: int = 3,
):
    """Symmetric repeatability for one image pair (reference
    detector_evaluation.py:145-233). Returns (repeatability|None, N1, N2)."""
    shape = warped_prob.shape

    keypoints = heatmap_to_points(prob)
    warped_keypoints = heatmap_to_points(warped_prob)

    # keep only warped detections that land inside the original image
    if len(warped_keypoints):
        back = warp_keypoints_yx(warped_keypoints[:, :2], np.linalg.inv(H))
        m = (
            (back[:, 0] >= 0) & (back[:, 0] < prob.shape[0])
            & (back[:, 1] >= 0) & (back[:, 1] < prob.shape[1])
        )
        warped_keypoints = warped_keypoints[m]

    # warp original detections into the warped frame
    if len(keypoints):
        tw = warp_keypoints_yx(keypoints[:, :2], H)
        true_warped = np.concatenate([tw, keypoints[:, 2:3]], axis=1)
        true_warped = filter_keypoints(true_warped, shape)
    else:
        true_warped = np.zeros((0, 3))

    warped_sel = select_k_best(warped_keypoints, keep_k_points) if len(warped_keypoints) else np.zeros((0, 2))
    true_sel = select_k_best(true_warped, keep_k_points) if len(true_warped) else np.zeros((0, 2))

    N1, N2 = len(true_sel), len(warped_sel)
    if N1 + N2 == 0:
        return None, 0, 0
    count1 = count2 = 0
    if N1 and N2:
        norm = np.linalg.norm(true_sel[:, None] - warped_sel[None], axis=2)
        count1 = int(np.sum(norm.min(axis=1) <= distance_thresh))
        count2 = int(np.sum(norm.min(axis=0) <= distance_thresh))
    return (count1 + count2) / (N1 + N2), N1, N2


def compute_repeatability(
    exper_name: str,
    keep_k_points: int = 300,
    distance_thresh: int = 3,
    verbose: bool = False,
) -> float:
    """Repeatability over an exported experiment directory of ``.npz``
    bundles {prob, warped_prob, homography} under
    EXPER_PATH/repeatability/<exper_name> (reference export.py:149)."""
    paths = sorted(Path(settings.EXPER_PATH, "repeatability", exper_name).glob("*.npz"))
    reps, n1s, n2s = [], [], []
    for path in paths:
        data = np.load(path)
        rep, n1, n2 = repeatability_pair(
            data["prob"], data["warped_prob"], data["homography"],
            keep_k_points, distance_thresh,
        )
        n1s.append(n1)
        n2s.append(n2)
        if rep is not None:
            reps.append(rep)
    if verbose:
        print(f"Average points: img1 {np.mean(n1s):.1f}, img2 {np.mean(n2s):.1f}")
    return float(np.mean(reps)) if reps else 0.0


def localization_error_pair(
    prob: np.ndarray, keypoint_map: np.ndarray,
    prob_thresh: float = 0.5, distance_thresh: int = 2,
) -> np.ndarray:
    """Distances of correct predictions to their nearest GT point
    (reference detector_evaluation.py:114-141)."""
    gt = np.argwhere(keypoint_map)
    pred = np.argwhere(prob > prob_thresh)
    if not len(gt) or not len(pred):
        return np.zeros((0,))
    dist = np.linalg.norm(pred[:, None] - gt[None], axis=-1).min(axis=1)
    return dist[dist <= distance_thresh]


def tp_fp_pair(
    prob: np.ndarray, keypoint_map: np.ndarray,
    distance_thresh: int = 2, simplified: bool = False,
):
    """True/false positives for PR computation (reference
    detector_evaluation.py:22-70): predictions sorted by confidence;
    each GT point matches at most one prediction."""
    gt = np.argwhere(keypoint_map)
    pred_yx = np.argwhere(prob > 0)
    scores = prob[pred_yx[:, 0], pred_yx[:, 1]]
    order = np.argsort(-scores)
    pred_yx, scores = pred_yx[order], scores[order]
    if len(gt) == 0:
        return np.zeros(len(pred_yx), bool), np.ones(len(pred_yx), bool), scores, 0
    if len(pred_yx) == 0:
        return np.zeros(0, bool), np.zeros(0, bool), scores, len(gt)
    dist = np.linalg.norm(pred_yx[:, None] - gt[None], axis=-1)
    matched = np.zeros(len(gt), bool)
    tp = np.zeros(len(pred_yx), bool)
    for i in range(len(pred_yx)):
        j = np.argmin(dist[i])
        if dist[i, j] <= distance_thresh and not matched[j]:
            matched[j] = True
            tp[i] = True
    return tp, ~tp, scores, len(gt)


def compute_pr_map(samples: list[tuple[np.ndarray, np.ndarray]],
                   distance_thresh: int = 2):
    """PR curve + mAP over (prob, keypoint_map) pairs (reference
    detector_evaluation.py:73-112)."""
    tps, fps, scores, n_gt = [], [], [], 0
    for prob, kmap in samples:
        tp, fp, sc, n = tp_fp_pair(prob, kmap, distance_thresh)
        tps.append(tp)
        fps.append(fp)
        scores.append(sc)
        n_gt += n
    tp = np.concatenate(tps)
    fp = np.concatenate(fps)
    scores = np.concatenate(scores)
    order = np.argsort(-scores)
    tp, fp = tp[order], fp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(n_gt, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp_cum + fp_cum > 0, tp_cum / (tp_cum + fp_cum), 0)
    recall = np.concatenate([[0], recall, [1]])
    precision = np.concatenate([[0], precision, [0]])
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    mAP = np.sum(precision[1:] * (recall[1:] - recall[:-1]))
    return precision, recall, float(mAP)
