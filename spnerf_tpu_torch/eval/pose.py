"""Relative pose estimation evaluation (ScanNet / YFCC pair lists), the
port of ``spnerf_tpu/eval/pose.py`` (SuperGlue's protocol): per pair,
detect + NMS + describe both images, mutual-NN match, epipolar
precision, essential-matrix RANSAC + pose recovery, then AUC@{5,10,20}
deg, precision and matching score, each with a 95% bootstrap interval.

The model runs on the card unless ``--device cpu`` (the parity path:
float32, cuDNN's TF32 off, descriptors sampled at the keypoints). The
geometry stays on the host in numpy, with the port's own counterparts of
``cv2.findEssentialMat`` and ``cv2.recoverPose`` (``eval/essential.py``),
which draw OpenCV's RANSAC samples, so a run repeats the reference's
numbers. Images are read as ``cv2.imread`` reads them, the decoder
chosen by the file's signature (``data/imread.py``: JPEG, PNG, PBM / PGM
/ PPM); a pair whose image cv2 would return None for is skipped as the
reference skips it, and a format only cv2 decodes raises (ROADMAP Queue
1 item 7).

    python -m spnerf_tpu_torch.eval.pose --config-path \\
        spnerf_tpu_torch/configs/pose_estimation_indoor.yaml \\
        [--max-length N] [--shuffle] [--set key.path=value ...] \\
        [--json-out out.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.imread import Unreadable, read_gray
from spnerf_tpu_torch.data.resize import resize_linear, resize_linear_float
from spnerf_tpu_torch.eval.descriptor import mutual_nn_match
from spnerf_tpu_torch.eval.essential import find_essential_mat, recover_pose

# The reference calls cv2.recoverPose(E, p0, p1, I, 1e9, mask=m): the
# binding takes that positional 1e9 as the R output, so the distance
# threshold in force is cv2's default, 50 (in units of the baseline).
RECOVER_POSE_DISTANCE = 50.0

# ------------------------------------------------------- image/intrinsics


def resize_dims(w: int, h: int, spec) -> tuple[int, int]:
    """Resolve a resize spec to (w, h): [n] scales the long side to n,
    [-1] keeps the input size, [w, h] is explicit."""
    if len(spec) == 2:
        return int(spec[0]), int(spec[1])
    (n,) = spec
    if n <= -1:
        return w, h
    s = n / max(h, w)
    return int(round(w * s)), int(round(h * s))


def load_gray(path, spec, rotation: int = 0, resize_float: bool = False):
    """Grayscale image, resized per ``spec`` and rotated by ``rotation``
    quarter-turns CCW. Returns (image float32, (sx, sy) original/new
    pixel scale, post-rotation), or (None, None) where ``cv2.imread``
    returns None: a file that is missing or cannot be read, one no image
    decoder claims, or one its decoder stops at (``imread.Unreadable``).
    A format cv2 decodes and the port does not
    raises ``imread.NotPorted``, so that a pair list is never skipped
    through where the reference reads it."""
    try:
        img = read_gray(Path(path))
    except (OSError, Unreadable):
        return None, None
    h, w = img.shape
    nw, nh = resize_dims(w, h, spec)
    if resize_float:
        img = resize_linear_float(img.astype(np.float32), (nw, nh))
    else:
        img = resize_linear(img, (nw, nh)).astype(np.float32)
    scale = (w / nw, h / nh)
    if rotation % 4:
        img = np.rot90(img, k=rotation)
        if rotation % 2:
            scale = scale[::-1]
    return img, scale


def rescale_K(K: np.ndarray, scale) -> np.ndarray:
    """Apply a per-axis pixel rescale (sx, sy) to an intrinsics matrix."""
    out = K.copy().astype(np.float64)
    out[0] /= scale[0]
    out[1] /= scale[1]
    return out


def _quarter_turn(K: np.ndarray, w: int, h: int):
    """One CCW quarter-turn of the image plane: np.rot90 maps pixel (x, y)
    of a (w, h) image to (y, w - 1 - x), an affine map A with A K = K'
    Rz(-90 deg), K' upper-triangular. Returns (K', new_w, new_h)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    Kp = np.array([[fy, 0.0, cy], [0.0, fx, w - 1.0 - cx], [0.0, 0.0, 1.0]],
                  dtype=K.dtype)
    return Kp, h, w


def rotate_K(K: np.ndarray, rotated_shape, rot: int) -> np.ndarray:
    """Intrinsics after ``rot`` CCW quarter-turns. ``rotated_shape`` is
    the shape of the already-rotated image (h, w)."""
    rot = rot % 4
    h, w = rotated_shape[:2]
    if rot % 2:
        h, w = w, h  # recover pre-rotation dims
    for _ in range(rot):
        K, w, h = _quarter_turn(K, w, h)
    return K


def _rz_homogeneous(quarter_turns: int) -> np.ndarray:
    """4x4 rotation about the camera z-axis by -90 deg * quarter_turns:
    the extrinsic half of the ``_quarter_turn`` factorization."""
    a = -np.pi / 2.0 * quarter_turns
    c, s = np.cos(a), np.sin(a)
    out = np.eye(4, dtype=np.float32)
    out[:2, :2] = [[c, -s], [s, c]]
    return out


def rotate_extrinsic(cam_T_w: np.ndarray, rot: int) -> np.ndarray:
    """Compose the in-plane rotation from ``rot`` image quarter-turns
    onto a world->camera pose."""
    return _rz_homogeneous(rot % 4) @ cam_T_w


# ------------------------------------------------------------ pose metrics


def _normalized(pts: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pixel (N, 2) -> normalized homogeneous (N, 3) rays via K^-1
    (zero skew, as everywhere in this protocol)."""
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    xy = (np.asarray(pts, np.float64) - c) / f
    return np.concatenate([xy, np.ones_like(xy[:, :1])], axis=-1)


def _cross_matrix(v: np.ndarray) -> np.ndarray:
    """Skew-symmetric matrix such that _cross_matrix(v) @ u == v x u."""
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def epipolar_errors(kpts0, kpts1, T_0to1, K0, K1) -> np.ndarray:
    """Symmetric squared epipolar distance of matches in normalized
    coordinates, under the true relative pose T_0to1 (E = [t]x R)."""
    r0 = _normalized(kpts0, K0)
    r1 = _normalized(kpts1, K1)
    E = _cross_matrix(T_0to1[:3, 3]) @ T_0to1[:3, :3]
    l1 = r0 @ E.T          # epipolar line of each x0 in image 1
    l0 = r1 @ E            # epipolar line of each x1 in image 0
    residual = np.einsum("nc,nc->n", r1, l1)

    def inv_sq(line):
        return 1.0 / np.einsum("nc,nc->n", line[:, :2], line[:, :2])

    return residual**2 * (inv_sq(l1) + inv_sq(l0))


def recover_relative_pose(kpts0, kpts1, K0, K1, thresh, conf=0.99999):
    """Essential-matrix RANSAC in normalized coordinates + pose recovery
    over the candidate Es: (R, t, inlier mask) of the candidate with the
    most matches in front of both cameras, or None."""
    if len(kpts0) < 5:
        return None
    r0 = np.ascontiguousarray(_normalized(kpts0, K0)[:, :2])
    r1 = np.ascontiguousarray(_normalized(kpts1, K1)[:, :2])
    # pixel threshold -> normalized units at the mean focal length
    norm_thresh = thresh * 4.0 / (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1])
    E, mask = find_essential_mat(r0, r1, norm_thresh, prob=conf)
    if E is None:
        return None
    best = None
    support = 0
    for cand in E:
        # cv2 writes each candidate's mask over the one passed in
        n, R, t, mask = recover_pose(cand, r0, r1, RECOVER_POSE_DISTANCE,
                                     mask=mask)
        if n > support:
            support = n
            best = (R, t.ravel(), mask.ravel() > 0)
    return best


def rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> float:
    """Geodesic angle between two rotation matrices, in degrees."""
    cos = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return float(np.degrees(np.abs(np.arccos(np.clip(cos, -1.0, 1.0)))))


def direction_angle_deg(v1: np.ndarray, v2: np.ndarray) -> float:
    """Angle between two direction vectors, in degrees."""
    cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def pose_errors_deg(T_0to1, R, t) -> tuple[float, float]:
    """(translation-direction error, rotation error) against the truth;
    translation is sign-ambiguous from an essential matrix, so fold to
    <= 90 deg."""
    err_t = direction_angle_deg(t, T_0to1[:3, 3])
    err_R = rotation_angle_deg(R, T_0to1[:3, :3])
    return min(err_t, 180.0 - err_t), err_R


def error_auc(errors, thresholds) -> list[float]:
    """Area under the recall(error) staircase up to each threshold,
    normalized to [0, 1]: recall interpolated linearly between sorted
    errors and held flat from the last error below ``t`` out to ``t``."""
    e = np.sort(np.asarray(errors, np.float64))
    n = len(e)
    recall = np.arange(1, n + 1) / n
    aucs = []
    for t in thresholds:
        k = int(np.searchsorted(e, t))  # errors[:k] < t
        xs = np.concatenate([[0.0], e[:k], [t]])
        ys = np.concatenate([[0.0], recall[:k], [recall[k - 1] if k else 0.0]])
        aucs.append(float(np.trapezoid(ys, x=xs)) / t)
    return aucs


def bootstrap_ci(pose_errors, precisions, mscores, thresholds,
                 n_boot: int = 1000, seed: int = 0):
    """95% percentile bootstrap intervals over pairs for every reported
    metric (pairs are the independent sampling unit)."""
    rng = np.random.default_rng(seed)
    pe = np.asarray(pose_errors)
    pr = np.asarray(precisions)
    ms = np.asarray(mscores)
    n = len(pe)
    stats = {k: [] for k in ("auc5", "auc10", "auc20", "precision",
                             "matching_score")}
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        aucs = error_auc(pe[idx], thresholds)
        stats["auc5"].append(100.0 * aucs[0])
        stats["auc10"].append(100.0 * aucs[1])
        stats["auc20"].append(100.0 * aucs[2])
        stats["precision"].append(100.0 * float(pr[idx].mean()))
        stats["matching_score"].append(100.0 * float(ms[idx].mean()))
    return {k: [float(np.percentile(v, 2.5)), float(np.percentile(v, 97.5))]
            for k, v in stats.items()}


# -------------------------------------------------------------- matching


def top_keypoints_with_border(prob: np.ndarray, keep_k: int, border: int = 4):
    """(N, 2) [y, x] of the top-k NMS'd detections away from the
    borders."""
    h, w = prob.shape
    ys, xs = np.where(prob > 0)
    scores = prob[ys, xs]
    pts = np.stack([ys, xs, scores], -1)
    m = (
        (pts[:, 0] >= border) & (pts[:, 0] < h - border)
        & (pts[:, 1] >= border) & (pts[:, 1] < w - border)
    )
    pts = pts[m]
    order = pts[:, 2].argsort()
    return pts[order][-min(keep_k, len(pts)):, :2].astype(int)


def match_pair(prob0, prob1, desc0, desc1, keep_k=1024):
    """Mutual-NN match of top-k detections. desc*: dense (H, W, C) maps
    or callables (pts -> (N, C)) for the point-sampled path. Returns the
    matched (x, y) points of both images and image 0's keypoints."""
    k0 = top_keypoints_with_border(prob0, keep_k)
    k1 = top_keypoints_with_border(prob1, keep_k)
    if len(k0) == 0 or len(k1) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2)), k0
    d0 = desc0(k0) if callable(desc0) else desc0[k0[:, 0], k0[:, 1]]
    d1 = desc1(k1) if callable(desc1) else desc1[k1[:, 0], k1[:, 1]]
    i0, i1 = mutual_nn_match(d0.astype(np.float32), d1.astype(np.float32))
    return (k0[i0][:, ::-1].astype(np.float64),
            k1[i1][:, ::-1].astype(np.float64), k0)


# ------------------------------------------------------------- evaluation


def estimate_pose_errors(config: dict, infer_fn, pairs: list[list[str]]):
    """infer_fn(image float32 (H, W) in [0, 255]) -> {"prob": (H, W) NMS
    heatmap, "desc": (H, W, C) or callable}. Each pair's RANSAC draws
    are OpenCV's, seeded as cv2 seeds them."""
    top_k = config["model"]["detector_head"].get("top_k", 1024)
    epi_thresh = config["data"].get("epi_thrsehold",
                                    config["data"].get("epi_threshold", 5e-4))
    resize = config["data"]["resize"]
    resize_float = config["data"].get("resize_float", False)
    images_root = Path(settings.DATA_PATH, config["data"]["images_path"])

    pose_errors, precisions, mscores = [], [], []
    for pair in pairs:
        name0, name1 = pair[:2]
        rot0, rot1 = (int(pair[2]), int(pair[3])) if len(pair) >= 5 else (0, 0)
        image0, scale0 = load_gray(images_root / name0, resize, rot0,
                                   resize_float)
        image1, scale1 = load_gray(images_root / name1, resize, rot1,
                                   resize_float)
        if image0 is None or image1 is None:
            continue

        out0 = infer_fn(image0)
        out1 = infer_fn(image1)
        mk0, mk1, k0 = match_pair(out0["prob"], out1["prob"],
                                  out0["desc"], out1["desc"], top_k)
        K0 = np.array(pair[4:13], float).reshape(3, 3)
        K1 = np.array(pair[13:22], float).reshape(3, 3)
        T_0to1 = np.array(pair[22:38], float).reshape(4, 4)
        K0 = rescale_K(K0, scale0)
        K1 = rescale_K(K1, scale1)
        if rot0 != 0 or rot1 != 0:
            K0 = rotate_K(K0, image0.shape, rot0)
            K1 = rotate_K(K1, image1.shape, rot1)
            cam0_T_w = rotate_extrinsic(np.eye(4), rot0)
            cam1_T_w = rotate_extrinsic(T_0to1, rot1)
            T_0to1 = cam1_T_w @ np.linalg.inv(cam0_T_w)

        if len(mk0):
            correct = epipolar_errors(mk0, mk1, T_0to1, K0, K1) < epi_thresh
            precision = float(np.mean(correct)) if len(correct) else 0.0
            mscore = float(np.sum(correct) / len(k0)) if len(k0) else 0.0
        else:
            precision = mscore = 0.0

        ret = recover_relative_pose(mk0, mk1, K0, K1, thresh=1.0)
        if ret is None:
            err_t = err_R = np.inf
        else:
            R, t, _ = ret
            err_t, err_R = pose_errors_deg(T_0to1, R, t)

        pose_errors.append(max(err_t, err_R))
        precisions.append(precision)
        mscores.append(mscore)

    thresholds = [5, 10, 20]
    aucs = [100.0 * a for a in error_auc(pose_errors, thresholds)]
    results = {
        "auc5": aucs[0], "auc10": aucs[1], "auc20": aucs[2],
        "precision": 100.0 * float(np.mean(precisions)) if precisions else 0.0,
        "matching_score": 100.0 * float(np.mean(mscores)) if mscores else 0.0,
        "num_pairs": len(pose_errors),
    }
    if pose_errors:
        results["ci95"] = bootstrap_ci(pose_errors, precisions, mscores,
                                       thresholds)
    return results


def build_infer_fn(config: dict, device="cuda"):
    """Per-image inference on ``device`` (the card unless asked for the
    CPU): the config's model (seed 0, then ``pretrained``) through
    ``superpoint_inference`` in float32 with TF32 off, returning the NMS
    heatmap and a closure that samples descriptors from ``desc_raw`` at
    (N, 2) [y, x] points."""
    from spnerf_tpu_torch.cli import model_for_inference
    from spnerf_tpu_torch.device import resolve_device
    from spnerf_tpu_torch.models.superpoint import superpoint_inference
    from spnerf_tpu_torch.ops.descriptor_sampling import sample_descriptors

    device = resolve_device(device)
    model = model_for_inference(config, device)
    grid = model.config.grid_size

    def infer(image_f32):
        x = torch.from_numpy(np.ascontiguousarray(image_f32 / 255.0))
        out = superpoint_inference(model, x.to(device)[None, ..., None])
        prob = out["prob_heatmap_nms"][0].cpu().numpy()
        desc_raw = out["desc_raw"][0]

        def desc_at(pts):
            pts = torch.as_tensor(np.asarray(pts), dtype=torch.float32,
                                  device=device)
            return sample_descriptors(desc_raw, pts, grid).cpu().numpy()

        return {"prob": prob, "desc": desc_at}

    return infer


def read_pairs(config: dict, max_length: int = -1, shuffle: bool = False):
    """The config's pair list (``data.gt_pairs`` under ``DATA_PATH``),
    shuffled by ``random.Random(0)`` and cut to ``max_length`` if asked."""
    with open(Path(settings.DATA_PATH, config["data"]["gt_pairs"])) as f:
        pairs = [line.split() for line in f.readlines()]
    if shuffle:
        import random

        random.Random(0).shuffle(pairs)
    if max_length > -1:
        pairs = pairs[:max_length]
    return pairs


def main(argv=None):
    from spnerf_tpu_torch.utils.config import apply_overrides, load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config-path", required=True)
    p.add_argument("--max-length", type=int, default=-1)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--json-out", default=None,
                   help="append results as one JSON line (with the "
                        "checkpoint tag) to this file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    config = apply_overrides(load_config(args.config_path), args.overrides)

    pairs = read_pairs(config, args.max_length, args.shuffle)
    infer = build_infer_fn(config, args.device)
    results = estimate_pose_errors(config, infer, pairs)
    print("AUC@5\t AUC@10\t AUC@20\t Prec\t MScore")
    print("{auc5:.2f}\t {auc10:.2f}\t {auc20:.2f}\t {precision:.2f}\t "
          "{matching_score:.2f}".format(**results))
    if args.json_out:
        results["pretrained"] = config.get("pretrained")
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main()
