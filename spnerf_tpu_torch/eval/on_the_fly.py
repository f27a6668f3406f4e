"""On-the-fly HPatches evaluation (``spnerf_tpu/eval/on_the_fly.py``):
no cached ``.npz`` bundles. The model runs live over the HPatches loader
through the parity path (``models.superpoint.superpoint_inference``:
float32, cuDNN's TF32 off), on the card unless ``--device cpu``, and the
host scores repeatability, or homography-estimation correctness and
matching score, each with its 95% bootstrap interval.

    python -m spnerf_tpu_torch.eval.on_the_fly --config-path cfg.yaml \\
        --mode repeatability [--k-points 300] [--distance-thresh 3]
    python -m spnerf_tpu_torch.eval.on_the_fly --config-path cfg.yaml \\
        --mode descriptors [--k-points 1000] [--correctness-thresh 3]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch.data.hpatches import HPatches
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.eval.descriptor import compute_homography_estimation
from spnerf_tpu_torch.eval.detector import repeatability_pair
from spnerf_tpu_torch.models.superpoint import superpoint_inference
from spnerf_tpu_torch.utils.config import apply_overrides, load_config


def bootstrap_ci(values, n_boot=2000, alpha=0.05, seed=0):
    """Percentile bootstrap 95% CI of the mean over evaluation pairs.

    The demo corpus is small (~150 pairs); reporting the resampling
    interval makes round-over-round metric deltas interpretable (a
    ±several-point interval means a 2-point delta is noise).
    """
    vals = np.asarray(values, np.float64)
    if len(vals) < 2:
        return float("nan"), float("nan")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(vals), (n_boot, len(vals)))
    means = vals[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


def pair_outputs(config: dict, device="cuda"):
    """Generator of (homography (3, 3), out1, out2) over the HPatches
    pairs of ``config["data"]``: the model of ``config["model"]`` drawn
    from seed 0, then restored from ``config["pretrained"]``; out1 and
    out2 hold "prob_heatmap_nms" (H, W) and, with a descriptor head,
    "desc" (H, W, C), as numpy."""
    from spnerf_tpu_torch.cli import model_for_inference

    device = resolve_device(device)
    model = model_for_inference(config, device)
    keys = ("prob_heatmap_nms", "desc") if model.config.has_descriptor \
        else ("prob_heatmap_nms",)

    def infer(image):
        out = superpoint_inference(model, torch.from_numpy(image).to(device))
        return {k: out[k][0].cpu().numpy() for k in keys}

    loader = DataLoader(HPatches(config["data"]), batch_size=1, shuffle=False,
                        drop_last=False)
    for batch in loader:
        yield (np.asarray(batch["homography"][0]), infer(batch["image"]),
               infer(batch["warped_image"]))


def run_repeatability(config, k_points=300, distance_thresh=3,
                      device="cuda"):
    reps = []
    for H, out1, out2 in pair_outputs(config, device):
        rep, _, _ = repeatability_pair(out1["prob_heatmap_nms"],
                                       out2["prob_heatmap_nms"], H, k_points,
                                       distance_thresh)
        if rep is not None:
            reps.append(rep)
    lo, hi = bootstrap_ci(reps)
    result = {"repeatability": float(np.mean(reps)) if reps else 0.0,
              "repeatability_ci95": [lo, hi],
              "pairs": len(reps)}
    print(f"repeatability: {result['repeatability']:.4f} "
          f"(95% CI [{lo:.4f}, {hi:.4f}]) over {result['pairs']} pairs")
    return result


def run_descriptors(config, k_points=1000, correctness_thresh=3.0,
                    device="cuda"):
    """The RANSAC samples are OpenCV's."""
    correctness, mscores = [], []
    for H, out1, out2 in pair_outputs(config, device):
        est = compute_homography_estimation(
            out1["prob_heatmap_nms"], out2["prob_heatmap_nms"],
            out1["desc"], out2["desc"], H, k_points, correctness_thresh)
        correctness.append(est["correctness"])
        mscores.append(est["matching_score"])
    clo, chi = bootstrap_ci(correctness)
    mlo, mhi = bootstrap_ci(mscores)
    result = {
        "correctness": float(np.mean(correctness)) if correctness else 0.0,
        "correctness_ci95": [clo, chi],
        "matching_score": float(np.mean(mscores)) if mscores else 0.0,
        "matching_score_ci95": [mlo, mhi],
        "pairs": len(correctness),
    }
    print(f"correctness: {result['correctness']:.4f} "
          f"(95% CI [{clo:.4f}, {chi:.4f}])  "
          f"matching_score: {result['matching_score']:.4f} "
          f"(95% CI [{mlo:.4f}, {mhi:.4f}]) "
          f"over {result['pairs']} pairs")
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-path", required=True)
    p.add_argument("--mode", choices=("repeatability", "descriptors"),
                   default="repeatability")
    p.add_argument("--k-points", type=int, default=None)
    p.add_argument("--distance-thresh", type=int, default=3)
    p.add_argument("--correctness-thresh", type=float, default=3.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY.PATH=VALUE",
                   help="override a config key by dotted path (same "
                        "semantics as the main CLI)")
    p.add_argument("--json-out", default=None,
                   help="append the result as one JSON line (tagged with "
                        "mode and checkpoint) to this file")
    args = p.parse_args(argv)
    config = apply_overrides(load_config(args.config_path), args.overrides)
    if args.mode == "repeatability":
        result = run_repeatability(config, args.k_points or 300,
                                   args.distance_thresh, device=args.device)
    else:
        result = run_descriptors(config, args.k_points or 1000,
                                 args.correctness_thresh, device=args.device)
    if args.json_out:
        record = {"mode": args.mode,
                  "pretrained": config.get("pretrained"), **result}
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return result


if __name__ == "__main__":
    main()
