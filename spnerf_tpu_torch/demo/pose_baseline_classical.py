"""Classical-feature baseline row for the GT relative-pose protocol
(``tools/pose_baseline_classical.py``).

Runs SIFT or ORB through the same pose evaluation as the learned
checkpoints (``eval.pose.estimate_pose_errors``: the same pairs,
mutual-NN matching, RANSAC essential-matrix recovery, AUC and bootstrap),
so the pose table gets a protocol-difficulty anchor that no training of
this repo touches. Both are OpenCV 5.0's, detector and descriptor, in
the port's own C++ on the host (``eval/sift.py``, ``eval/orb.py``); ORB's
32 descriptor bytes are matched as float32 values 0-255, as the
reference tool matches them.

Each keypoint marks the pixel ``int(round(pt))`` (Python's round, half
to even) of the heatmap with ``max(response, 1e-6)``; keypoints outside
the image are skipped, and of several on one pixel the later one wins
when its response is at least the one marked. The descriptors are read
back at the marked pixels. The row is tagged ``baseline/<feature>``,
printed as the pose table's line and appended to ``--json-out``.

Usage:
    python -m spnerf_tpu_torch.demo.pose_baseline_classical \\
        --config-path spnerf_tpu_torch/demo/configs/pose_demo.yaml \\
        [--feature sift] [--max-kp 1024] [--json-out pose_auc.jsonl] \\
        [--set key.path=value ...]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.eval import orb, sift
from spnerf_tpu_torch.eval.pose import estimate_pose_errors

DETECTORS = {"sift": (sift.sift, sift.DESCRIPTOR_SIZE),
             "orb": (orb.orb, orb.DESCRIPTOR_SIZE)}


def build_infer(feature: str, max_kp: int):
    """``infer(image float32 (H, W))`` -> {"prob": (H, W) float32,
    "desc": callable of (N, 2) [y, x] points}, as the reference tool's."""
    if feature not in DETECTORS:
        raise SystemExit(f"unknown feature: {feature}")
    detect, size = DETECTORS[feature]

    def infer(image: np.ndarray):
        img_u8 = np.clip(image, 0, 255).astype(np.uint8)
        found = detect(img_u8, max_kp)
        desc = found.desc.astype(np.float32)
        prob = np.zeros(image.shape, np.float32)
        by_pixel = {}
        for (x, y), response, d in zip(found.pt.tolist(),
                                       found.response.tolist(), desc):
            r = int(round(y)), int(round(x))
            if not (0 <= r[0] < prob.shape[0] and 0 <= r[1] < prob.shape[1]):
                continue
            if response >= prob[r]:
                prob[r] = max(response, 1e-6)
                by_pixel[r] = d
        dim = size if by_pixel else 1

        def desc_at(pts):
            return np.stack([by_pixel[(int(y), int(x))] for y, x in pts]) \
                if len(pts) else np.zeros((0, dim), np.float32)

        return {"prob": prob, "desc": desc_at}

    return infer


def main(argv=None) -> dict:
    from spnerf_tpu_torch.utils.config import apply_overrides, load_config

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config-path", required=True)
    ap.add_argument("--feature", default="sift", choices=("sift", "orb"))
    ap.add_argument("--max-kp", type=int, default=1024)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    args = ap.parse_args(argv)

    config = apply_overrides(load_config(args.config_path), args.overrides)
    infer = build_infer(args.feature, args.max_kp)
    pairs_path = Path(settings.DATA_PATH, config["data"]["gt_pairs"])
    pairs = [line.split() for line in pairs_path.read_text().splitlines()
             if line]
    results = estimate_pose_errors(config, infer, pairs)
    results["pretrained"] = f"baseline/{args.feature}"
    print("AUC@5\t AUC@10\t AUC@20\t Prec\t MScore")
    print(f"{results['auc5']:.2f}\t {results['auc10']:.2f}\t "
          f"{results['auc20']:.2f}\t {results['precision']:.2f}\t "
          f"{results['matching_score']:.2f}")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main()
