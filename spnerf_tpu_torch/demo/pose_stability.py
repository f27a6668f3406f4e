"""Arm-wise stability of the pose sweep (``tools/pose_stability.py``).

Reads the demo's pose rows (``EVIDENCE_PATH/pose_auc.jsonl``, one row per
checkpoint, written by ``run.py pose``; the last row of a checkpoint
wins), groups them by training arm (the checkpoint name's first part:
``demo_sp_nerf``, ``demo_sp_ctl``, and ``baseline`` for the SIFT
calibration row) and returns, per arm, the mean, std,
min and max of pose AUC at 5, 10 and 20 degrees across the checkpoints.
The reference also rewrites a markdown table; ``run.py``'s summary takes
its place.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.pose_stability
"""

from __future__ import annotations

import json
import math
from pathlib import Path

from spnerf_tpu_torch import settings

KEYS = ("auc5", "auc10", "auc20")


def source() -> Path:
    return Path(settings.EVIDENCE_PATH, "pose_auc.jsonl")


def arm_of(tag: str) -> str:
    return tag.split("/", 1)[0]


def stats(vals):
    n = len(vals)
    mean = sum(vals) / n
    std = math.sqrt(sum((v - mean) ** 2 for v in vals) / n) if n > 1 else 0.0
    return {"n": n, "mean": round(mean, 3), "std": round(std, 3),
            "min": round(min(vals), 3), "max": round(max(vals), 3)}


def arm_rows(src: Path) -> list:
    """One row per arm of the pose rows in ``src``."""
    rows = {}
    for line in src.read_text().splitlines():
        if line.strip():
            r = json.loads(line)
            rows[r.get("pretrained") or "?"] = r
    arms = {}
    for tag, r in rows.items():
        arms.setdefault(arm_of(tag), []).append(r)
    out = []
    for arm in sorted(arms):
        group = arms[arm]
        row = {"metric": "pose_stability", "arm": arm,
               "checkpoints": len(group)}
        for k in KEYS:
            row[k] = stats([g[k] for g in group])
        out.append(row)
    return out


def main() -> list:
    src = source()
    if not src.exists():
        print(f"{src} not captured yet; nothing to summarize")
        return []
    out = arm_rows(src)
    for row in out:
        print(json.dumps(row))
    return out


if __name__ == "__main__":
    main()
