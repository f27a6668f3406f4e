"""Pseudo-label agreement between two HA exports
(``tools/label_iou.py``): exact point-set IoU and the fraction of the
test points within 2 px of a reference point, averaged over the label
files the two directories share.

Each test point's nearest reference point is measured in float32. Per
image, an empty union counts as IoU 1.0; where either side is empty,
within-2px counts 1.0 if both are, else 0.0.

    python -m spnerf_tpu_torch.demo.label_iou REF_DIR TEST_DIR
        [--label NAME]

prints one JSON line (``metric`` ha_label_agreement, ``label``,
``exact_iou``, ``within_2px``, ``n_images``; the means rounded to 4
places) and returns it from ``main``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def agreement(ref_dir: Path, test_dir: Path) -> tuple:
    """(mean IoU, mean within-2px, image count) over the common files."""
    ref_files = {p.name: p for p in Path(ref_dir).glob("*.npy")}
    test_files = {p.name: p for p in Path(test_dir).glob("*.npy")}
    common = sorted(set(ref_files) & set(test_files))
    if not common:
        raise SystemExit("no common label files")
    ious, within2 = [], []
    for name in common:
        a = np.load(ref_files[name])  # (N, 2) int points
        b = np.load(test_files[name])
        sa = {tuple(p) for p in a.tolist()}
        sb = {tuple(p) for p in b.tolist()}
        union = len(sa | sb)
        ious.append(len(sa & sb) / union if union else 1.0)
        if len(b) and len(a):
            d = np.linalg.norm(b[:, None, :].astype(np.float32)
                               - a[None, :, :].astype(np.float32), axis=-1)
            within2.append(float((d.min(axis=1) <= 2.0).mean()))
        else:
            within2.append(1.0 if len(a) == len(b) else 0.0)
    return float(np.mean(ious)), float(np.mean(within2)), len(common)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("ref_dir")
    ap.add_argument("test_dir")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    iou, within2, n = agreement(Path(args.ref_dir), Path(args.test_dir))
    row = {"metric": "ha_label_agreement",
           "label": args.label or f"{Path(args.ref_dir).name}"
                                  f"_vs_{Path(args.test_dir).name}",
           "exact_iou": round(iou, 4), "within_2px": round(within2, 4),
           "n_images": n}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
