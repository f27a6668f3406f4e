"""Novel-view PSNR of the NeRF test renders against the GT ray-traces
(``tools/nerf_test_psnr.py``).

``nerf_leg`` renders the test arc through the trained NeRF and
``gt_test_views`` ray-traces the same poses, so PSNR by view index
measures novel-view generalisation (the test arc is never trained on).
Returns one row per scene and a summary row ("ALL"); a scene whose renders
are missing gets a note.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.nerf_test_psnr
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def rows(root=None) -> list:
    """The reference's JSON rows for the scenes under ``root`` (default
    ``settings.DATA_PATH``, read at call time)."""
    root = Path(settings.DATA_PATH if root is None else root)
    gt_root, nerf_root = root / "NeRF_gt", root / "NeRF"
    scenes = sorted(p.name for p in gt_root.iterdir() if p.is_dir())
    out, all_vals = [], []
    for scene in scenes:
        gt_dir = gt_root / scene / "images" / "test"
        nerf_dir = nerf_root / scene / "images" / "test"
        if not nerf_dir.is_dir() or not gt_dir.is_dir():
            out.append({"metric": "nerf_test_psnr", "scene": scene,
                        "note": "renders missing, leg not run yet"})
            continue
        vals = []
        for gt_path in sorted(gt_dir.glob("*.png"),
                              key=lambda p: int(p.stem)):
            nerf_path = nerf_dir / gt_path.name
            if not nerf_path.exists():
                continue
            gt, nf = png.read_gray(gt_path), png.read_gray(nerf_path)
            if nf.shape != gt.shape:
                continue
            vals.append(psnr(gt, nf))
        if vals:
            out.append({"metric": "nerf_test_psnr", "scene": scene,
                        "value": round(float(np.mean(vals)), 2),
                        "unit": "dB", "min": round(float(np.min(vals)), 2),
                        "n_views": len(vals)})
            all_vals.extend(vals)
    if all_vals:
        out.append({"metric": "nerf_test_psnr", "scene": "ALL",
                    "value": round(float(np.mean(all_vals)), 2), "unit": "dB",
                    "min": round(float(np.min(all_vals)), 2),
                    "n_views": len(all_vals)})
    return out


def main(out=None) -> list:
    """Print the rows, and append them to ``out`` (a JSON-lines path)."""
    result = rows()
    lines = [json.dumps(r) for r in result]
    for line in lines:
        print(line)
    if out is not None and lines:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return result


if __name__ == "__main__":
    main()
