"""NeRF-depth label fidelity against ray-traced depth
(``tools/label_fidelity.py``): how far the depth a NeRF renders moves the
multi-view labels that ``export_NeRF_labels`` fuses from it.

The fabricated scenes are procedural, so the exact along-ray depth at
every rendered training pose can be ray-traced on the host:

1. every scene's rectangles are rebuilt in order from a fresh OpenCV
   generator (``gt_test_views.rebuild_rects``: the textures draw from it),
   though only the first ``--n-scenes`` are exported;
2. the depth at ``NeRF/<scene>/poses_train.npy`` is ray-traced by
   ``nerf_scenes.render_scene`` into a shadow scene ``NeRF/<scene>__gtdepth/``
   whose ``images`` and ``camera_transforms`` are symlinks to the scene's;
3. ``export_NeRF_labels`` runs on both (this process, ``cli.main``, as
   ``demo/run.py`` runs its legs) with one checkpoint, the latest
   ``demo_mp`` (``run.mp_seed``) unless ``--pretrained`` names one; an
   experiment that has labels already is not exported again;
4. exact point-set IoU and within-2px agreement per scene and their means.

Agreement: for each ray-traced (reference) label, the nearest NeRF-depth
label in float64; an image with an empty side is left out of within-2px
(its IoU is 1.0 if both are empty).

    python -m spnerf_tpu_torch.demo.label_fidelity [--n-scenes 4]
        [--pretrained demo_mp/demo_mp_N.ckpt] [--json-out FILE]
        [--device cpu] [--set KEY=VALUE ...]

prints a row a scene and a summary row as JSON lines, appends them to
``--json-out`` (default ``EVIDENCE_PATH/label_fidelity.jsonl``) and
returns them; ``--set`` adds config overrides to both exports. Departure:
the reference looks for the checkpoint under ``EXPER_PATH/ckpts``, where
no leg writes one; this tool takes ``run.py``'s (``CKPT_PATH/demo_mp``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.demo import gt_test_views, nerf_scenes, run
from spnerf_tpu_torch.demo.standin_data import fresh_cv_rng

CONFIG = run.CONFIGS / "nerf_export_demo.yaml"


def build_shadow(scene: str, rects) -> Path:
    """``NeRF/<scene>__gtdepth``: the scene's images and camera transforms
    linked, its training poses' depth ray-traced."""
    src = Path(settings.DATA_PATH, "NeRF", scene)
    shadow = Path(settings.DATA_PATH, "NeRF", f"{scene}__gtdepth")
    K = np.load(Path(settings.DATA_PATH, "NeRF_gt", scene, "intrinsics.npy"))
    poses = np.load(src / "poses_train.npy")
    (shadow / "depth" / "training").mkdir(parents=True, exist_ok=True)
    for sub in ("images", "camera_transforms"):
        link = shadow / sub
        if not link.exists():
            link.symlink_to((src / sub).resolve())
    sample = sorted((src / "images" / "training").glob("*.png"))[0]
    shape = png.read_gray(sample).shape
    for i, pose in enumerate(poses):
        out = shadow / "depth" / "training" / f"{i}.npy"
        if out.exists():
            continue
        _, depth = nerf_scenes.render_scene(rects, K, pose, shape)
        np.save(out, depth)
    np.save(shadow / "poses_train.npy", poses)
    return shadow


def run_export(data_dir: str, experiment: str, pretrained: str,
               device: str, overrides=()) -> tuple:
    """(the labels' directory, the export's seconds; 0 when it had
    labels)."""
    out_dir = Path(settings.EXPER_PATH, "outputs", experiment, "training")
    if out_dir.is_dir() and any(out_dir.glob("*.npy")):
        return out_dir, 0.0
    t0 = time.perf_counter()
    cli.main(["--config-path", str(CONFIG), "--task", "export_NeRF_labels",
              "--set", f"pretrained={pretrained}",
              "--set", f"data.data_dir={data_dir}",
              "--set", f"data.experiment_name={experiment}",
              *[a for kv in overrides for a in ("--set", kv)],
              "--device", device])
    return out_dir, time.perf_counter() - t0


def agreement(ref_dir: Path, test_dir: Path) -> tuple:
    """(mean IoU, mean within-2px or None) over the reference's files."""
    ious, within2 = [], []
    names = sorted(p.name for p in Path(ref_dir).glob("*.npy"))
    for name in names:
        a = np.load(Path(ref_dir) / name)
        b = np.load(Path(test_dir) / name)
        sa = {tuple(p) for p in a.tolist()}
        sb = {tuple(p) for p in b.tolist()}
        union = len(sa | sb)
        ious.append(len(sa & sb) / union if union else 1.0)
        if len(a) and len(b):
            d = np.linalg.norm(a[:, None].astype(np.float64)
                               - b[None].astype(np.float64), axis=-1)
            within2.append(float(np.mean(d.min(axis=1) <= 2.0)))
    return float(np.mean(ious)), float(np.mean(within2)) if within2 else None


def fidelity(n_scenes: int, pretrained: str, device: str,
             overrides=()) -> tuple:
    """(the reference's rows: one a scene, then the summary; {scene:
    (ray-traced export's seconds, NeRF-depth export's seconds)})."""
    gt_root = Path(settings.DATA_PATH, "NeRF_gt")
    scenes = sorted(p.name for p in gt_root.iterdir() if p.is_dir())
    fresh_cv_rng()
    rows, seconds = [], {}
    for s, scene in enumerate(scenes):
        # rebuild EVERY scene in order (OpenCV's generator), export the
        # first n
        rects = gt_test_views.rebuild_rects(s)
        if s >= n_scenes:
            continue
        if not Path(settings.DATA_PATH, "NeRF", scene,
                    "poses_train.npy").exists():
            print(f"{scene}: not rendered yet, skipping")
            continue
        build_shadow(scene, rects)
        ref, ref_s = run_export(f"{scene}__gtdepth",
                                f"demo_export_NeRF_gtdepth/{scene}",
                                pretrained, device, overrides)
        test, test_s = run_export(scene, f"demo_export_NeRF/{scene}",
                                  pretrained, device, overrides)
        seconds[scene] = (ref_s, test_s)
        iou, w2 = agreement(ref, test)
        row = {"metric": "nerf_depth_label_fidelity", "scene": scene,
               "pretrained": pretrained,
               "exact_iou": round(iou, 4),
               "within_2px": round(w2, 4) if w2 is not None else None,
               "ref": "gt_raytraced_depth", "test": "nerf_rendered_depth"}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rows:
        summary = {"metric": "nerf_depth_label_fidelity_summary",
                   "n_scenes": len(rows),
                   "mean_exact_iou": round(float(np.mean(
                       [r["exact_iou"] for r in rows])), 4),
                   "mean_within_2px": round(float(np.mean(
                       [r["within_2px"] for r in rows
                        if r["within_2px"] is not None])), 4)}
        print(json.dumps(summary), flush=True)
        rows.append(summary)
    return rows, seconds


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--n-scenes", type=int, default=4)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    args = ap.parse_args(argv)
    rows, _ = fidelity(args.n_scenes, args.pretrained or run.mp_seed(),
                       args.device, args.overrides)
    if rows:
        out = Path(args.json_out or Path(settings.EVIDENCE_PATH,
                                         "label_fidelity.jsonl"))
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
