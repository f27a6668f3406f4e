"""The demo's NeRF leg (``demo/run_nerf_leg.py``): train a NeRF on each
fabricated scene on the card, render the NeRF dataset (images, along-ray
depth, camera transforms) and write the pose-evaluation pairs.

Rendered splits per scene:
    training  - a 120 deg arc (the 7-15% partner window then spans 8-18
                deg of baseline)
    test      - a second arc at another height, for pose evaluation

The pairs file is SuperGlue / ScanNet format (name0 name1 rot0 rot1 K0
K1 T_0to1) with the renderer's exact intrinsics and extrinsics.

The field is the demo's: ``NeRFConfig(depth=4, width=128, skip_layer=2,
n_coarse=32, n_fine=64, compute_dtype="bfloat16")`` (bf16 dots, float32
parameters and compositing). The report (``DATA_PATH/NeRF/
nerf_leg_report.json``) keeps the reference's keys and adds the ms of a
training step and of a rendered frame, by the host clock around
synchronised work.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.nerf_leg
[--iters 3000] [--n-train-views 36] [--n-test-views 24] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.nerf import NeRFConfig
from spnerf_tpu_torch.tasks.nerf_task import (pose_orbit, render_dataset,
                                              train_nerf_scene)

ARC_DEG = 120.0
# the fabricated scenes are simple textured solids: a 4 x 128 field at
# 32 + 64 samples fits them while cutting the default (8 x 256, 64 + 128)
# work ~16x
FIELD = NeRFConfig(depth=4, width=128, skip_layer=2, n_coarse=32,
                   n_fine=64, compute_dtype="bfloat16")


def arc_poses(n: int, radius: float, height: float, start_deg: float):
    """OpenCV cam-to-world poses along an orbit arc, looking at origin."""
    full = int(round(n * 360.0 / ARC_DEG))
    orbit = pose_orbit(full, radius=radius, height=height)
    k0 = int(round(start_deg / 360.0 * full))
    idx = [(k0 + i) % full for i in range(n)]
    return orbit[idx]


def test_arc(n: int):
    """The evaluation arc, which the GT test views ray-trace too."""
    return arc_poses(n, radius=4.0, height=-0.2, start_deg=150.0)


def pair_lines(scene: str, K, poses, n: int, rng, min_gap: int,
               max_gap: int) -> list:
    """Pairs (i, i + gap) over the first ``n`` poses, the gap drawn in
    [min_gap, max_gap] and clamped to the last pose."""
    k_flat = " ".join(f"{v:.6f}" for v in K.ravel())
    lines = []
    for i in range(n - 1):
        gap = int(rng.integers(min_gap, max_gap + 1))
        # clamp instead of skip so small test splits still pair up
        j = min(i + gap, n - 1)
        if j == i:
            continue
        T_0to1 = np.linalg.inv(poses[j]) @ poses[i]
        t_flat = " ".join(f"{v:.8f}" for v in T_0to1.ravel())
        lines.append(f"{scene}/images/test/{i}.png {scene}/images/test/"
                     f"{j}.png 0 0 {k_flat} {k_flat} {t_flat}")
    return lines


def write_lines(lines: list, pairs_path: Path) -> int:
    pairs_path.parent.mkdir(parents=True, exist_ok=True)
    pairs_path.write_text("\n".join(lines) + "\n")
    return len(lines)


def write_pose_pairs(scenes, pairs_path: Path, n_test: int, min_gap: int,
                     max_gap: int, root=None) -> int:
    """The NeRF test split's pairs (seed 7) with the scenes' exact K."""
    root = Path(settings.DATA_PATH if root is None else root)
    rng = np.random.default_rng(7)
    lines = []
    for scene in scenes:
        K = np.load(root / "NeRF_gt" / scene / "intrinsics.npy")
        poses = np.load(root / "NeRF" / scene / "poses_test.npy")
        lines += pair_lines(scene, K, poses, min(n_test, len(poses)), rng,
                            min_gap, max_gap)
    return write_lines(lines, pairs_path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--ray-batch", type=int, default=4096)
    ap.add_argument("--n-train-views", type=int, default=36)
    ap.add_argument("--n-test-views", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """The reference's ``main`` under ``settings.DATA_PATH`` (read at call
    time); returns this run's report rows."""
    args = build_parser().parse_args(argv)
    root = Path(settings.DATA_PATH)
    device = resolve_device(args.device)
    gt_root = root / "NeRF_gt"
    scenes = sorted(p.name for p in gt_root.iterdir() if p.is_dir()) \
        if gt_root.is_dir() else []
    if not scenes:
        raise SystemExit("no fabricated scenes - run nerf_scenes first")
    report = {}
    for scene in scenes:
        out_root = root / "NeRF" / scene
        if (out_root / "poses_test.npy").exists():
            print(f"{scene}: already rendered, skipping")
            continue
        src = gt_root / scene
        img_paths = sorted((src / "images" / "training").glob("*.png"),
                           key=lambda p: int(p.stem))
        images = np.stack([png.read_gray(p).astype(np.float32) / 255.0
                           for p in img_paths])
        images = np.repeat(images[..., None], 3, axis=-1)
        poses = np.load(src / "poses.npy")
        K = np.load(src / "intrinsics.npy")
        H, W = images.shape[1:3]

        _sync(device)
        t0 = time.perf_counter()
        model, history = train_nerf_scene(
            images, poses, K, config=FIELD, num_iters=args.iters,
            ray_batch=args.ray_batch, seed=args.seed, device=device)
        _sync(device)
        t_train = time.perf_counter() - t0
        final = f"{history[-1]:.5f}" if history else "n/a"
        print(f"{scene}: NeRF trained {args.iters} it in {t_train:.3f}s, "
              f"final loss {final}", flush=True)

        # training split: 120 deg arc at a fixed mid height
        train_poses = arc_poses(args.n_train_views, radius=4.0, height=0.3,
                                start_deg=0.0)
        test_poses = test_arc(args.n_test_views)
        t0 = time.perf_counter()
        render_dataset(model, scene, train_poses, (H, W), K, config=FIELD,
                       splits={"training": list(range(len(train_poses)))},
                       seed=args.seed, device=device)
        render_dataset(model, scene, test_poses, (H, W), K, config=FIELD,
                       splits={"test": list(range(len(test_poses)))},
                       seed=args.seed + 1, device=device)
        _sync(device)
        t_render = time.perf_counter() - t0
        np.save(out_root / "poses_train.npy", train_poses)
        np.save(out_root / "poses_test.npy", test_poses)
        n_frames = len(train_poses) + len(test_poses)
        print(f"{scene}: rendered {args.n_train_views}+{args.n_test_views} "
              f"views in {t_render:.3f}s", flush=True)
        report[scene] = {"train_s": t_train, "render_s": t_render,
                         "final_loss": history[-1] if history else None,
                         "iters": args.iters, "frames": n_frames,
                         "step_ms": 1e3 * t_train / max(args.iters, 1),
                         "frame_ms": 1e3 * t_render / n_frames}
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    n_pairs = write_pose_pairs(scenes, root / "nerf_pose_pairs.txt",
                               n_test=args.n_test_views, min_gap=2,
                               max_gap=5, root=root)
    print(f"wrote {n_pairs} GT pose pairs")
    report_path = root / "NeRF" / "nerf_leg_report.json"
    report_path.parent.mkdir(parents=True, exist_ok=True)
    # merge: a resumed run renders the scenes left, and keeps the rows of
    # those rendered before
    merged = json.loads(report_path.read_text()) if report_path.exists() \
        else {}
    merged.update(report)
    report_path.write_text(json.dumps(merged, indent=1))
    return report


if __name__ == "__main__":
    main()
