"""Ray-trace the GT pose-evaluation split of the fabricated NeRF scenes
(``demo/render_gt_test_views.py``).

The scenes are procedural, so the evaluation views are rendered exactly
(the renderer of ``nerf_scenes``) with exact intrinsics and extrinsics:
no NeRF reconstruction artefacts confound the detector / descriptor
comparison. The NeRF renders stay what they are in the reference: the
supervision signal, not the evaluation set.

Outputs (scenes already rendered are skipped):
    NeRF_gt/<scene>/images/test/<i>.png   GT test views
    NeRF_gt/<scene>/depth/test/<i>.npy    GT along-ray depth
    NeRF_gt/<scene>/poses_test.npy        (N, 4, 4) OpenCV cam-to-world
    DATA_PATH/gt_pose_pairs.txt           SuperGlue-format pose pairs

The test arc is the one ``nerf_leg`` renders through the NeRF (radius
4.0, height -0.2, start 150 deg), so NeRF-against-GT test PSNR measures
the renders.

Usage: SPNERF_ROOT=... python -m spnerf_tpu_torch.demo.gt_test_views
[--n-test-views 24]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.demo.nerf_leg import pair_lines, test_arc, write_lines
from spnerf_tpu_torch.demo.nerf_scenes import (build_scene, render_scene,
                                               scene_rng, to_u8)
from spnerf_tpu_torch.demo.standin_data import fresh_cv_rng


def rebuild_rects(scene_index: int, seed: int = 0):
    """Re-fabricate a scene's rectangles: ``build_scene`` is the first
    consumer of the scene's numpy stream in ``nerf_scenes.main``, so a
    fresh generator with the same seed reproduces the geometry. Each
    texture's background also draws from OpenCV's generator, so exact
    textures need every scene rebuilt IN ORDER from a fresh generator:
    ``main`` does, and checks the result against training view 0 before
    rendering anything."""
    return build_scene(scene_rng(seed, scene_index))


def verify_rebuild(root: Path, rects, K) -> None:
    """Raise unless the rebuilt scene renders training view 0 exactly."""
    ref_path = root / "images" / "training" / "0.png"
    ref = png.read_gray(ref_path)
    poses = np.load(root / "poses.npy")
    img, _ = render_scene(rects, K, poses[0], ref.shape)
    if not np.array_equal(ref, to_u8(img)):
        raise RuntimeError(
            f"{root.name}: rebuilt scene does not reproduce {ref_path} "
            "(OpenCV generator out of step: rebuild every scene in order "
            "from a fresh generator)")


def write_gt_pose_pairs(scenes, pairs_path: Path, min_gap: int = 2,
                        max_gap: int = 5, root=None) -> int:
    """``nerf_leg.write_pose_pairs``' protocol (seed 7, gaps 2-5 over the
    test arc) over the GT split, names relative to ``NeRF_gt``."""
    root = Path(settings.DATA_PATH if root is None else root)
    rng = np.random.default_rng(7)
    lines = []
    for scene in scenes:
        scene_root = root / "NeRF_gt" / scene
        K = np.load(scene_root / "intrinsics.npy")
        poses = np.load(scene_root / "poses_test.npy")
        lines += pair_lines(scene, K, poses, len(poses), rng, min_gap,
                            max_gap)
    return write_lines(lines, pairs_path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-test-views", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, root=None) -> None:
    """The reference's ``main`` under ``root`` (default
    ``settings.DATA_PATH``, read at call time)."""
    args = build_parser().parse_args(argv)
    root = Path(settings.DATA_PATH if root is None else root)
    gt_root = root / "NeRF_gt"
    scenes = sorted(p.name for p in gt_root.iterdir() if p.is_dir()) \
        if gt_root.is_dir() else []
    if not scenes:
        raise SystemExit("no fabricated scenes - run nerf_scenes first")
    fresh_cv_rng()
    for s, scene in enumerate(scenes):
        scene_root = gt_root / scene
        # ALWAYS rebuild, finished scenes too: each build advances
        # OpenCV's generator, which the later scenes' textures draw from
        rects = rebuild_rects(s, seed=args.seed)
        K = np.load(scene_root / "intrinsics.npy")
        poses_path = scene_root / "poses_test.npy"
        if poses_path.exists():
            print(f"{scene}: GT test split exists, skipping")
            continue
        verify_rebuild(scene_root, rects, K)
        sample = next((scene_root / "images" / "training").glob("*.png"))
        H, W = png.read_gray(sample).shape
        test_poses = test_arc(args.n_test_views)
        (scene_root / "images" / "test").mkdir(parents=True, exist_ok=True)
        (scene_root / "depth" / "test").mkdir(parents=True, exist_ok=True)
        for i in range(args.n_test_views):
            img, depth = render_scene(rects, K, test_poses[i], (H, W))
            png.write_gray(scene_root / "images" / "test" / f"{i}.png",
                           to_u8(img))
            np.save(scene_root / "depth" / "test" / f"{i}.npy", depth)
        np.save(poses_path, test_poses.astype(np.float32))
        print(f"{scene}: {args.n_test_views} GT test views rendered")

    n = write_gt_pose_pairs(scenes, root / "gt_pose_pairs.txt", root=root)
    print(f"wrote {n} GT pose pairs")


if __name__ == "__main__":
    main()
