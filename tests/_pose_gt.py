"""The pose files' shared tree: DATA_PATH with the demo's scene 0 GT test
views 0..n-1 (the scene rebuilt and ray-traced as ``demo/gt_test_views.py``
does, 240 x 320) and their pose pairs (seed 7, gaps 2-5, as
``gt_test_views`` writes them)."""

from pathlib import Path

import numpy as np

from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.demo import (gt_test_views, nerf_leg, nerf_scenes,
                                   standin_data)

SCENE = "demo_scene00"


def write_gt_tree(data: Path, n_views: int):
    """Write the tree under ``data``; returns (data, the views as uint8
    arrays, the pair lines)."""
    args = nerf_scenes.build_parser().parse_args([])
    shape = (args.height, args.width)
    K = nerf_scenes.camera_intrinsics(shape, args.fov)
    standin_data.fresh_cv_rng()
    rects = gt_test_views.rebuild_rects(0)
    poses = nerf_leg.test_arc(12)[:n_views]
    images = data / "NeRF_gt" / SCENE / "images" / "test"
    images.mkdir(parents=True)
    views = []
    for i, pose in enumerate(poses):
        img, _ = nerf_scenes.render_scene(rects, K, pose, shape)
        views.append(nerf_scenes.to_u8(img))
        png.write_gray(images / f"{i}.png", views[-1])
    lines = nerf_leg.pair_lines(SCENE, K, poses, n_views,
                                np.random.default_rng(7), 2, 5)
    nerf_leg.write_lines(lines, data / "gt_pose_pairs.txt")
    return data, views, lines
