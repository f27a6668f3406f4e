"""Novel-view camera poses and scene files of the NeRF task
(``spnerf_tpu/tasks/nerf_task.py``), numpy.

``pose_orbit`` and ``write_scene``, the file-writing half of the
reference's ``render_dataset``; scene training and rendering wait for
``models/nerf.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.png import write_gray


def pose_orbit(n_frames: int, radius: float = 4.0, height: float = 0.5,
               look_at=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Simple orbit of OpenCV-convention cam-to-world poses for novel-view
    rendering around a scene center."""
    poses = []
    center = np.asarray(look_at, np.float64)
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        eye = np.array([radius * np.cos(theta), height, radius * np.sin(theta)])
        forward = center - eye
        forward = forward / np.linalg.norm(forward)
        tmp_up = np.array([0.0, -1.0, 0.0])  # OpenCV: y down
        right = np.cross(tmp_up, forward)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        T = np.eye(4)
        T[:3, 0] = right
        T[:3, 1] = down
        T[:3, 2] = forward
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses).astype(np.float32)


def write_scene(scene_name: str, rgb: np.ndarray, depth: np.ndarray,
                poses: np.ndarray, splits: dict | None = None) -> Path:
    """Write rendered views into the NeRF dataset layout under
    DATA_PATH/NeRF/<scene_name>: per split ``images/<split>/<j>.png`` (8-bit
    gray, the mean of ``rgb``'s channels times 255, clipped),
    ``camera_transforms/<split>/<j>.npy`` (the pose in NerfStudio's axes,
    pose @ diag(1, -1, -1, 1); the dataset flips it back) and
    ``depth/<split>/<j>.npy`` (along-ray depth).

    rgb (N, H, W, C) in [0, 1]; depth (N, H, W); poses (N, 4, 4)
    OpenCV-convention cam-to-world; splits {split: [frame index, ...]},
    default every frame in "training"."""
    root = Path(settings.DATA_PATH, "NeRF", scene_name)
    splits = splits or {"training": list(range(len(poses)))}
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    for split, indices in splits.items():
        for sub in ("images", "camera_transforms", "depth"):
            (root / sub / split).mkdir(parents=True, exist_ok=True)
        for j, idx in enumerate(indices):
            gray = np.clip(np.asarray(rgb[idx]).mean(-1) * 255.0, 0,
                           255).astype(np.uint8)
            write_gray(root / "images" / split / f"{j}.png", gray)
            np.save(root / "camera_transforms" / split / f"{j}.npy",
                    poses[idx] @ flip)
            np.save(root / "depth" / split / f"{j}.npy", depth[idx])
    return root
