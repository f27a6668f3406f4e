"""Novel-view camera poses of the NeRF task
(``spnerf_tpu/tasks/nerf_task.py``), numpy.

Only ``pose_orbit`` so far: scene training and ``render_dataset`` of that
module are not ported yet.
"""

from __future__ import annotations

import numpy as np


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
