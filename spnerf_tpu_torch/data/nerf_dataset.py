"""Camera helpers of the NeRF-rendered dataset
(``spnerf_tpu/data/nerf_dataset.py``), numpy.

Only ``camera_intrinsics`` and ``axis_transform`` so far: the dataset
reader of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np


def camera_intrinsics(shape, fov_degrees: float) -> np.ndarray:
    H, W = shape
    c_x, c_y = W // 2, H // 2
    f = c_y / np.tan(np.deg2rad(fov_degrees) / 2.0)
    return np.array([[f, 0, c_x], [0, f, c_y], [0, 0, 1]], np.float32)


def axis_transform(cam_matrix: np.ndarray) -> np.ndarray:
    """NerfStudio -> OpenCV axis flip."""
    return cam_matrix @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(cam_matrix.dtype)
