"""Camera rays of the in-framework NeRF (``spnerf_tpu/models/nerf.py``).

Only ``camera_rays`` so far: the field and the hierarchical renderer of
that module are not ported yet.
"""

from __future__ import annotations

import torch


def camera_rays(shape, intrinsics: torch.Tensor, cam_to_world: torch.Tensor):
    """Unit-length rays for every pixel of an (H, W) image.

    OpenCV camera convention (x right, y down, z forward); cam_to_world
    is (4, 4). Returns (origins (H*W, 3), directions (H*W, 3) unit length),
    float32 on the device of ``intrinsics``. K is inverted in float64 and
    rounded once (the reference inverts in float32).
    """
    H, W = shape
    dev = intrinsics.device
    K = intrinsics.float()
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(H * W, device=dev)], dim=-1)
    K_inv = torch.linalg.inv(K.double()).float()
    dirs_cam = pix @ K_inv.T
    R = cam_to_world[:3, :3].float().to(dev)
    t = cam_to_world[:3, 3].float().to(dev)
    dirs = dirs_cam @ R.T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return t.expand_as(dirs), dirs
