"""Camera geometry and NeRF depth reprojection
(``spnerf_tpu/geometry/reprojection.py``), batched.

Depth maps hold along-ray (Euclidean) distance, not z-buffer depth: a
pixel unprojects along its unit ray scaled by the depth. Float32
throughout; the 3 x 3 products are sums of elementwise products (never
TF32, whatever the process-wide flag) and the inverses float32 LU
(``torch.linalg.inv``), as the reference's ``jnp.linalg.inv``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion (``.astype(jnp.int32)``): NaN to 0,
    values beyond the int32 range saturate, the rest truncate toward zero.
    A plain ``.to(torch.int32)`` is undefined there (INT_MIN on the CPU),
    and the reference's results depend on it: a point that reprojects to
    NaN lands at pixel (0, 0)."""
    x = torch.nan_to_num(x.float(), nan=0.0)
    high = x >= 2.0 ** 31
    low = x < -(2.0 ** 31)
    out = torch.where(high | low, 0.0, x).to(torch.int32)
    out = torch.where(high, _INT32_MAX, out)
    return torch.where(low, _INT32_MIN, out)


def floor_int32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.floor(x).astype(jnp.int32)``."""
    return float_to_int32(torch.floor(x))


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., I, J) x (..., J, N) in float32 without TF32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def intrinsics_from_fov(shape: tuple[int, int], fov_degrees: float,
                        device=None) -> torch.Tensor:
    """(3, 3) pinhole intrinsics from the image shape and vertical FoV:
    c = size // 2, f = c_y / tan(fov / 2), square pixels."""
    H, W = shape
    c_x, c_y = W // 2, H // 2
    # float64, rounded once: the reference's float32 tan is off by up to
    # an ulp, which the port does not copy
    f = c_y / math.tan(math.radians(fov_degrees) / 2.0)
    return torch.tensor([[f, 0.0, c_x], [0.0, f, c_y], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def nerfstudio_to_cv(cam_to_world: torch.Tensor) -> torch.Tensor:
    """NerfStudio / OpenGL camera axes to OpenCV's: right-multiply the
    (..., 4, 4) transforms by diag(1, -1, -1, 1)."""
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=cam_to_world.dtype,
                        device=cam_to_world.device)
    return cam_to_world * flip


def rotation_translation(transform: torch.Tensor):
    """Split (..., 4, 4) camera-to-world transforms into R (..., 3, 3) and
    t (..., 3, 1)."""
    return transform[..., :3, :3], transform[..., :3, 3:4]


def robust_depth_lookup(depth: torch.Tensor,
                        points: torch.Tensor) -> torch.Tensor:
    """Edge-aware depth at the (floored) point locations.

    depth: (B, H, W); points: (N, 2) or (B, N, 2) float (y, x). Where the
    5 x 5 patch around the point spans a depth range >= 0.03 the point
    likely sits on an object edge and takes the patch minimum (the
    foreground); otherwise, and within 2 px of the border, the centre
    depth. Returns (B, N).
    """
    B, H, W = depth.shape
    iy = floor_int32(points[..., 0]).long()
    ix = floor_int32(points[..., 1]).long()
    planes = depth.reshape(B, 1, H, W)
    # max_pool2d pads with -inf: the minimum is the negated maximum of -d
    dmax = F.max_pool2d(planes, 5, stride=1, padding=2).reshape(B, H * W)
    dmin = -F.max_pool2d(-planes, 5, stride=1, padding=2).reshape(B, H * W)

    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).expand(
        B, points.shape[-2])
    center = depth.reshape(B, H * W).gather(1, idx)
    pmin = dmin.gather(1, idx)
    pmax = dmax.gather(1, idx)

    near_border = (iy <= 2) | (ix <= 2) | (iy >= H - 2) | (ix >= W - 2)
    edge = (pmax - pmin) >= 0.03
    return torch.where(near_border | ~edge, center, pmin)


def warp_points_nerf(points: torch.Tensor, depth: torch.Tensor,
                     intrinsics: torch.Tensor, rotation_in: torch.Tensor,
                     translation_in: torch.Tensor,
                     rotation_warp: torch.Tensor,
                     translation_warp: torch.Tensor) -> torch.Tensor:
    """Reproject (y, x) points from one camera into another through depth.

    points: (N, 2), shared by the batch, or (B, N, 2); depth (B, H, W);
    intrinsics (B, 3, 3); rotations (B, 3, 3); translations (B, 3, 1).
    Robust depth lookup, unproject through K^-1, the ray normalised to
    unit length and scaled by the depth, camera to world by (R_in, t_in),
    world to the target camera by R_w^-1 (x - t_w), project through K.
    Returns (B, N, 2) (y, x) in the target view.
    """
    depth_vals = robust_depth_lookup(depth, points)  # (B, N)
    pts_xy = points.flip(-1).float()
    homog = torch.cat([pts_xy, torch.ones_like(pts_xy[..., :1])], dim=-1)
    homog = homog.expand(depth.shape[0], *homog.shape[-2:])  # (B, N, 3)

    K_inv = torch.linalg.inv(intrinsics.float())
    rays = _mm3(K_inv, homog.transpose(-1, -2))  # (B, 3, N)
    rays = rays / torch.linalg.vector_norm(rays, dim=-2, keepdim=True)
    cam_pts = rays * depth_vals[:, None, :]

    world = _mm3(rotation_in, cam_pts) + translation_in
    R_w_inv = torch.linalg.inv(rotation_warp.float())
    cam2 = _mm3(R_w_inv, world) - _mm3(R_w_inv, translation_warp)
    pix = _mm3(intrinsics, cam2).transpose(-1, -2)  # (B, N, 3)
    pix = pix[..., :2] / pix[..., 2:3]
    return pix.flip(-1)
