"""Multi-view NeRF pseudo-label fusion (``spnerf_tpu/ops/nerf_label_fusion
.py``), batched over the source frames.

Detections of the other rendered views of a scene are reprojected into
the target view through depth and splatted as 3 x 3 patches of the
source's probabilities (1 x 1 near a border), then mean-aggregated with
the target's own heatmap. Overlapping splats resolve by maximum. Every
source frame is splatted at once: one reprojection of (F, K) points and
one ``scatter_reduce_`` into F flat maps with a spare slot that takes
the dropped writes.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.geometry.reprojection import (
    floor_int32,
    warp_points_nerf,
)


def splat_reprojected_points(source_prob: torch.Tensor,
                             source_pts: torch.Tensor,
                             target_pts: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """source_prob (F, H, W) heatmaps, source_pts (F, K, 2) (y, x) detected
    in each source, target_pts (F, K, 2) float (y, x) reprojected into the
    target, mask (F, K) -> (F, H, W) splats.

    Coordinates convert as XLA converts them (``floor_int32``): a point
    that reprojects to NaN lands at (0, 0), as in the reference."""
    F, H, W = source_prob.shape
    sy = floor_int32(source_pts[..., 0]).long()
    sx = floor_int32(source_pts[..., 1]).long()
    ty = floor_int32(target_pts[..., 0]).long()
    tx = floor_int32(target_pts[..., 1]).long()

    in_target = (ty >= 0) & (ty < H - 1) & (tx >= 0) & (tx < W - 1)
    mask = mask.bool() & in_target
    near_border = ((ty <= 1) | (tx <= 1) | (ty >= H - 1) | (tx >= W - 1)
                   | (sy <= 1) | (sx <= 1) | (sy >= H - 1) | (sx >= W - 1))

    d = torch.arange(-1, 2, device=source_prob.device)
    dy = d.repeat_interleave(3)  # (9,) row-major 3 x 3
    dx = d.repeat(3)
    gy = (sy[..., None] + dy).clamp(0, H - 1)
    gx = (sx[..., None] + dx).clamp(0, W - 1)
    flat = source_prob.reshape(F, H * W)
    vals = flat.gather(1, (gy * W + gx).reshape(F, -1))  # (F, K * 9)

    center = (dy == 0) & (dx == 0)
    use = torch.where(near_border[..., None], center, True) & mask[..., None]
    oy = ty[..., None] + dy
    ox = tx[..., None] + dx
    bad = ~use | (oy < 0) | (oy >= H) | (ox < 0) | (ox >= W)
    idx = torch.where(bad, H * W, oy * W + ox).reshape(F, -1)

    out = torch.zeros((F, H * W + 1), dtype=source_prob.dtype,
                      device=source_prob.device)
    out.scatter_reduce_(1, idx, vals, reduce="amax")
    return out[:, :H * W].reshape(F, H, W)


def fuse_nerf_labels(probs, nms_pts, nms_mask, depths, intrinsics,
                     rotations, translations, target: int,
                     selected) -> torch.Tensor:
    """Mean-fused (H, W) heatmap of frame ``target`` (before NMS and the
    threshold).

    probs (F, H, W) decoded heatmaps; nms_pts (F, K, 2) NMS'd detections
    and nms_mask (F, K); depths (F, H, W) along-ray; intrinsics (F, 3,
    3); rotations (F, 3, 3) and translations (F, 3, 1) camera to world
    (OpenCV axes); selected (F,) bool, the source frames to fuse."""
    F = probs.shape[0]
    selected = torch.as_tensor(selected, device=probs.device).bool()
    not_target = torch.arange(F, device=probs.device) != target
    pts = nms_pts.float()
    expand = lambda t: t[target].expand(F, *t.shape[1:])  # noqa: E731
    unwarped = warp_points_nerf(pts, depths, expand(intrinsics), rotations,
                                translations, expand(rotations),
                                expand(translations))
    use = nms_mask.bool() & (selected & not_target)[:, None]
    splats = splat_reprojected_points(probs, pts, unwarped, use)
    n_views = 1.0 + (selected & not_target).sum()
    return (probs[target] + splats.sum(dim=0)) / n_views
