"""Fixed-shape keypoint sets (``spnerf_tpu/geometry/keypoints.py``):
(N, 2) padded (y, x) points with an (N,) validity mask; filtering returns
masks instead of shrinking arrays."""

from __future__ import annotations

import torch


def filter_points_mask(points: torch.Tensor,
                       shape: tuple[int, int]) -> torch.Tensor:
    """(..., N) bool: 0 <= y < H - 1 and 0 <= x < W - 1."""
    H, W = shape
    y, x = points[..., 0], points[..., 1]
    return (y >= 0) & (y < H - 1) & (x >= 0) & (x < W - 1)


def compute_keypoint_map(points: torch.Tensor, shape: tuple[int, int],
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter (..., N, 2) (y, x) float points into binary (..., H, W)
    int32 maps: round (half to even, as the reference does), bounds check,
    set 1. Invalid and padded points are dropped, not clamped into the
    map: they write a 0 that a maximum never keeps."""
    H, W = shape
    coords = torch.round(points)
    valid = filter_points_mask(coords, shape)
    if mask is not None:
        valid = valid & mask.bool()
    coords = torch.nan_to_num(coords, nan=0.0).clamp(0, max(H, W)).long()
    idx = torch.where(valid, coords[..., 0] * W + coords[..., 1], 0)
    kmap = torch.zeros(points.shape[:-2] + (H * W,), dtype=torch.int32,
                       device=points.device)
    kmap.scatter_reduce_(-1, idx, valid.to(torch.int32), reduce="amax")
    return kmap.reshape(points.shape[:-2] + (H, W))


def top_k_keypoints(prob: torch.Tensor, k: int, threshold: float = 0.0):
    """The k best pixels of an (H, W) heatmap: (points (k, 2) int32 (y, x),
    scores (k,), valid (k,) bool, scores >= threshold)."""
    H, W = prob.shape
    scores, idx = torch.topk(prob.reshape(-1), min(k, H * W))
    pts = torch.stack([idx // W, idx % W], dim=-1).to(torch.int32)
    return pts, scores, scores >= threshold
