"""Validation metrics (``spnerf_tpu/train/metrics.py``)."""

from __future__ import annotations

import torch


def precision_recall(pred_pts: torch.Tensor, kpts_heatmap: torch.Tensor):
    """Precision and recall of binary predicted keypoints against the
    label heatmap, both (B, H, W) in {0, 1}."""
    pred = pred_pts.float()
    labels = kpts_heatmap.float()
    tp = (pred * labels).sum()
    return tp / (pred.sum() + 1e-10), tp / (labels.sum() + 1e-10)
