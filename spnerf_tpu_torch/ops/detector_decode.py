"""Detector head decode: channel softmax -> drop dustbin -> depth-to-space
(``spnerf_tpu/ops/detector_decode.py``)."""

from __future__ import annotations

import torch

from spnerf_tpu_torch.ops.space_ops import depth_to_space


def decode_detector_logits(logits: torch.Tensor,
                           grid_size: int = 8) -> torch.Tensor:
    """(B, Hc, Wc, grid_size**2 + 1) logits -> (B, H, W) probabilities."""
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    return depth_to_space(probs, grid_size)[..., 0]
