"""Depth-to-space and space-to-depth for NHWC tensors.

Channel order is ``torch.pixel_shuffle``'s: input channel
``c * r * r + i * r + j`` goes to offset (i, j) of its r x r cell, as in
``spnerf_tpu/ops/space_ops.py``.
"""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, r*r*C) -> (B, H*r, W*r, C)."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)  # B H i W j c
    return x.reshape(B, H * r, W * r, c)



def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, r*r*C), ``torch.pixel_unshuffle``
    order."""
    B, Hr, Wr, C = x.shape
    H, W = Hr // r, Wr // r
    x = x.reshape(B, H, r, W, r, C).permute(0, 1, 3, 5, 2, 4)  # B H W C i j
    return x.reshape(B, H, W, C * r * r)
