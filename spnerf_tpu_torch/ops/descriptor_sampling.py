"""Descriptor sampling at keypoints (``spnerf_tpu/ops/descriptor_sampling.py``).

Reads the raw (Hc, Wc, C) descriptor map at (K, 2) (y, x) pixel
coordinates of the full-resolution image, bicubic (Keys a = -0.75) or
bilinear with clamped taps: pixel p maps to raw coordinate
(p + 0.5) / grid_size - 0.5, the geometry of the x8 bicubic upsample
(align_corners=False) read at that pixel. float32, then optionally
L2-normalized.
"""

from __future__ import annotations

import torch


def cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """(..., 4) Keys cubic weights for source offsets (-1, 0, 1, 2) at
    fractional positions t, in the reference's float32 order."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (-t3 + t2)
    return torch.stack([w0, w1, w2, w3], dim=-1)


def sample_descriptors(desc_raw: torch.Tensor, points: torch.Tensor,
                       grid_size: int = 8, method: str = "bicubic",
                       normalize: bool = True) -> torch.Tensor:
    """(Hc, Wc, C) raw descriptors at (K, 2) (y, x) pixels -> (K, C)
    float32."""
    Hc, Wc, _ = desc_raw.shape
    desc = desc_raw.float()
    src = (points.float() + 0.5) / grid_size - 0.5
    base = torch.floor(src)
    t = src - base
    by, bx = base[:, 0].long(), base[:, 1].long()

    def g(dy, dx):
        return desc[(by + dy).clamp(0, Hc - 1), (bx + dx).clamp(0, Wc - 1)]

    if method == "bilinear":
        ty, tx = t[:, 0:1], t[:, 1:2]
        out = (g(0, 0) * (1 - ty) * (1 - tx) + g(0, 1) * (1 - ty) * tx
               + g(1, 0) * ty * (1 - tx) + g(1, 1) * ty * tx)
    elif method == "bicubic":
        wy, wx = cubic_weights(t[:, 0]), cubic_weights(t[:, 1])
        out = 0.0
        for iy in range(4):
            row = 0.0
            for ix in range(4):
                row = row + g(iy - 1, ix - 1) * wx[:, ix:ix + 1]
            out = out + row * wy[:, iy:iy + 1]
    else:
        raise ValueError(f"sample_descriptors: method={method!r} (bicubic "
                         "or bilinear)")
    if normalize:
        out = out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)
    return out
