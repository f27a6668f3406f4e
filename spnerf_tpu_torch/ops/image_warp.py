"""Batched homography warping, erosion and valid masks
(``spnerf_tpu/ops/image_warp.py``).

Convention: ``warp_image(img, H)`` computes dst(p) = src(H^-1 p) for
pixel coordinates p = (x, y, 1), zero outside the source, consistent with
``geometry.homography.warp_points``. The JAX package runs these in XLA
outside any Pallas kernel; here they are PyTorch ops on the card as on
the CPU. The bf16 / int8 warp of homographic adaptation is the CUDA
kernel of ``kernels/warp.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels.warp import (
    invert_homographies,
    source_coords,
    warp_taps,
)


def ellipse_kernel(size: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)):
    per-row half-widths from the ellipse equation."""
    r = size // 2
    c = size // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((size, size), np.float32)
    for i in range(size):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(round(c * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
        kernel[i, max(c - dx, 0):min(c + dx + 1, size)] = 1.0
    return kernel


def binary_erosion(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Erode a binary (B, H, W) mask by a structuring element.

    Pixels outside the image do not erode the border (the input is padded
    with ones); the anchor is (kh // 2, kw // 2), as in kornia and cv2.
    The ones under the element are counted by a float32 convolution with
    cuDNN's TF32 off: sums of 0/1 terms are then exact.
    """
    kh, kw = kernel.shape
    ah, aw = kh // 2, kw // 2
    x = F.pad(mask.float()[:, None], (aw, kw - 1 - aw, ah, kh - 1 - ah),
              value=1.0)
    k = torch.from_numpy(np.asarray(kernel, np.float32)).to(x.device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(x, k[None, None])[:, 0]
    return (out >= float(kernel.sum()) - 0.5).to(mask.dtype)


def _gather(flat, W, yi, xi, H):
    """flat (N, H*W, C) at integer (yi, xi) (N, Ho, Wo), zero outside."""
    N, Ho, Wo = yi.shape
    idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, -1, 1)
    val = torch.gather(flat, 1, idx.expand(-1, -1, flat.shape[-1]))
    inside = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).reshape(N, -1, 1)
    return (val * inside).reshape(N, Ho, Wo, -1)


def _to_index(s, n):
    """floor/round output -> int64 without casting inf or nan (both land
    outside [0, n))."""
    return torch.nan_to_num(s, nan=-2.0).clamp(-2.0, n + 1.0).long()


def warp_image(image: torch.Tensor, homography: torch.Tensor,
               mode: str = "bilinear", out_shape=None) -> torch.Tensor:
    """Warp (B, H, W, C) images by (B, 3, 3) homographies, bilinear (the
    reference's ``t``, ``1 - t`` weights) or nearest, zero outside."""
    B, H, W, C = image.shape
    Ho, Wo = out_shape if out_shape is not None else (H, W)
    sx, sy = source_coords(invert_homographies(homography),
                           (Ho, Wo))
    flat = image.reshape(B, H * W, C)
    if mode != "bilinear":
        return _gather(flat, W, _to_index(torch.round(sy), H),
                       _to_index(torch.round(sx), W), H)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = _to_index(x0, W), _to_index(y0, H)
    v00 = _gather(flat, W, y0i, x0i, H)
    v01 = _gather(flat, W, y0i, x0i + 1, H)
    v10 = _gather(flat, W, y0i + 1, x0i, H)
    v11 = _gather(flat, W, y0i + 1, x0i + 1, H)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def compute_valid_mask(shape: tuple[int, int], homography: torch.Tensor,
                       erosion: int = 0) -> torch.Tensor:
    """(B, H, W) int32 mask of destination pixels whose nearest source
    pixel H^-1 p rounds inside the image, eroded by an ellipse of size
    2 * ``erosion``: the nearest warp of an all-ones image, computed on
    the coordinates alone."""
    return valid_mask_from_inverse(shape, invert_homographies(homography),
                                   erosion)


def valid_mask_from_inverse(shape: tuple[int, int], hinv: torch.Tensor,
                            erosion: int = 0) -> torch.Tensor:
    """``compute_valid_mask`` given H^-1 (N, 3, 3) instead of H."""
    H, W = shape
    sx, sy = source_coords(hinv, (H, W))
    xi, yi = torch.round(sx), torch.round(sy)
    mask = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).float()
    if erosion > 0:
        mask = binary_erosion(mask, ellipse_kernel(erosion * 2))
    return mask.to(torch.int32)


def warp_image_matmul(image: torch.Tensor, homography: torch.Tensor,
                      out_shape=None):
    """Float32 bilinear warp of (B, H, W, 1) images by (N, 3, 3)
    homographies (N = k * B, homography n on image n % B) with hat weights
    relu(1 - |s - x'|), the function of the reference's interpolation
    matmuls. The reference runs it as dense matmuls on the MXU; only two
    x and two y weights per output pixel are non-zero, so here it is the
    4-tap form of ``kernels/warp.py`` in PyTorch ops. The bf16 and int8
    warps are the CUDA kernel's, ``kernels.warp.warp_image_fused``."""
    hinv = invert_homographies(homography)
    return warp_taps(image, hinv, out_shape, torch.float32)
