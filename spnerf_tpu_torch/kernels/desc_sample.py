"""Bicubic descriptor sampling at keypoints, fused.

``sample_descriptors_fused`` replaces ``spnerf_tpu/kernels/
desc_sample_pallas.py:sample_descriptors_fused`` with the CUDA kernel
``csrc/desc_sample.cu`` (see its header for the bound and the design): a
(B, Hc, Wc, C) map in bf16 or float32 read at (B, K, 2) (y, x) pixel
coordinates -> (B, K, C) float32, optionally L2-normalized. The function
is the reference's ``vmap(sample_descriptors_onehot)`` (Keys a = -0.75,
pixel p at raw coordinate (p + 0.5) / grid_size - 0.5, taps clamped to
the map) with the Pallas kernel's roundings:

- each axis's four taps are clamped to [0, n - 1], and taps that land on
  one index are summed (in tap order) before the product;
- the combined weight is bf16(float32(wy) * float32(wx)), the map is
  read as bf16, products are summed in float32;
- the normalization is out / (sqrt(sum(out^2)) + 1e-12).

``sample_descriptors_fused_plain`` is the same in PyTorch ops, summing
over (y tap, x tap) in row-major order as the kernel does; CPU tensors
take it.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.ops.descriptor_sampling import cubic_weights

_MODES = {torch.bfloat16: ("bf16", 0), torch.float32: ("f32", 1)}


def axis_taps(coord, n: int, grid_size: int):
    """(..., K) pixel coordinates -> (idx, w, first), each a list of the
    four taps' (..., K) tensors: the clamped index, the weight with the
    later taps of the same index added in tap order, and whether the tap
    is the first of its index (the others are merged into it)."""
    src = (coord.float() + 0.5) / grid_size - 0.5
    base = torch.floor(src)
    raw = cubic_weights(src - base).unbind(-1)
    # beyond these bounds every tap clamps to one index anyway
    b = base.clamp(-4, n + 4).to(torch.int64)
    idx = [(b + j - 1).clamp(0, n - 1) for j in range(4)]
    w, first = [], []
    for j in range(4):
        m = raw[j]
        for k in range(j + 1, 4):
            m = torch.where(idx[k] == idx[j], m + raw[k], m)
        w.append(m)
        first.append(idx[j] != idx[j - 1] if j
                     else torch.ones_like(idx[0], dtype=torch.bool))
    return idx, w, first


def _check(desc_raw, points):
    if desc_raw.dim() != 4 or desc_raw.dtype not in _MODES:
        raise ValueError(f"sample_descriptors_fused: desc_raw "
                         f"{tuple(desc_raw.shape)} {desc_raw.dtype}, needs "
                         "(B, Hc, Wc, C) bfloat16 or float32")
    if points.dim() != 3 or points.shape[0] != desc_raw.shape[0] \
            or points.shape[2] != 2:
        raise ValueError(f"sample_descriptors_fused: points "
                         f"{tuple(points.shape)} for {desc_raw.shape[0]} maps, "
                         "needs (B, K, 2)")


def sample_descriptors_fused_plain(desc_raw, points, grid_size: int = 8,
                                   normalize: bool = True):
    """Plain version of ``sample_descriptors_fused``, on any device."""
    _check(desc_raw, points)
    B, Hc, Wc, C = desc_raw.shape
    K = points.shape[1]
    flat = desc_raw.reshape(B, Hc * Wc, C).to(torch.bfloat16).float()
    iy, wy, fy = axis_taps(points[..., 0], Hc, grid_size)
    ix, wx, fx = axis_taps(points[..., 1], Wc, grid_size)
    out = torch.zeros((B, K, C), dtype=torch.float32, device=desc_raw.device)
    for i in range(4):
        for j in range(4):
            w2 = (wy[i] * wx[j]).to(torch.bfloat16).float()
            idx = (iy[i] * Wc + ix[j])[..., None].expand(B, K, C)
            term = w2[..., None] * torch.gather(flat, 1, idx)
            out = out + torch.where((fy[i] & fx[j])[..., None], term, 0.0)
    if normalize:
        out = out / (torch.sqrt((out * out).sum(-1, keepdim=True)) + 1e-12)
    return out


def sample_descriptors_fused(desc_raw, points, grid_size: int = 8,
                             normalize: bool = True):
    """Bicubic descriptors at keypoints: desc_raw (B, Hc, Wc, C) bf16 or
    float32, points (B, K, 2) (y, x) pixels -> (B, K, C) float32. CPU
    tensors take the plain version; on the card it launches the kernel
    (counted as ``desc_sample[bf16]`` or ``[f32]``) or raises."""
    if not desc_raw.is_cuda:
        return sample_descriptors_fused_plain(desc_raw, points, grid_size,
                                              normalize)
    _check(desc_raw, points)
    B, Hc, Wc, C = desc_raw.shape
    K = points.shape[1]
    name, mode = _MODES[desc_raw.dtype]
    desc = desc_raw.contiguous()
    pts = points.float().contiguous()
    out = torch.empty((B, K, C), dtype=torch.float32, device=desc.device)
    if out.numel() == 0:
        return out
    _build.check_cuda("sample_descriptors_fused", desc_raw=desc, points=pts,
                      out=out)
    _build.launch("desc_sample", "desc_sample_launch", desc, pts, out, B, K,
                  Hc, Wc, C, grid_size, int(normalize), mode)
    _build.launch_counts[f"desc_sample[{name}]"] += 1
    return out
