"""Fused conv1 + conv2 + 2x2 max-pool at the entry of the VGG stack.

Replaces ``spnerf_tpu/kernels/conv12_fused_pallas.py:conv12_fused`` with
the CUDA kernel ``csrc/conv12_fused.cu`` (see its header for the bound
and the design). On CPU tensors the plain version runs; on CUDA tensors
the kernel, or an error.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_int8,
    conv3x3_int,
    maxpool2x2,
)


def quantize_conv1_weights(k1: torch.Tensor):
    """Per-channel symmetric int8 quantization of the (3, 3, 1, 64) conv1
    kernel -> (kq (3, 3, 64) int8, scale (64,) f32): scale =
    max(absmax, 1e-12) / 127 (unlike ``quantize_weights``'s absmax + 1e-12)."""
    k = k1.float().reshape(3, 3, 64)
    scale = torch.clamp_min(k.abs().amax(dim=(0, 1)), 1e-12) / 127.0
    kq = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return kq, scale


def quantize_image(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) float in [0, 1] -> (B, H, W, 1) int8 at scale 127."""
    return cast_int8(image.float() * 127.0)


def _operands(k1, mult1, bias1, mult2, bias2):
    """Quantized conv1 kernel and float32 requant vectors, the conv1
    weight scale folded into its multiplier in float32 as the reference
    does (``mult1 * s1w``)."""
    kq1, s1w = quantize_conv1_weights(k1)
    return (kq1, mult1.float() * s1w, bias1.float(), mult2.float(),
            bias2.float())


def conv12_fused_plain(image, k1, mult1, bias1, w2, mult2, bias2, *,
                       relu=True, pool=True):
    """Plain version of ``conv12_fused``, on any device."""
    kq1, m1, b1, m2, b2 = _operands(k1, mult1, bias1, mult2, bias2)
    xq = quantize_image(image).to(torch.float64).permute(0, 3, 1, 2)
    acc1 = F.conv2d(xq, kq1.to(torch.float64).permute(2, 0, 1)[:, None],
                    padding=1).permute(0, 2, 3, 1).float()
    a1 = cast_int8(affine(acc1, m1, b1, True))
    y = affine(conv3x3_int(a1, w2), m2, b2, relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_int8(y)


def conv12_fused(image, k1, mult1, bias1, w2, mult2, bias2, *,
                 relu: bool = True, pool: bool = True) -> torch.Tensor:
    """image (B, H, W, 1) f32 -> int8 (B, H/2, W/2, 64), or (B, H, W, 64)
    with ``pool=False``.

    k1 (3, 3, 1, 64) float conv1 kernel (quantized here per channel);
    mult1/bias1 (64,) requantize conv1's accumulator over the int8 image
    as ``acc * (mult1 * k1_scale) + bias1``; w2 (3, 3, 64, 64) int8 with
    per-channel mult2/bias2.
    """
    B, H, W, _ = image.shape
    if H % 2 or W % 2:
        raise ValueError(f"conv12_fused: H={H}, W={W} must be even")
    if not image.is_cuda:
        return conv12_fused_plain(image, k1, mult1, bias1, w2, mult2, bias2,
                                  relu=relu, pool=pool)
    kq1, m1, b1, m2, b2 = _operands(k1, mult1, bias1, mult2, bias2)
    image = image.float().contiguous()
    k1p = kq1.reshape(9, 64).contiguous()
    w2p = _build.pack_words(w2)
    _build.check_cuda("conv12_fused", image=image, k1=k1p, m1=m1, b1=b1,
                      w2=w2p, m2=m2, b2=b2)
    shape = (B, H // 2, W // 2, 64) if pool else (B, H, W, 64)
    out = torch.empty(shape, dtype=torch.int8, device=image.device)
    _build.launch("conv12_fused", "conv12_fused_launch", image, k1p, m1, b1,
                  w2p, m2, b2, out, B, H, W, int(pool), int(relu))
    _build.launch_counts["conv12_fused" + ("[pool]" if pool else "")] += 1
    return out
