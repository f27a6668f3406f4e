"""Fused conv1 + conv2 + 2x2 max-pool at the entry of the VGG stack.

Replaces ``spnerf_tpu/kernels/conv12_fused_pallas.py:conv12_fused`` with
the CUDA kernel ``csrc/conv12_fused.cu`` (conv1 on the f16 tensor cores,
whose float32 sums of int8 values are exact, conv2 on the int8 tensor
cores through ``csrc/conv_tc_s8.cuh``; see its header for the bound and
the design). On CPU tensors the plain version runs; on CUDA tensors the
kernel, or an error.
``prepare_conv12`` quantizes and packs the weights once
(``Conv12Operands``); ``conv12_fused`` takes those or the raw weights,
which it prepares on every call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_int8,
    conv3x3_int,
    maxpool2x2,
)

K1_DEPTH = 16  # conv1's 9 taps zero-padded to one wgmma k-step of f16


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


@dataclasses.dataclass(frozen=True)
class Conv12Operands:
    """``conv12_fused``'s operands prepared once by ``prepare_conv12``:
    the raw weights, multipliers and biases (what the plain version
    reads) and the kernel's layout of them: ``k1p`` the conv1 slab (the
    int8-quantized (9, 64) taps as f16, zero-padded to K 16,
    ``pack_slabs``), ``m1`` the folded ``mult1 * k1_scale``, ``w2p`` the
    conv2 slabs (``pack_slabs``), all vectors float32."""

    k1: torch.Tensor
    mult1: torch.Tensor
    bias1: torch.Tensor
    w2: torch.Tensor
    mult2: torch.Tensor
    bias2: torch.Tensor
    k1p: torch.Tensor
    m1: torch.Tensor
    b1: torch.Tensor
    w2p: torch.Tensor
    m2: torch.Tensor
    b2: torch.Tensor

    @property
    def raw(self):
        return (self.k1, self.mult1, self.bias1, self.w2, self.mult2,
                self.bias2)


def conv1_operand(kq1: torch.Tensor) -> torch.Tensor:
    """(3, 3, 64) int8 taps -> the (K1_DEPTH, 64) K-padded f16 conv1
    matrix: row 3 dy + dx holds tap (dy, dx), rows 9 onwards zero. The
    kernel runs conv1 on the f16 tensor cores: int8 values are exact in
    f16, and its sums (at most 9 * 127 * 127) exact in float32."""
    return F.pad(kq1.reshape(9, 64).to(torch.float16), (0, 0, 0, K1_DEPTH - 9))


def prepare_conv12(k1, mult1, bias1, w2, mult2, bias2) -> Conv12Operands:
    """Quantize conv1's kernel and pack both convs' weights once: the
    conv1 weight scale folded into its multiplier in float32 as the
    reference does (``mult1 * s1w``), the vectors float32."""
    kq1, s1w = quantize_conv1_weights(k1)
    if w2.dtype != torch.int8 or tuple(w2.shape) != (3, 3, 64, 64):
        raise ValueError(f"prepare_conv12: w2 must be (3, 3, 64, 64) int8, "
                         f"not {tuple(w2.shape)} {w2.dtype}")
    vec = [a.float().contiguous() for a in (mult1.float() * s1w, bias1,
                                            mult2, bias2)]
    return Conv12Operands(k1, mult1, bias1, w2, mult2, bias2,
                          _build.pack_slabs(conv1_operand(kq1)), vec[0],
                          vec[1], _build.pack_slabs(w2), vec[2], vec[3])


def _raw(k1, mult1, bias1, w2, mult2, bias2):
    return k1.raw if isinstance(k1, Conv12Operands) else (
        k1, mult1, bias1, w2, mult2, bias2)


def conv12_fused_plain(image, k1, mult1=None, bias1=None, w2=None,
                       mult2=None, bias2=None, *, relu=True, pool=True):
    """Plain version of ``conv12_fused``, on any device."""
    k1, mult1, bias1, w2, mult2, bias2 = _raw(k1, mult1, bias1, w2, mult2,
                                              bias2)
    kq1, s1w = quantize_conv1_weights(k1)
    m1 = mult1.float() * s1w
    xq = quantize_image(image).to(torch.float64).permute(0, 3, 1, 2)
    acc1 = F.conv2d(xq, kq1.to(torch.float64).permute(2, 0, 1)[:, None],
                    padding=1).permute(0, 2, 3, 1).float()
    a1 = cast_int8(affine(acc1, m1, bias1.float(), True))
    y = affine(conv3x3_int(a1, w2), mult2.float(), bias2.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_int8(y)


def conv12_fused(image, k1, mult1=None, bias1=None, w2=None, mult2=None,
                 bias2=None, *, relu: bool = True,
                 pool: bool = True) -> torch.Tensor:
    """image (B, H, W, 1) f32 -> int8 (B, H/2, W/2, 64), or (B, H, W, 64)
    with ``pool=False`` (H and W even when pooled).

    ``k1``: a ``Conv12Operands`` from ``prepare_conv12`` (the other
    weights then omitted), or the raw (3, 3, 1, 64) float conv1 kernel
    (quantized here per channel) with mult1/bias1 (64,) requantizing
    conv1's accumulator over the int8 image as ``acc * (mult1 *
    k1_scale) + bias1``, w2 (3, 3, 64, 64) int8 and per-channel
    mult2/bias2, prepared on this call (the same bits).
    """
    B, H, W, _ = image.shape
    if pool and (H % 2 or W % 2):
        raise ValueError(f"conv12_fused: H={H}, W={W} must be even to pool")
    if not image.is_cuda:
        return conv12_fused_plain(image, k1, mult1, bias1, w2, mult2, bias2,
                                  relu=relu, pool=pool)
    ops = k1 if isinstance(k1, Conv12Operands) else prepare_conv12(
        k1, mult1, bias1, w2, mult2, bias2)
    if image.dtype != torch.float32 or not image.is_contiguous():
        image = image.float().contiguous()
    _build.check_cuda("conv12_fused", image=image, k1=ops.k1p, m1=ops.m1,
                      b1=ops.b1, w2=ops.w2p, m2=ops.m2, b2=ops.b2)
    shape = (B, H // 2, W // 2, 64) if pool else (B, H, W, 64)
    out = torch.empty(shape, dtype=torch.int8, device=image.device)
    _build.launch("conv12_fused", "conv12_fused_launch", image, ops.k1p,
                  ops.m1, ops.b1, ops.w2p, ops.m2, ops.b2, out, B, H, W,
                  int(pool), int(relu))
    _build.launch_counts["conv12_fused" + ("[pool]" if pool else "")] += 1
    return out
