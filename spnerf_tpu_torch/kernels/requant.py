"""Plain PyTorch building blocks shared by the kernels' plain versions.

Counterparts of ``_affine``, ``_cast`` and ``_requant`` in
``spnerf_tpu/kernels/conv_stack_pallas.py``. The affine is two separately
rounded float32 operations (multiply, then add), as in the reference;
the CUDA epilogues use ``__fmul_rn`` / ``__fadd_rn`` for the same reason.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def affine(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
           relu: bool) -> torch.Tensor:
    """float32 ``acc * mult + bias`` (per last-axis channel), optional ReLU."""
    y = acc * mult
    y = y + bias
    return torch.clamp_min(y, 0.0) if relu else y


def cast_int8(y: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to +-127, cast to int8."""
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def maxpool2x2(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of a (B, H, W, C) tensor."""
    B, H, W, C = y.shape
    return y.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def conv3x3_int(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of int8 (B, H, W, Cin) by int8 (3, 3, Cin, Cout)
    -> float32 (B, H, W, Cout) accumulator.

    Runs in float64, which holds every int8 dot exactly (a 3x3x128 dot
    can pass 2**24, where float32 would round), then rounds to float32
    like the reference's ``acc.astype(f32)``.
    """
    xd = x.to(torch.float64).permute(0, 3, 1, 2)
    wd = w.to(torch.float64).permute(3, 2, 0, 1)
    return F.conv2d(xd, wd, padding=1).permute(0, 2, 3, 1).float()

