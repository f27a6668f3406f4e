"""Plain PyTorch building blocks shared by the kernels' plain versions.

Counterparts of ``_affine``, ``_cast`` and ``_requant`` in
``spnerf_tpu/kernels/conv_stack_pallas.py``, and the two sums of a 3x3
conv: exact integer sums of int8 operands, float sums of bf16 or float32
operands. The affine is two separately
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


def cast_out(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 -> ``dtype``: int8 as ``cast_int8``, otherwise ``.to``
    (bf16: round to nearest even)."""
    return cast_int8(y) if dtype == torch.int8 else y.to(dtype)


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



def conv3x3_float(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of bf16 or float32 (B, H, W, Cin) by (3, 3, Cin, Cout)
    of the same type -> float32 (B, H, W, Cout) accumulator.

    Sums in float64 (each product of two bf16 values is exact there), then
    rounds once to float32: the plain twin of ``jnp.dot(...,
    preferred_element_type=f32)``, whose float32 sums differ from it only
    in the order of their roundings.
    """
    xd = x.to(torch.float64).permute(0, 3, 1, 2)
    wd = w.to(torch.float64).permute(3, 2, 0, 1)
    return F.conv2d(xd, wd, padding=1).permute(0, 2, 3, 1).float()


def conv3x3_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_int`` for int8 operands, else ``conv3x3_float``."""
    return conv3x3_int(x, w) if x.dtype == torch.int8 else conv3x3_float(x, w)


def dot_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., Cin) @ (Cin, Cout) -> float32, summed in float64 (exact for
    int8 operands) and rounded once."""
    return (x.to(torch.float64) @ w.to(torch.float64)).float()
