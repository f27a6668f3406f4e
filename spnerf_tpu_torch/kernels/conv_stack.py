"""Per-layer kernels of the serving stack: the unfused fallbacks.

Counterpart of ``spnerf_tpu/kernels/conv_stack_pallas.py``:

* ``conv3x3`` replaces ``conv3x3_pallas`` (C_in 128) and
  ``packed_conv3x3`` replaces ``packed_conv3x3_pallas`` (C_in 64), both
  with the CUDA kernel ``csrc/conv3x3.cu``: a SAME 3x3 conv with the
  affine, ReLU, optional 2x2 pool and cast in its epilogue (int8 and bf16
  on the tensor cores, weights by ``_build.pack_slabs``).
  ``prepare_conv3x3`` packs its operands once (``ConvOperands``); raw
  weights are packed on every call. The W-pair packing of the second
  (``pack_pairs``, ``unpack_pairs``, ``pack_weights_*``,
  ``maxpool2x2_packed``) is TPU layout: here both take and return plain
  NHWC.
* ``dot_bias_act`` replaces ``dot_bias_act_pallas`` with
  ``csrc/dot_bias_act.cu``: a per-row product with the same epilogue (the
  unfused heads' 1x1 convs on the tensor cores, and ``conv1_packed``'s
  patch product). ``prepare_dot`` / ``prepare_conv1`` pack its operands
  once (``DotOperands``); raw weights are packed on every call.
* ``conv1_packed`` is the first VGG block on a float32 image as a 9-tap
  patch product, returning plain (B, H, W, 64).

Operands are int8 (int32 sums), bf16 (float32 sums) or, for
``dot_bias_act``, float32. On CPU tensors each wrapper runs its
``*_plain`` version; on CUDA tensors its kernel, or an error. Each
launch adds one to the wrapper's count for its template instance.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_out,
    conv3x3_acc,
    dot_acc,
    maxpool2x2,
)

_DTYPE_NAME = {torch.int8: "int8", torch.bfloat16: "bf16",
               torch.float32: "f32"}


@dataclasses.dataclass(frozen=True)
class ConvOperands:
    """``conv3x3``'s operands prepared once by ``prepare_conv3x3``: the raw
    (3, 3, C_in, C_out) weights, multiplier and bias (what the plain
    version reads) and, where the kernel takes their type, its layout of
    them: ``packed`` (``pack_slabs``' tap slabs), ``m``, ``b`` float32."""

    w: torch.Tensor
    mult: torch.Tensor
    bias: torch.Tensor
    packed: torch.Tensor | None = None
    m: torch.Tensor | None = None
    b: torch.Tensor | None = None


def prepare_conv3x3(w, mult, bias) -> ConvOperands:
    """Pack ``conv3x3``'s weights, multiplier and bias once (int8 or bf16
    weights with C_in a multiple of 16 and C_out of 8); other weights keep
    only the raw operands (the plain version runs them; the kernel
    raises)."""
    cin, cout = w.shape[-2:]
    if w.dtype not in (torch.int8, torch.bfloat16) or cin % 16 or cout % 8:
        return ConvOperands(w, mult, bias)
    return ConvOperands(w, mult, bias, _build.pack_slabs(w),
                        mult.float().contiguous(), bias.float().contiguous())


def _operands(kind, w, mult, bias):
    """(``w`` if it holds prepared operands of type ``kind``, else None;
    the raw (w, mult, bias))."""
    if isinstance(w, kind):
        return w, (w.w, w.mult, w.bias)
    return None, (w, mult, bias)


def conv3x3_plain(x, w, mult=None, bias=None, *, relu=True,
                  out_dtype=torch.int8, pool=False):
    """Plain version of ``conv3x3``, on any device."""
    _, (w, mult, bias) = _operands(ConvOperands, w, mult, bias)
    y = affine(conv3x3_acc(x, w), mult.float(), bias.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_out(y, out_dtype)


def _conv3x3(family, x, w, mult, bias, relu, out_dtype, pool):
    ops, (w, mult, bias) = _operands(ConvOperands, w, mult, bias)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout) or w.dtype != x.dtype:
        raise ValueError(f"{family}: weights {tuple(w.shape)} {w.dtype} for "
                         f"input {tuple(x.shape)} {x.dtype}")
    if pool and (H % 2 or W % 2):
        raise ValueError(f"{family}: pool needs even H, W ({H}x{W})")
    if not x.is_cuda:
        return conv3x3_plain(x, w, mult, bias, relu=relu, out_dtype=out_dtype,
                             pool=pool)
    if x.dtype not in (torch.int8, torch.bfloat16) or out_dtype != x.dtype:
        raise ValueError(f"{family}: the kernel takes int8 or bf16 operands "
                         f"with an output of the same type, not {x.dtype} -> "
                         f"{out_dtype}")
    if ops is None:
        ops = prepare_conv3x3(w, mult, bias)
    if ops.packed is None:
        raise ValueError(f"{family}: no kernel for {cin} -> {cout} channels")
    x = x.contiguous()
    _build.check_cuda(family, x=x, w=ops.packed, mult=ops.m, bias=ops.b)
    shape = (B, H // 2, W // 2, cout) if pool else (B, H, W, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = "conv3x3_launch" if x.dtype == torch.int8 else "conv3x3_bf16_launch"
    _build.launch("conv3x3", fn, x, ops.packed, ops.m, ops.b, out, B, H, W,
                  cin, cout, int(pool), int(relu))
    # one count per template instance
    _build.launch_counts[f"{family}[{_DTYPE_NAME[x.dtype]}-{cin}-{cout}"
                         + ("-pool]" if pool else "]")] += 1
    return out


def conv3x3(x, w, mult=None, bias=None, *, relu: bool = True,
            out_dtype=torch.int8, pool: bool = False) -> torch.Tensor:
    """3x3 SAME conv: ``cast(relu(acc * mult + bias))``.

    x (B, H, W, Cin) int8 or bf16, Cin 128 on the serving path; ``w`` a
    ``ConvOperands`` from ``prepare_conv3x3`` (mult and bias then
    omitted), or the raw (3, 3, Cin, Cout) weights of x's type with
    mult/bias (Cout,) float32, packed on this call (the same bits): for
    int8 mult carries s_in * s_w / s_out and bias the folded bias over
    s_out, for bf16 mult is 1. ``pool=True`` takes the 2x2 max of the
    float32 values before the cast -> (B, H/2, W/2, Cout).
    """
    return _conv3x3("conv3x3", x, w, mult, bias, relu, out_dtype, pool)


def packed_conv3x3(x, w, mult=None, bias=None, *, relu: bool = True,
                   out_dtype=torch.int8, pool: bool = False) -> torch.Tensor:
    """``conv3x3`` for the C_in = 64 layers (blocks 2-5), the counterpart
    of ``packed_conv3x3_pallas`` on plain NHWC."""
    return _conv3x3("packed_conv3x3", x, w, mult, bias, relu, out_dtype, pool)


@dataclasses.dataclass(frozen=True)
class DotOperands:
    """``dot_bias_act``'s operands prepared once by ``prepare_dot``: the
    raw weights (Cin, Cout), multiplier and bias (what the plain version
    reads) and, where a kernel instance takes their shapes, the kernel's
    layout of them: ``packed`` (int8 and bf16: ``pack_rows`` to ``coutp``
    72, ``pack_slabs`` at 256; float32: the (9, 64) weights as they are)
    and ``mult_p``, ``bias_p`` float32 zero-padded to ``coutp``."""

    w: torch.Tensor
    mult: torch.Tensor
    bias: torch.Tensor
    packed: torch.Tensor | None = None
    mult_p: torch.Tensor | None = None
    bias_p: torch.Tensor | None = None
    coutp: int = 0


# operand dtype -> (code, C_in, output dtypes) of the instances of
# csrc/dot_bias_act.cu; C_out: 72 (<= 72 real lanes) or 256 on the
# tensor cores, 64 for float32
_DOT_KERNELS = {
    torch.int8: (0, 256, (torch.bfloat16,)),
    torch.bfloat16: (1, 256, (torch.bfloat16,)),
    torch.float32: (2, 9, (torch.bfloat16, torch.int8)),
}


def _dot_width(dtype, cin, cout):
    """The kernel's padded output width for these shapes, or None."""
    if dtype not in _DOT_KERNELS or cin != _DOT_KERNELS[dtype][1]:
        return None
    if dtype == torch.float32:
        return 64 if cout == 64 else None
    return 72 if cout <= 72 else 256 if cout == 256 else None


def prepare_dot(w, mult, bias) -> DotOperands:
    """Pack ``dot_bias_act``'s weights, multiplier and bias once. Shapes
    no kernel instance takes keep only the raw operands (the plain
    version runs them; the kernel raises)."""
    cin, cout = w.shape
    coutp = _dot_width(w.dtype, cin, cout)
    if coutp is None:
        return DotOperands(w, mult, bias)
    if w.dtype == torch.float32:
        packed = w.contiguous()
    elif coutp == 256:  # wgmma's K-major core matrices
        packed = _build.pack_slabs(w)
    else:  # rows for ldmatrix
        packed = _build.pack_rows(w, coutp)
    pad = (0, coutp - cout)
    mp, bp = (F.pad(a.float(), pad).contiguous() for a in (mult, bias))
    return DotOperands(w, mult, bias, packed, mp, bp, coutp)


def dot_bias_act_plain(x, w, mult=None, bias=None, *, relu=False,
                       out_dtype=torch.bfloat16):
    """Plain version of ``dot_bias_act``, on any device."""
    _, (w, mult, bias) = _operands(DotOperands, w, mult, bias)
    return cast_out(affine(dot_acc(x, w), mult.float(), bias.float(), relu),
                    out_dtype)


def dot_bias_act(x, w, mult=None, bias=None, *, relu: bool = False,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-row (..., Cin) @ (Cin, Cout) with ``cast(relu(acc * mult +
    bias))``: the 1x1 convs of the unfused heads (int8 or bf16 operands,
    Cin 256, Cout <= 72 or 256, bf16 out) and conv1's patch product
    (float32 operands, 9 -> 64, bf16 or int8 out).

    ``w`` is a ``DotOperands`` from ``prepare_dot`` (mult and bias then
    omitted), or the raw (Cin, Cout) weights with mult/bias (Cout,)
    float32, packed on this call (the same bits). Returns (..., Cout)
    ``out_dtype``. The kernel pads C_out inside; only the Cout real lanes
    are written.
    """
    ops, (w, mult, bias) = _operands(DotOperands, w, mult, bias)
    lead, cin = x.shape[:-1], x.shape[-1]
    cout = w.shape[-1]
    if w.shape != (cin, cout) or w.dtype != x.dtype:
        raise ValueError(f"dot_bias_act: weights {tuple(w.shape)} {w.dtype} "
                         f"for input {tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return dot_bias_act_plain(x, w, mult, bias, relu=relu,
                                  out_dtype=out_dtype)
    if ops is None:
        ops = prepare_dot(w, mult, bias)
    code, _, outs = _DOT_KERNELS.get(x.dtype, (0, 0, ()))
    if ops.packed is None or out_dtype not in outs:
        raise ValueError(f"dot_bias_act: no kernel for {x.dtype} "
                         f"{cin} -> {cout} {out_dtype}")
    M = x.numel() // cin
    x = x.contiguous()
    _build.check_cuda("dot_bias_act", x=x, w=ops.packed, mult=ops.mult_p,
                      bias=ops.bias_p)
    out = torch.empty((*lead, cout), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    _build.launch("dot_bias_act", "dot_bias_act_launch", x, ops.packed,
                  ops.mult_p, ops.bias_p, out, M, cin, code, ops.coutp, cout,
                  int(relu), int(out_dtype == torch.int8))
    _build.launch_counts[f"dot_bias_act[{_DTYPE_NAME[x.dtype]}-{cin}-{cout}"
                         + ("-relu]" if relu else "]")] += 1
    return out


def conv1_patches(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B, H, W, 9) float32: channel dy * 3 + dx holds
    pixel (h - 1 + dy, w - 1 + dx), zero outside the image."""
    B, H, W, _ = image.shape
    p = F.pad(image.float()[..., 0], (1, 1, 1, 1))
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=-1)


def prepare_conv1(w1, mult, bias) -> DotOperands:
    """``prepare_dot`` of conv1's (3, 3, 1, Cout) weights as the (9, Cout)
    float32 patch product ``conv1_packed`` runs."""
    return prepare_dot(w1.float().reshape(9, -1), mult, bias)


def _conv1_operands(w1, mult, bias):
    if isinstance(w1, DotOperands):
        return (w1,)
    return w1.float().reshape(9, -1), mult, bias


def conv1_packed_plain(image, w1, mult=None, bias=None, *,
                       out_dtype=torch.int8):
    """Plain version of ``conv1_packed``, on any device."""
    return dot_bias_act_plain(conv1_patches(image),
                              *_conv1_operands(w1, mult, bias), relu=True,
                              out_dtype=out_dtype)


def conv1_packed(image, w1, mult=None, bias=None, *, out_dtype=torch.int8):
    """First VGG block on a float32 grayscale image: (B, H, W, 1) ->
    (B, H, W, Cout) ``cast(relu(conv(image, w1) * mult + bias))``, as one
    float32 (M, 9) @ (9, Cout) patch product through ``dot_bias_act``.
    ``w1`` is the (3, 3, 1, Cout) kernel with mult/bias, or a
    ``DotOperands`` from ``prepare_conv1``.

    The contract of ``conv_stack_pallas.conv1_packed``; its output is
    W-pair packed (B, H, W/2, 2 Cout), this one plain NHWC.
    """
    return dot_bias_act(conv1_patches(image),
                        *_conv1_operands(w1, mult, bias), relu=True,
                        out_dtype=out_dtype)
