"""Two chained SAME 3x3 convs in one kernel, optional 2x2 max-pool.

Replaces ``spnerf_tpu/kernels/mid_fused_pallas.py:
double_packed_conv3x3_pallas`` (blocks 3-4 and 5-6, pool on) and
``spnerf_tpu/kernels/tail_fused_pallas.py:double_conv3x3_pallas``
(blocks 7-8, pool off) with one CUDA kernel, ``csrc/double_conv3x3.cu``
(see its header for the bound and the design), in an int8 instance on
the int8 tensor cores (int32 sums, requantized int8 mid) and a bf16 one
on the bf16 tensor cores (float32 sums, the mid rounded to bf16), both
with weights as ``pack_slabs``' tap slabs. The reference's W-pair
packing is a TPU layout; plain NHWC holds the same bytes.
``prepare_double_conv`` packs the weights once (``DoubleConvOperands``);
``double_conv3x3`` takes those or the raw weights, which it packs on
every call.
"""

from __future__ import annotations

import dataclasses

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_out,
    conv3x3_acc,
    maxpool2x2,
)


@dataclasses.dataclass(frozen=True)
class DoubleConvOperands:
    """``double_conv3x3``'s operands prepared once by
    ``prepare_double_conv``: the raw weights, multipliers and biases (what
    the plain version reads) and, where the kernel takes their type and
    shapes, its layout of them: ``wap``, ``wbp`` the tap slabs of each
    conv (``pack_slabs``), the vectors float32."""

    w_a: torch.Tensor
    mult_a: torch.Tensor
    bias_a: torch.Tensor
    w_b: torch.Tensor
    mult_b: torch.Tensor
    bias_b: torch.Tensor
    wap: torch.Tensor | None = None
    ma: torch.Tensor | None = None
    ba: torch.Tensor | None = None
    wbp: torch.Tensor | None = None
    mb: torch.Tensor | None = None
    bb: torch.Tensor | None = None

    @property
    def raw(self):
        return (self.w_a, self.mult_a, self.bias_a, self.w_b, self.mult_b,
                self.bias_b)


def prepare_double_conv(w_a, mult_a, bias_a, w_b, mult_b,
                        bias_b) -> DoubleConvOperands:
    """Pack both convs' weights for ``double_conv3x3`` once (int8 or bf16
    (3, 3, C_in, C_out) weights with channels in multiples of 16), the
    vectors float32. Other weights keep only the raw operands (the plain
    version runs them; the kernel raises)."""
    raw = (w_a, mult_a, bias_a, w_b, mult_b, bias_b)
    cin, cm = w_a.shape[-2:]
    if w_a.dtype not in (torch.int8, torch.bfloat16) or w_b.dtype != w_a.dtype \
            or w_a.shape != (3, 3, cin, cm) or w_b.shape[:3] != (3, 3, cm) \
            or w_b.dim() != 4 or cin % 16 or cm % 16 or w_b.shape[-1] % 16:
        return DoubleConvOperands(*raw)
    ma, ba, mb, bb = (a.float().contiguous()
                      for a in (mult_a, bias_a, mult_b, bias_b))
    return DoubleConvOperands(*raw, wap=_build.pack_slabs(w_a), ma=ma, ba=ba,
                              wbp=_build.pack_slabs(w_b), mb=mb, bb=bb)


def _raw(w_a, mult_a, bias_a, w_b, mult_b, bias_b):
    return w_a.raw if isinstance(w_a, DoubleConvOperands) else (
        w_a, mult_a, bias_a, w_b, mult_b, bias_b)


def double_conv3x3_plain(x, w_a, mult_a=None, bias_a=None, w_b=None,
                         mult_b=None, bias_b=None, *, relu=True, pool=False):
    """Plain version of ``double_conv3x3``, on any device."""
    w_a, mult_a, bias_a, w_b, mult_b, bias_b = _raw(w_a, mult_a, bias_a, w_b,
                                                    mult_b, bias_b)
    mid = cast_out(affine(conv3x3_acc(x, w_a), mult_a.float(),
                          bias_a.float(), True), x.dtype)
    y = affine(conv3x3_acc(mid, w_b), mult_b.float(), bias_b.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_out(y, x.dtype)


def double_conv3x3(x, w_a, mult_a=None, bias_a=None, w_b=None, mult_b=None,
                   bias_b=None, *, relu: bool = True,
                   pool: bool = False) -> torch.Tensor:
    """``conv_b(cast(relu(conv_a(x))))`` on int8 or bf16 NHWC activations.

    ``w_a``: a ``DoubleConvOperands`` from ``prepare_double_conv`` (the
    other operands then omitted), or the raw weights: w_a (3, 3, Cin,
    Cm), w_b (3, 3, Cm, Co) of x's type; mult/bias (C,) float32 scale each
    conv's sums (int8: requantization; bf16: mult 1), packed on this call
    (the same bits). x (B, H, W, Cin) int8 or bf16. The mid activation, of
    x's type, always gets ReLU; ``relu`` applies to conv_b. Returns (B, H,
    W, Co) of x's type, or (B, H/2, W/2, Co) with ``pool=True``.
    """
    ops = w_a if isinstance(w_a, DoubleConvOperands) else None
    w_a, mult_a, bias_a, w_b, mult_b, bias_b = _raw(w_a, mult_a, bias_a, w_b,
                                                    mult_b, bias_b)
    B, H, W, cin = x.shape
    cm, co = w_a.shape[-1], w_b.shape[-1]
    if w_b.shape[2] != cm:
        raise ValueError(f"double_conv3x3: w_b C_in {w_b.shape[2]} != "
                         f"w_a C_out {cm}")
    if pool and (H % 2 or W % 2):
        raise ValueError(f"double_conv3x3: pool needs even H, W ({H}x{W})")
    if not x.is_cuda:
        return double_conv3x3_plain(x, w_a, mult_a, bias_a, w_b, mult_b,
                                    bias_b, relu=relu, pool=pool)
    if x.dtype not in (torch.int8, torch.bfloat16) or w_a.dtype != x.dtype \
            or w_b.dtype != x.dtype:
        raise ValueError(f"double_conv3x3: no kernel for {x.dtype} input and "
                         f"{w_a.dtype}, {w_b.dtype} weights")
    if ops is None:
        ops = prepare_double_conv(w_a, mult_a, bias_a, w_b, mult_b, bias_b)
    if ops.wap is None:
        raise ValueError(f"double_conv3x3: no kernel for {cin} -> {cm} -> "
                         f"{co} channels")
    x = x.contiguous()
    _build.check_cuda("double_conv3x3", x=x, w_a=ops.wap, w_b=ops.wbp,
                      mult_a=ops.ma, bias_a=ops.ba, mult_b=ops.mb,
                      bias_b=ops.bb)
    shape = (B, H // 2, W // 2, co) if pool else (B, H, W, co)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    fn = "double_conv3x3_bf16_launch" if bf16 else "double_conv3x3_launch"
    _build.launch("double_conv3x3", fn, x, ops.wap, ops.ma, ops.ba, ops.wbp,
                  ops.mb, ops.bb, out, B, H, W, cin, cm, co, int(pool),
                  int(relu))
    # one count per template instance: blocks 3-4, 5-6 and 7-8 differ
    _build.launch_counts[f"double_conv3x3[{'bf16-' if bf16 else ''}{cin}-"
                         f"{cm}-{co}" + ("-pool]" if pool else "]")] += 1
    return out


def double_packed_conv3x3(x, w_a, mult_a=None, bias_a=None, w_b=None,
                          mult_b=None, bias_b=None, *, relu: bool = True,
                          pool: bool = True):
    """Blocks 3-4 / 5-6 of the serving stack (pool on by default)."""
    return double_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b,
                          relu=relu, pool=pool)
