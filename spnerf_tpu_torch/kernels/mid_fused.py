"""Two chained SAME 3x3 convs in one kernel, optional 2x2 max-pool.

Replaces ``spnerf_tpu/kernels/mid_fused_pallas.py:
double_packed_conv3x3_pallas`` (blocks 3-4 and 5-6, pool on) and
``spnerf_tpu/kernels/tail_fused_pallas.py:double_conv3x3_pallas``
(blocks 7-8, pool off) with one CUDA kernel, ``csrc/double_conv3x3.cu``
(see its header for the bound and the design), in an int8 instance
(int32 sums, requantized mid; weights by ``pack_words``) and a bf16 one
on the tensor cores (float32 sums, the mid rounded to bf16 in shared
memory; weights by ``pack_slabs``). The reference's W-pair packing is a
TPU layout; plain NHWC holds the same bytes.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_out,
    conv3x3_acc,
    maxpool2x2,
)


def double_conv3x3_plain(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                         relu=True, pool=False):
    """Plain version of ``double_conv3x3``, on any device."""
    mid = cast_out(affine(conv3x3_acc(x, w_a), mult_a.float(),
                          bias_a.float(), True), x.dtype)
    y = affine(conv3x3_acc(mid, w_b), mult_b.float(), bias_b.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_out(y, x.dtype)


def double_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                   relu: bool = True, pool: bool = False) -> torch.Tensor:
    """``conv_b(cast(relu(conv_a(x))))`` on int8 or bf16 NHWC activations.

    x (B, H, W, Cin) int8 or bf16; w_a (3, 3, Cin, Cm), w_b (3, 3, Cm, Co)
    of x's type; mult/bias (C,) float32 scale each conv's sums (int8:
    requantization; bf16: mult 1). The mid activation, of x's type,
    always gets ReLU; ``relu`` applies to conv_b. Returns (B, H, W, Co) of
    x's type, or (B, H/2, W/2, Co) with ``pool=True``.
    """
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
    args = (mult_a, bias_a, mult_b, bias_b)
    ma, ba, mb, bb = (a.float().contiguous() for a in args)
    bf16 = x.dtype == torch.bfloat16
    pack = _build.pack_slabs if bf16 else _build.pack_words
    wa, wb = pack(w_a), pack(w_b)
    x = x.contiguous()
    _build.check_cuda("double_conv3x3", x=x, w_a=wa, w_b=wb, mult_a=ma,
                      bias_a=ba, mult_b=mb, bias_b=bb)
    shape = (B, H // 2, W // 2, co) if pool else (B, H, W, co)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = "double_conv3x3_bf16_launch" if bf16 else "double_conv3x3_launch"
    _build.launch("double_conv3x3", fn, x, wa, ma, ba, wb, mb, bb, out, B, H,
                  W, cin, cm, co, int(pool), int(relu))
    # one count per template instance: blocks 3-4, 5-6 and 7-8 differ
    _build.launch_counts[f"double_conv3x3[{'bf16-' if bf16 else ''}{cin}-"
                         f"{cm}-{co}" + ("-pool]" if pool else "]")] += 1
    return out


def double_packed_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                          relu: bool = True, pool: bool = True):
    """Blocks 3-4 / 5-6 of the serving stack (pool on by default)."""
    return double_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b,
                          relu=relu, pool=pool)
