"""Two chained SAME 3x3 int8 convs in one kernel, optional 2x2 max-pool.

Replaces ``spnerf_tpu/kernels/mid_fused_pallas.py:
double_packed_conv3x3_pallas`` (blocks 3-4 and 5-6, pool on) and
``spnerf_tpu/kernels/tail_fused_pallas.py:double_conv3x3_pallas``
(blocks 7-8, pool off) with one CUDA kernel, ``csrc/double_conv3x3.cu``
(see its header for the bound and the design). The reference's W-pair
packing is a TPU layout; plain NHWC holds the same bytes.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_int8,
    conv3x3_int,
    maxpool2x2,
)


def double_conv3x3_plain(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                         relu=True, pool=False):
    """Plain version of ``double_conv3x3``, on any device."""
    mid = cast_int8(affine(conv3x3_int(x, w_a), mult_a.float(),
                           bias_a.float(), True))
    y = affine(conv3x3_int(mid, w_b), mult_b.float(), bias_b.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_int8(y)


def double_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                   relu: bool = True, pool: bool = False) -> torch.Tensor:
    """``conv_b(requant(relu(conv_a(x))))`` on int8 NHWC activations.

    x (B, H, W, Cin) int8; w_a (3, 3, Cin, Cm), w_b (3, 3, Cm, Co) int8;
    mult/bias (C,) float32 requantize each conv's int32 accumulator. The
    mid activation always gets ReLU; ``relu`` applies to conv_b. Returns
    int8 (B, H, W, Co), or (B, H/2, W/2, Co) with ``pool=True``.
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
    args = (mult_a, bias_a, mult_b, bias_b)
    ma, ba, mb, bb = (a.float().contiguous() for a in args)
    wa, wb = _build.pack_dp4a(w_a), _build.pack_dp4a(w_b)
    x = x.contiguous()
    _build.check_cuda("double_conv3x3", x=x, w_a=wa, w_b=wb, mult_a=ma,
                      bias_a=ba, mult_b=mb, bias_b=bb)
    shape = (B, H // 2, W // 2, co) if pool else (B, H, W, co)
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    _build.launch("double_conv3x3", "double_conv3x3_launch", x, wa, ma, ba,
                  wb, mb, bb, out, B, H, W, cin, cm, co, int(pool), int(relu))
    # one count per template instance: blocks 3-4, 5-6 and 7-8 differ
    _build.launch_counts[f"double_conv3x3[{cin}-{cm}-{co}"
                         + ("-pool]" if pool else "]")] += 1
    return out


def double_packed_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b, *,
                          relu: bool = True, pool: bool = True):
    """Blocks 3-4 / 5-6 of the serving stack (pool on by default)."""
    return double_conv3x3(x, w_a, mult_a, bias_a, w_b, mult_b, bias_b,
                          relu=relu, pool=pool)
