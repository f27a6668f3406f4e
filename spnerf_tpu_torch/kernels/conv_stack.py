"""Per-layer kernels of the serving stack: the unfused fallbacks.

Counterpart of ``spnerf_tpu/kernels/conv_stack_pallas.py``:

* ``conv3x3`` replaces ``conv3x3_pallas`` (C_in 128) and
  ``packed_conv3x3`` replaces ``packed_conv3x3_pallas`` (C_in 64), both
  with the CUDA kernel ``csrc/conv3x3.cu``: a SAME 3x3 conv with the
  affine, ReLU, optional 2x2 pool and cast in its epilogue. The W-pair
  packing of the second (``pack_pairs``, ``unpack_pairs``,
  ``pack_weights_*``, ``maxpool2x2_packed``) is TPU layout: here both
  take and return plain NHWC.
* ``dot_bias_act`` replaces ``dot_bias_act_pallas`` with
  ``csrc/dot_bias_act.cu``: a per-row product with the same epilogue (the
  unfused heads' 1x1 convs, and ``conv1_packed``'s patch product).
* ``conv1_packed`` is the first VGG block on a float32 image as a 9-tap
  patch product, returning plain (B, H, W, 64).

Operands are int8 (int32 sums), bf16 (float32 sums) or, for
``dot_bias_act``, float32. On CPU tensors each wrapper runs its
``*_plain`` version; on CUDA tensors its kernel, or an error. Each
launch adds one to the wrapper's count for its template instance.
"""

from __future__ import annotations

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


def conv3x3_plain(x, w, mult, bias, *, relu=True, out_dtype=torch.int8,
                  pool=False):
    """Plain version of ``conv3x3``, on any device."""
    y = affine(conv3x3_acc(x, w), mult.float(), bias.float(), relu)
    if pool:  # pool the f32 values, as the reference does
        y = maxpool2x2(y)
    return cast_out(y, out_dtype)


def _conv3x3(family, x, w, mult, bias, relu, out_dtype, pool):
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
    m, b = mult.float().contiguous(), bias.float().contiguous()
    wp = _build.pack_words(w)
    x = x.contiguous()
    _build.check_cuda(family, x=x, w=wp, mult=m, bias=b)
    shape = (B, H // 2, W // 2, cout) if pool else (B, H, W, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = "conv3x3_launch" if x.dtype == torch.int8 else "conv3x3_bf16_launch"
    _build.launch("conv3x3", fn, x, wp, m, b, out, B, H, W, cin, cout,
                  int(pool), int(relu))
    # one count per template instance
    _build.launch_counts[f"{family}[{_DTYPE_NAME[x.dtype]}-{cin}-{cout}"
                         + ("-pool]" if pool else "]")] += 1
    return out


def conv3x3(x, w, mult, bias, *, relu: bool = True, out_dtype=torch.int8,
            pool: bool = False) -> torch.Tensor:
    """3x3 SAME conv: ``cast(relu(acc * mult + bias))``.

    x (B, H, W, Cin) int8 or bf16, Cin 128 on the serving path; w
    (3, 3, Cin, Cout) of x's type; mult/bias (Cout,) float32: for int8
    mult carries s_in * s_w / s_out and bias the folded bias over s_out,
    for bf16 mult is 1. ``pool=True`` takes the 2x2 max of the float32
    values before the cast -> (B, H/2, W/2, Cout).
    """
    return _conv3x3("conv3x3", x, w, mult, bias, relu, out_dtype, pool)


def packed_conv3x3(x, w, mult, bias, *, relu: bool = True,
                   out_dtype=torch.int8, pool: bool = False) -> torch.Tensor:
    """``conv3x3`` for the C_in = 64 layers (blocks 2-5), the counterpart
    of ``packed_conv3x3_pallas`` on plain NHWC."""
    return _conv3x3("packed_conv3x3", x, w, mult, bias, relu, out_dtype, pool)


def dot_bias_act_plain(x, w, mult, bias, *, relu=False,
                       out_dtype=torch.bfloat16):
    """Plain version of ``dot_bias_act``, on any device."""
    return cast_out(affine(dot_acc(x, w), mult.float(), bias.float(), relu),
                    out_dtype)


# operand dtype -> (code, padded C_in, padded C_outs, output dtypes) of
# the instances of csrc/dot_bias_act.cu
_DOT_KERNELS = {
    torch.int8: (0, 256, (128, 256), (torch.bfloat16,)),
    torch.bfloat16: (1, 256, (128, 256), (torch.bfloat16,)),
    torch.float32: (2, 12, (64,), (torch.bfloat16, torch.int8)),
}


def dot_bias_act(x, w, mult, bias, *, relu: bool = False,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-row (..., Cin) @ (Cin, Cout) with ``cast(relu(acc * mult +
    bias))``: the 1x1 convs of the unfused heads (int8 or bf16 operands,
    bf16 out) and conv1's patch product (float32 operands).

    mult/bias (Cout,) float32. Returns (..., Cout) ``out_dtype``. The
    kernel pads C_in (to 256, or 12 for float32) and C_out (to 64, 128 or
    256) inside; only the Cout real lanes are written.
    """
    lead, cin = x.shape[:-1], x.shape[-1]
    cout = w.shape[-1]
    if w.shape != (cin, cout) or w.dtype != x.dtype:
        raise ValueError(f"dot_bias_act: weights {tuple(w.shape)} {w.dtype} "
                         f"for input {tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return dot_bias_act_plain(x, w, mult, bias, relu=relu,
                                  out_dtype=out_dtype)
    code, cinp, couts, outs = _DOT_KERNELS.get(x.dtype, (0, 0, (), ()))
    coutp = next((c for c in couts if cout <= c), None)
    if (cin > cinp or cin * x.element_size() % 4 or coutp is None
            or out_dtype not in outs):
        raise ValueError(f"dot_bias_act: no kernel for {x.dtype} "
                         f"{cin} -> {cout} {out_dtype}")
    M = x.numel() // cin
    pad = (0, coutp - cout)
    m, b = (F.pad(a.float(), pad).contiguous() for a in (mult, bias))
    wp = _build.pack_words(w, coutp, cinp)
    x = x.contiguous()
    _build.check_cuda("dot_bias_act", x=x, w=wp, mult=m, bias=b)
    out = torch.empty((*lead, cout), dtype=out_dtype, device=x.device)
    _build.launch("dot_bias_act", "dot_bias_act_launch", x, wp, m, b, out, M,
                  cin, code, cinp, coutp, cout, int(relu),
                  int(out_dtype == torch.int8))
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


def conv1_packed_plain(image, w1, mult, bias, *, out_dtype=torch.int8):
    """Plain version of ``conv1_packed``, on any device."""
    return dot_bias_act_plain(conv1_patches(image), w1.float().reshape(9, -1),
                              mult, bias, relu=True, out_dtype=out_dtype)


def conv1_packed(image, w1, mult, bias, *, out_dtype=torch.int8):
    """First VGG block on a float32 grayscale image: (B, H, W, 1) ->
    (B, H, W, Cout) ``cast(relu(conv(image, w1) * mult + bias))``, as one
    float32 (M, 9) @ (9, Cout) patch product through ``dot_bias_act``.

    The contract of ``conv_stack_pallas.conv1_packed``; its output is
    W-pair packed (B, H, W/2, 2 Cout), this one plain NHWC.
    """
    return dot_bias_act(conv1_patches(image), w1.float().reshape(9, -1),
                        mult, bias, relu=True, out_dtype=out_dtype)
