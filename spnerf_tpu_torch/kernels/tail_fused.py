"""Fused tail of the serving stack: blocks 7-8 and each head.

``double_conv3x3`` (blocks 7-8) is the shared double-conv kernel of
``mid_fused``. ``head`` replaces ``spnerf_tpu/kernels/tail_fused_pallas.py:
head_pallas`` with the CUDA kernel ``csrc/head.cu`` (see its header for
the bound and the design), in an int8 and a bf16 instance.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.mid_fused import double_conv3x3  # noqa: F401
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_out,
    conv3x3_acc,
    dot_acc,
)


def head_plain(x, w3, mult3, bias3, w1, mult1, bias1, *, softmax_lanes=None):
    """Plain version of ``head``, on any device."""
    mid = cast_out(affine(conv3x3_acc(x, w3), mult3.float(), bias3.float(),
                          True), x.dtype)
    out = affine(dot_acc(mid, w1), mult1.float(), bias1.float(), False)
    if softmax_lanes is not None:
        z = out[..., :softmax_lanes]
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        out = (e / e.sum(dim=-1, keepdim=True))[..., :softmax_lanes - 1]
    return out.to(torch.bfloat16)


def head(x, w3, mult3, bias3, w1, mult1, bias1, *,
         softmax_lanes: int | None = None) -> torch.Tensor:
    """One SuperPoint head: 3x3 conv -> requant -> 1x1 dot -> bf16.

    x (B, H, W, 128) int8 or bf16; w3 (3, 3, 128, 256) of x's type with
    mult3/bias3 casting the conv into x's type (int8: requantization);
    w1 (256, Cout) of x's type with mult1/bias1 (Cout,) scaling the dot to
    float (int8: dequantization; bf16: mult 1). ``softmax_lanes=N``
    applies the detector decode: softmax over the N = Cout logits (64
    cells + dustbin) and returns the N - 1 cell probabilities,
    (B, H, W, 64) bf16.
    Otherwise returns (B, H, W, Cout) bf16.
    """
    B, H, W, cin = x.shape
    cm, cout = w3.shape[-1], w1.shape[-1]
    if softmax_lanes is not None and softmax_lanes != cout:
        raise ValueError(f"head: softmax_lanes={softmax_lanes} must equal "
                         f"Cout={cout}")
    if not x.is_cuda:
        return head_plain(x, w3, mult3, bias3, w1, mult1, bias1,
                          softmax_lanes=softmax_lanes)
    if cout > 256:
        raise ValueError(f"head: Cout={cout} > 256 is not supported")
    if x.dtype not in (torch.int8, torch.bfloat16) or w3.dtype != x.dtype \
            or w1.dtype != x.dtype:
        raise ValueError(f"head: no kernel for {x.dtype} input and "
                         f"{w3.dtype}, {w1.dtype} weights")
    # the 1x1 weights are zero-padded to the kernel's lane count; the
    # padded lanes never reach the output
    coutp = 128 if cout <= 128 else 256
    pad = (0, coutp - cout)
    m3, b3 = mult3.float().contiguous(), bias3.float().contiguous()
    m1, b1 = (torch.nn.functional.pad(a.float(), pad).contiguous()
              for a in (mult1, bias1))
    w3p, w1p = _build.pack_words(w3), _build.pack_words(w1, coutp)
    x = x.contiguous()
    _build.check_cuda("head", x=x, w3=w3p, w1=w1p, mult3=m3, bias3=b3,
                      mult1=m1, bias1=b1)
    n_store = cout - 1 if softmax_lanes is not None else cout
    out = torch.empty((B, H, W, n_store), dtype=torch.bfloat16,
                      device=x.device)
    bf16 = x.dtype == torch.bfloat16
    _build.launch("head", "head_bf16_launch" if bf16 else "head_launch", x,
                  w3p, m3, b3, w1p, m1, b1, out, B, H, W, cin, cm, coutp, cout,
                  n_store, int(softmax_lanes is not None))
    _build.launch_counts[f"head[{'bf16-' if bf16 else ''}{cout}"
                         + ("-softmax]" if softmax_lanes else "]")] += 1
    return out
