"""Fused tail of the serving stack: blocks 7-8 and each head.

``double_conv3x3`` (blocks 7-8) is the shared double-conv kernel of
``mid_fused``. ``head`` replaces ``spnerf_tpu/kernels/tail_fused_pallas.py:
head_pallas`` with the CUDA kernel ``csrc/head.cu`` (see its header for
the bound and the design): an int8 and a bf16 instance, both on the
tensor cores (``wgmma``). ``prepare_head`` packs a head's weights once
(``HeadOperands``); ``head`` takes those or the raw weights, which it
packs on every call.
"""

from __future__ import annotations

import dataclasses

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.mid_fused import double_conv3x3  # noqa: F401
from spnerf_tpu_torch.kernels.requant import (
    affine,
    cast_out,
    conv3x3_acc,
    dot_acc,
)


@dataclasses.dataclass(frozen=True)
class HeadOperands:
    """A head's operands prepared once by ``prepare_head``: the raw
    weights, multipliers and biases (what the plain version reads) and,
    where a kernel instance takes their shapes, the kernel's layout of
    them: ``w3p``, ``w1p`` packed, ``m1p``, ``b1p`` float32 zero-padded
    to ``coutp`` lanes (int8: 80 or 256; bf16: 72 or 256)."""

    w3: torch.Tensor
    mult3: torch.Tensor
    bias3: torch.Tensor
    w1: torch.Tensor
    mult1: torch.Tensor
    bias1: torch.Tensor
    w3p: torch.Tensor | None = None
    m3p: torch.Tensor | None = None
    b3p: torch.Tensor | None = None
    w1p: torch.Tensor | None = None
    m1p: torch.Tensor | None = None
    b1p: torch.Tensor | None = None
    coutp: int = 0

    @property
    def raw(self):
        return (self.w3, self.mult3, self.bias3, self.w1, self.mult1,
                self.bias1)


def _head_width(dtype, cin, cm, cout):
    """The kernel's padded lane count for these shapes, or None."""
    if cin != 128 or cm != 256:
        return None
    if dtype == torch.int8:
        return 80 if cout <= 80 else 256 if cout <= 256 else None
    if dtype == torch.bfloat16:
        return 72 if cout <= 72 else 256 if cout <= 256 else None
    return None


def prepare_head(w3, mult3, bias3, w1, mult1, bias1) -> HeadOperands:
    """Pack a head's weights for ``head`` once, as the tensor cores' slabs
    (``pack_slabs``, ``pack_head_1x1``); ``mult1`` and ``bias1`` float32,
    zero-padded.
    Shapes no kernel instance takes keep only the raw operands (the plain
    version runs them; the kernel raises)."""
    if w1.dtype != w3.dtype:
        raise ValueError(f"prepare_head: weights {w3.dtype} and {w1.dtype}")
    cin, cm = w3.shape[-2:]
    cout = w1.shape[-1]
    coutp = _head_width(w3.dtype, cin, cm, cout)
    raw = (w3, mult3, bias3, w1, mult1, bias1)
    if coutp is None or w3.shape != (3, 3, cin, cm) or w1.shape != (cm, cout):
        return HeadOperands(*raw)
    pad = (0, coutp - cout)
    w3p, w1p = _build.pack_slabs(w3), _build.pack_head_1x1(w1, coutp)
    m1p, b1p = (torch.nn.functional.pad(a.float(), pad).contiguous()
                for a in (mult1, bias1))
    return HeadOperands(*raw, w3p=w3p, m3p=mult3.float().contiguous(),
                        b3p=bias3.float().contiguous(), w1p=w1p, m1p=m1p,
                        b1p=b1p, coutp=coutp)


def _operands(fn, args):
    """(HeadOperands or None, raw operands) from a call's arguments: one
    HeadOperands, or the six raw tensors."""
    if len(args) == 1 and isinstance(args[0], HeadOperands):
        return args[0], args[0].raw
    if len(args) != 6:
        raise TypeError(f"{fn}: takes HeadOperands or (w3, mult3, bias3, w1, "
                        f"mult1, bias1), not {len(args)} operands")
    return None, args


def head_plain(x, *operands, softmax_lanes=None):
    """Plain version of ``head``, on any device."""
    _, (w3, mult3, bias3, w1, mult1, bias1) = _operands("head_plain", operands)
    mid = cast_out(affine(conv3x3_acc(x, w3), mult3.float(), bias3.float(),
                          True), x.dtype)
    out = affine(dot_acc(mid, w1), mult1.float(), bias1.float(), False)
    if softmax_lanes is not None:
        z = out[..., :softmax_lanes]
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        out = (e / e.sum(dim=-1, keepdim=True))[..., :softmax_lanes - 1]
    return out.to(torch.bfloat16)


def head(x, *operands, softmax_lanes: int | None = None) -> torch.Tensor:
    """One SuperPoint head: 3x3 conv -> requant -> 1x1 dot -> bf16.

    ``operands``: a ``HeadOperands`` from ``prepare_head``, or the raw
    ``w3, mult3, bias3, w1, mult1, bias1`` (packed on this call; the same
    bits). x (B, H, W, 128) int8 or bf16; w3 (3, 3, 128, 256) of x's type
    with mult3/bias3 casting the conv into x's type (int8:
    requantization); w1 (256, Cout) of x's type with mult1/bias1 (Cout,)
    scaling the dot to float (int8: dequantization; bf16: mult 1).
    ``softmax_lanes=N`` applies the detector decode: softmax over the N =
    Cout logits (64 cells + dustbin) and returns the N - 1 cell
    probabilities, (B, H, W, 64) bf16. Otherwise returns (B, H, W, Cout)
    bf16.
    """
    ops, (w3, mult3, bias3, w1, mult1, bias1) = _operands("head", operands)
    B, H, W, cin = x.shape
    cm, cout = w3.shape[-1], w1.shape[-1]
    if softmax_lanes is not None and softmax_lanes != cout:
        raise ValueError(f"head: softmax_lanes={softmax_lanes} must equal "
                         f"Cout={cout}")
    if not x.is_cuda:
        return head_plain(x, w3, mult3, bias3, w1, mult1, bias1,
                          softmax_lanes=softmax_lanes)
    if x.dtype not in (torch.int8, torch.bfloat16) or w3.dtype != x.dtype \
            or w1.dtype != x.dtype:
        raise ValueError(f"head: no kernel for {x.dtype} input and "
                         f"{w3.dtype}, {w1.dtype} weights")
    if ops is None:
        ops = prepare_head(w3, mult3, bias3, w1, mult1, bias1)
    bf16 = x.dtype == torch.bfloat16
    if ops.coutp == 0 or (softmax_lanes is not None
                          and ops.coutp != (72 if bf16 else 80)):
        raise ValueError(f"head: no kernel for {x.dtype} {cin} -> {cm} -> "
                         f"{cout}" + (" with softmax" if softmax_lanes else ""))
    x = x.contiguous()
    _build.check_cuda("head", x=x, w3=ops.w3p, w1=ops.w1p, mult3=ops.m3p,
                      bias3=ops.b3p, mult1=ops.m1p, bias1=ops.b1p)
    n_store = cout - 1 if softmax_lanes is not None else cout
    out = torch.empty((B, H, W, n_store), dtype=torch.bfloat16,
                      device=x.device)
    _build.launch("head", "head_bf16_launch" if bf16 else "head_launch", x,
                  ops.w3p, ops.m3p, ops.b3p, ops.w1p, ops.m1p, ops.b1p, out,
                  B, H, W, cin, cm, ops.coutp, cout, n_store,
                  int(softmax_lanes is not None))
    _build.launch_counts[f"head[{'bf16-' if bf16 else ''}{cout}"
                         + ("-softmax]" if softmax_lanes else "]")] += 1
    return out
