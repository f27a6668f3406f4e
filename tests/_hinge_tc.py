"""A model of the arithmetic of ``csrc/descriptor_loss.cu``'s tensor-core
kernels, for the tests.

``split`` is the kernel's split of a float32 value into two TF32 values
(``cvt.rna.tf32.f32`` twice), ``tc_dot`` its dot of rows a and b: per
chunk of 32 of C, hi.hi, lo.hi and hi.lo each in an accumulator of its
own, a chain of wgmma k8 steps (``_render_tc.tc_step``: exact products,
each product and the running sum cut toward zero below the largest
exponent, the sum rounded toward zero), then the three and the chunks
added to nearest in float32: in the forward all chunks in order, in the
gradient each warpgroup over half of them and then the two halves.
``step`` is the gradient's step with the band: pairs whose dot lies
within twice ``kappa(C) ||a|| ||b||`` of their margin take the float64
dot's side. ``tc_grad`` is dX = g * ddot Y as the
gradient kernel forms it for one block per tile of X: per 32 rows of Y a
fresh accumulator takes ddot_lo.Y_hi (where ddot is not all TF32 values),
ddot_hi.Y_lo and then ddot_hi.Y_hi, and a running total adds the units to
nearest (the kernel's split of a tile over blocks reassociates those adds).
"""

import numpy as np
import torch

from _render_tc import tc_step
from spnerf_tpu_torch.kernels.descriptor_loss import kappa

CHUNK = 32  # descriptor_loss.cu kChunk
TJ = 32  # rows of Y a unit (kTJ)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero
    (``cvt.rna.tf32.f32``): the low 13 bits rounded off the magnitude."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def is_tf32(x: torch.Tensor) -> torch.Tensor:
    return (x.float().contiguous().view(torch.int32) & 0x1FFF) == 0


def split(x: torch.Tensor):
    """x (float32) -> (hi, lo), TF32 values with x - hi - lo within 2^-22
    |x|; x - hi is exact in float32."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def _pad_chunk(x: torch.Tensor) -> torch.Tensor:
    """Zero columns up to a multiple of 32 (the kernel reads C so)."""
    pad = -x.shape[1] % CHUNK
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _chunk_sums(ah, al, bh, bl, chunks):
    """The chunks' sums in order: per chunk hi.hi, lo.hi and hi.lo each a
    fresh chain of 4 k-steps, chunk = big + (lo.hi + hi.lo)."""
    tot = torch.zeros((ah.shape[0], bh.shape[0]), dtype=torch.float32)
    for i, ch in enumerate(chunks):
        big = lh = hl = None
        for k in range(ch * CHUNK, (ch + 1) * CHUNK, 8):
            ks = slice(k, k + 8)
            lh = tc_step(al[:, ks], bh[:, ks].T, lh)
            hl = tc_step(ah[:, ks], bl[:, ks].T, hl)
            big = tc_step(ah[:, ks], bh[:, ks].T, big)
        chunk = big + (lh + hl)
        tot = chunk if i == 0 else tot + chunk
    return tot


def tc_dot(a: torch.Tensor, b: torch.Tensor, halves: bool = False):
    """a (N, C) . b (M, C)^T of float32 rows as the kernels sum it: (N, M)
    float32. The forward's warpgroups sum all the chunks in order; the
    gradient's (``halves``) each half of them (the first ceil(n / 2), or
    the rest), then the two halves."""
    ah, al = split(_pad_chunk(a.float()))
    bh, bl = split(_pad_chunk(b.float()))
    n_chunks = ah.shape[1] // CHUNK
    if not halves:
        return _chunk_sums(ah, al, bh, bl, range(n_chunks))
    half = (n_chunks + 1) // 2
    return (_chunk_sums(ah, al, bh, bl, range(half))
            + _chunk_sums(ah, al, bh, bl, range(half, n_chunks)))


def band(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The gradient kernel's band half-width per pair, 2 kappa(C) ||a||
    ||b||, (N, M) float64."""
    norms = (a.double().norm(dim=-1)[:, None]
             * b.double().norm(dim=-1)[None, :])
    return 2.0 * kappa(a.shape[1]) * norms


def step(a, b, near, lambda_d, pos_margin, neg_margin):
    """(the step of each pair (N, M) float32, the band's pairs) for rows a,
    b and ``near`` (N, M) bool: the tensor cores' dot outside the band, the
    float64 dot inside it."""
    dot = tc_dot(a, b, halves=True).double()
    exact = a.double() @ b.double().T
    margin = torch.where(near, torch.tensor(float(pos_margin)).double(),
                         torch.tensor(float(neg_margin)).double())
    repaired = (dot - margin).abs() <= band(a, b)
    d = torch.where(repaired, exact, dot)
    s = torch.where(near, torch.where(d < margin, -float(lambda_d), 0.0),
                    torch.where(d > margin, 1.0, 0.0))
    return s.float(), repaired


def tc_grad(ddot: torch.Tensor, y: torch.Tensor, g: float) -> torch.Tensor:
    """g * ddot (N, M) @ y (M, C) as the gradient kernel sums it (one
    block per tile of X): (N, C) float32."""
    M = ddot.shape[1]
    pad = -M % TJ
    ddot = torch.nn.functional.pad(ddot.float(), (0, pad))
    y = torch.nn.functional.pad(y.float(), (0, 0, 0, pad))
    dh, dl = split(ddot)
    yh, yl = split(y)
    total = None
    for j0 in range(0, ddot.shape[1], TJ):
        need_lo = bool((dl[:, j0:j0 + TJ] != 0).any())
        acc = None
        passes = ([(dl, yh)] if need_lo else []) + [(dh, yl), (dh, yh)]
        for p, q in passes:
            for k in range(j0, j0 + TJ, 8):
                acc = tc_step(p[:, k:k + 8], q[k:k + 8], acc)
        total = acc if total is None else total + acc
    return total * np.float32(g)


def hinge(a, b, wcells, cells, mask, lambda_d, pos_margin, neg_margin,
          radius, g):
    """One batch item through the modelled kernels: (S_pair, S_pos, S_neg)
    as float32, dA and dB for S_pair's cotangent g, and the band's pairs.
    The hinge and its sums in float64 (the kernel's fixed-order float32
    sums differ from them by float32 rounding of the sums only)."""
    dot = tc_dot(a, b).double()
    dy = cells[None, :, 0] - wcells[:, None, 0]
    dx = cells[None, :, 1] - wcells[:, None, 1]
    near = (dy * dy + dx * dx) <= radius * radius
    w = mask.double()[None, :].expand_as(dot)
    pos = torch.where(near, lambda_d * torch.relu(pos_margin - dot), 0.0)
    neg = torch.where(near, 0.0, torch.relu(dot - neg_margin))
    sums = [float((w * (pos + neg)).sum()), float((w * pos).sum()),
            float((w * neg).sum())]
    s, repaired = step(a, b, near, lambda_d, pos_margin, neg_margin)
    ddot = (w.float() * s)
    return (sums, tc_grad(ddot, b, g), tc_grad(ddot.T.contiguous(), a, g),
            repaired)
