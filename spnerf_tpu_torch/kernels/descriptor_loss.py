"""Blockwise descriptor hinge loss: forward sums and gradients as CUDA
kernels.

``descriptor_hinge_sums`` replaces ``spnerf_tpu/kernels/
descriptor_loss_pallas.py: descriptor_hinge_sums`` (``_hinge_sums_impl``
and its backward ``_hinge_bwd``) with the kernels of
``csrc/descriptor_loss.cu`` (see its header for the bound and the
design), batched over B instead of ``vmap``ped. For raw descriptors A
(B, N, C), warped descriptors Bm (B, M, C), warped raw-cell centres
``wcells`` (B, N, 2), warped-image cell centres ``cells`` (M, 2) and a
cell mask (B, M)::

    dot  = A Bm^T                                  never stored
    s    = (cy - wy)^2 + (cx - wx)^2 <= radius^2
    pos  = lambda_d * s * relu(pos_margin - dot)
    neg  = (1 - s) * relu(dot - neg_margin)
    S_pair, S_pos, S_neg = sum(mask * (pos + neg)), sum(mask * pos),
                           sum(mask * neg)         per batch item

Gradients flow to A and Bm only, and only from S_pair's cotangent (the
other two sums are summaries for logging). ``descriptor_loss_blockwise``
is the drop-in for the dense ``train.losses.descriptor_loss_from_cells``
(``normalise_descriptors=False`` only), the reference's
``descriptor_loss_pallas``.

Agreement with the plain version and with the reference: d2 and so s are
computed in the same float32 order and agree to the bit; each dot is a
float32 sum over C in another order, so the three sums agree to float32
rounding (relative 1e-5 at the sizes used), and a pair whose dot lies
within rounding of a margin may take the other side of the step in the
gradient (one row of lambda_d * Bm or of Bm).
"""

from __future__ import annotations

import struct

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.train.losses import _cell_mask, cell_grid_coords

_TILE = 64  # forward tile of csrc/descriptor_loss.cu
_MAX_C = 256  # the backward kernel holds one gradient column per thread


def _float_bits(v: float) -> int:
    return struct.unpack("i", struct.pack("f", float(v)))[0]


def hinge_sums_plain(A, Bm, wcells, cells, mask, lambda_d, pos_margin,
                     neg_margin, radius):
    """The kernel's arithmetic in PyTorch ops on any device, dense:
    (S_pair, S_pos, S_neg), each (B,). Plain autograd gives the gradient;
    only S_pair carries one."""
    dot = torch.einsum("bnc,bmc->bnm", A, Bm)
    wy, wx = wcells[..., 0][:, :, None], wcells[..., 1][:, :, None]
    cy, cx = cells[:, 0][None, None, :], cells[:, 1][None, None, :]
    d2 = (cy - wy) ** 2 + (cx - wx) ** 2
    s = (d2 <= radius * radius).float()
    w = mask[:, None, :].float()
    pos = lambda_d * s * torch.relu(pos_margin - dot)
    neg = (1.0 - s) * torch.relu(dot - neg_margin)
    s_pair = (w * (pos + neg)).sum(dim=(1, 2))
    s_pos = (w * pos).sum(dim=(1, 2)).detach()
    s_neg = (w * neg).sum(dim=(1, 2)).detach()
    return s_pair, s_pos, s_neg


def _check(A, Bm, wcells, cells, mask):
    B, N, C = A.shape
    M = Bm.shape[1]
    if (Bm.shape != (B, M, C) or wcells.shape != (B, N, 2)
            or cells.shape != (M, 2) or mask.shape != (B, M)):
        raise ValueError(
            f"descriptor_hinge_sums: A {tuple(A.shape)}, Bm "
            f"{tuple(Bm.shape)}, wcells {tuple(wcells.shape)}, cells "
            f"{tuple(cells.shape)}, mask {tuple(mask.shape)}")
    if C % 4 != 0 or C > _MAX_C:
        raise ValueError(f"descriptor_hinge_sums: C={C}, the kernels take a "
                         f"multiple of 4 up to {_MAX_C}")


class _HingeSums(torch.autograd.Function):
    """The three sums on the card; backward launches the gradient kernel
    twice, for dA and, with the roles of A and Bm exchanged, for dB."""

    @staticmethod
    def forward(ctx, A, Bm, wcells, cells, mask, lambda_d, pos_margin,
                neg_margin, radius):
        B, N, C = A.shape
        M = Bm.shape[1]
        A, Bm = A.float().contiguous(), Bm.float().contiguous()
        wcells = wcells.float().contiguous()
        cells_b = cells.float().expand(B, M, 2).contiguous()
        mask = mask.float().contiguous()
        ones = torch.ones((B, N), dtype=torch.float32, device=A.device)
        bits = tuple(_float_bits(v) for v in
                     (lambda_d, pos_margin, neg_margin, radius * radius))
        n_part = -(-N // _TILE) * -(-M // _TILE)
        partials = torch.empty((B, n_part, 3), dtype=torch.float32,
                               device=A.device)
        sums = torch.empty((B, 3), dtype=torch.float32, device=A.device)
        _build.check_cuda("descriptor_hinge_sums", A=A, Bm=Bm, wcells=wcells,
                          cells=cells_b, mask=mask, partials=partials,
                          sums=sums)
        _build.launch("descriptor_loss", "desc_loss_fwd_launch", A, Bm,
                      wcells, ones, cells_b, mask, partials, sums, n_part, B,
                      N, M, C, *bits)
        _build.launch_counts["desc_loss[fwd]"] += 1
        ctx.save_for_backward(A, Bm, wcells, cells_b, mask, ones)
        ctx.bits = bits
        s_pair, s_pos, s_neg = (sums[:, q].clone() for q in range(3))
        ctx.mark_non_differentiable(s_pos, s_neg)
        return s_pair, s_pos, s_neg

    @staticmethod
    def backward(ctx, g_pair, _g_pos, _g_neg):
        A, Bm, wcells, cells_b, mask, ones = ctx.saved_tensors
        B, N, C = A.shape
        M = Bm.shape[1]
        g = g_pair.float().contiguous()
        dA = dB = None
        if ctx.needs_input_grad[0]:
            dA = torch.empty_like(A)
            _build.check_cuda("descriptor_hinge_sums", g=g, dA=dA)
            _build.launch("descriptor_loss", "desc_loss_bwd_launch", g, A, Bm,
                          wcells, ones, cells_b, mask, dA, B, N, M, C,
                          *ctx.bits)
            _build.launch_counts["desc_loss[dA]"] += 1
        if ctx.needs_input_grad[1]:
            dB = torch.empty_like(Bm)
            _build.check_cuda("descriptor_hinge_sums", g=g, dB=dB)
            _build.launch("descriptor_loss", "desc_loss_bwd_launch", g, Bm, A,
                          cells_b, mask, wcells, ones, dB, B, M, N, C,
                          *ctx.bits)
            _build.launch_counts["desc_loss[dB]"] += 1
        return dA, dB, None, None, None, None, None, None, None


def descriptor_hinge_sums(A, Bm, wcells, cells, mask, lambda_d, pos_margin,
                          neg_margin, radius):
    """(S_pair, S_pos, S_neg), each (B,) float32; see the module docstring.
    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    version."""
    _check(A, Bm, wcells, cells, mask)
    if not A.is_cuda:
        return hinge_sums_plain(A, Bm, wcells, cells, mask, lambda_d,
                                pos_margin, neg_margin, radius)
    return _HingeSums.apply(A, Bm, wcells, cells, mask, float(lambda_d),
                            float(pos_margin), float(neg_margin),
                            float(radius))


def descriptor_loss_blockwise(desc_raw, warped_desc_raw, warped_cells, config,
                              valid_mask=None):
    """Drop-in for the dense ``descriptor_loss_from_cells`` with
    ``normalise_descriptors=False``: (loss, positive summary, negative
    summary) from ``descriptor_hinge_sums``."""
    cfg = config
    g = cfg.grid_size
    B, Hc, Wc, C = desc_raw.shape
    N = Hc * Wc
    cells = cell_grid_coords(Hc, Wc, g, device=desc_raw.device)
    A = desc_raw.reshape(B, N, C)
    Bm = warped_desc_raw.reshape(B, N, C)
    if valid_mask is None:
        mask = torch.ones((B, N), dtype=torch.float32, device=A.device)
    else:
        mask = _cell_mask(valid_mask, g).reshape(B, N)
    s_pair, s_pos, s_neg = descriptor_hinge_sums(
        A, Bm, warped_cells, cells, mask, float(cfg.lambda_d),
        float(cfg.positive_margin), float(cfg.negative_margin), float(g))
    normalization = mask.sum() * N
    loss = cfg.lambda_loss * s_pair.sum() / normalization
    pos = (s_pos.sum() / normalization).detach()
    neg = (s_neg.sum() / normalization).detach()
    return loss, pos, neg
