"""Blockwise descriptor hinge loss: forward sums and gradients as CUDA
kernels on the TF32 tensor cores.

``descriptor_hinge_sums`` replaces ``spnerf_tpu/kernels/
descriptor_loss_pallas.py: descriptor_hinge_sums`` (``_hinge_sums_impl``
and its backward ``_hinge_bwd``) with the kernels of
``csrc/descriptor_loss.cu``, batched over B instead of ``vmap``ped. For
raw descriptors A (B, N, C), warped descriptors Bm (B, M, C), warped
raw-cell centres ``wcells`` (B, N, 2), warped-image cell centres
``cells`` (M, 2) and a cell mask (B, M)::

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

The design (the ``.cu`` header has the derivations): every dot is three
wgmma passes over operands split into two TF32 values (hi.hi + hi.lo +
lo.hi), summed in chunks of 32 of C and the chunks added to nearest, so a
dot lies within delta = kappa(C) ||a|| ||b|| of the exact one (kappa(256)
= 2.88e-6). Operations bound all three kernels; at the training shape the
TF32 bound is 0.0089 ms for the forward and 0.0149 for each gradient. The
forward's sums take the tensor cores' dots. A gradient's step is not
continuous in the dot, so a pair within twice delta of its margin (the
band) sums its dot again in float64 and steps on that: every step is the
exact dot's. The gradient product ddot Y runs on the tensor cores too (Y
split; ddot split where it is not a TF32 value), transposed. The card is
filled by units of 128 (forward) or 64 (gradient) rows of X against 32 of
Y, spread evenly over one block per SM; every sum has a fixed order and
no float atomics, so two runs give the same bits. The band's repairs are
counted on the card (``repaired_pairs``).

Agreement with the plain version and with the reference: d2 and so s are
computed in the same float32 order and agree to the bit; the three sums
agree to float32 rounding of the sums (relative 1e-5 at the sizes used);
the gradients agree wherever the float32 dots of the plain version take
the exact dot's side of each step.

Per shape and device the wrapper keeps its scratch (the kernels' partial
sums, used in stream order) and reads A, Bm and the coordinates in place
when they are float32 and contiguous: ``cells`` is shared by the batch
items (stride 0), and a side without weights passes none.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.parallel import mesh as dp
from spnerf_tpu_torch.train.losses import _cell_mask, cell_grid_coords

_MAX_C = 256  # csrc/descriptor_loss.cu kCMax: the tiles' shared memory

_CHUNK = 32  # csrc/descriptor_loss.cu kChunk: the depth of a chunk's sums

_scratch: dict = {}  # (device, B, NX, NY, C) -> (forward, gradient) scratch
_repairs: dict = {}  # device -> the band's repairs in dA, dB


@functools.lru_cache(maxsize=None)
def _bits(lambda_d, pos_margin, neg_margin, radius) -> tuple:
    """lambda_d, the margins and radius^2 as float32 bit patterns."""
    return tuple(struct.unpack("i", struct.pack("f", float(v)))[0] for v in
                 (lambda_d, pos_margin, neg_margin, radius * radius))


def kappa(C: int) -> float:
    """The bound of ``csrc/descriptor_loss.cu``'s kappa(C): a tensor-core
    dot lies within kappa(C) ||a||_2 ||b||_2 of the exact one (the split,
    the tensor cores' truncation in chunks of 32, the chunks' adds); the
    gradient's band is twice that."""
    n_chunks = -(-C // _CHUNK)
    return (3.01 * 2.0 ** -22 + 52.2 * 2.0 ** -25
            + (n_chunks + 2) * 1.01 * 2.0 ** -24)


def _scratch_for(device, B, NX, NY, C):
    """(forward partials, gradient partials) for X (B, NX, C) against Y
    (B, NY, C), sized by the kernels' own plan for this card."""
    key = (device, B, NX, NY, C)
    if key not in _scratch:
        fn = _build.load("descriptor_loss").desc_loss_scratch
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        floats = (ctypes.c_longlong * 2)()
        with torch.cuda.device(device):
            err = fn(B, NX, NY, C, floats)
        if err != 0:
            raise RuntimeError(f"desc_loss_scratch: CUDA error {err}")
        _scratch[key] = tuple(torch.empty(max(1, n), dtype=torch.float32,
                                          device=device) for n in floats)
    return _scratch[key]


def _repair_counters(device) -> tuple:
    """(dA's, dB's) int64 counters of the band's repairs on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _repairs:
        _repairs[device] = tuple(torch.zeros(1, dtype=torch.int64, device=device)
                                 for _ in range(2))
    return _repairs[device]


def repaired_pairs(device) -> tuple:
    """(dA, dB): the pairs the gradient kernels have summed again in
    float64 on ``device`` so far (counters the kernels add to; reading
    them waits for the card)."""
    return tuple(int(c.item()) for c in _repair_counters(device))


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
    once per gradient asked for: dA, and with the roles of A and Bm
    exchanged, dB."""

    @staticmethod
    def forward(ctx, A, Bm, wcells, cells, mask, lambda_d, pos_margin,
                neg_margin, radius):
        B, N, C = A.shape
        M = Bm.shape[1]
        A, Bm = A.float().contiguous(), Bm.float().contiguous()
        wcells, cells = wcells.float().contiguous(), cells.float().contiguous()
        mask = mask.float().contiguous()
        bits = _bits(lambda_d, pos_margin, neg_margin, radius)
        partials = _scratch_for(A.device, B, N, M, C)[0]
        sums = [torch.empty(B, dtype=torch.float32, device=A.device)
                for _ in range(3)]
        _build.check_cuda("descriptor_hinge_sums", A=A, Bm=Bm, wcells=wcells,
                          cells=cells, mask=mask)
        _build.launch("descriptor_loss", "desc_loss_fwd_launch", A, Bm,
                      wcells, 2 * N, None, cells, 0, mask, partials,
                      partials.numel(), *sums, None, B, N, M, C, *bits)
        _build.launch_counts["desc_loss[fwd]"] += 1
        ctx.save_for_backward(A, Bm, wcells, cells, mask)
        ctx.bits = bits
        ctx.mark_non_differentiable(sums[1], sums[2])
        return tuple(sums)

    @staticmethod
    def backward(ctx, g_pair, _g_pos, _g_neg):
        A, Bm, wcells, cells, mask = ctx.saved_tensors
        B, N, C = A.shape
        M = Bm.shape[1]
        g = g_pair.float().contiguous()
        _build.check_cuda("descriptor_hinge_sums", g=g)
        counters = _repair_counters(A.device)
        dA = dB = None
        if ctx.needs_input_grad[0]:
            dA = torch.empty_like(A)
            partials = _scratch_for(A.device, B, N, M, C)[1]
            _build.launch("descriptor_loss", "desc_loss_bwd_launch", g, A, Bm,
                          wcells, 2 * N, None, cells, 0, mask, dA, partials,
                          partials.numel(), counters[0], B, N, M, C,
                          *ctx.bits)
            _build.launch_counts["desc_loss[dA]"] += 1
        if ctx.needs_input_grad[1]:
            dB = torch.empty_like(Bm)
            partials = _scratch_for(A.device, B, M, N, C)[1]
            _build.launch("descriptor_loss", "desc_loss_bwd_launch", g, Bm, A,
                          cells, 0, mask, wcells, 2 * N, None, dB, partials,
                          partials.numel(), counters[1], B, M, N, C,
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


def tensor_core_dots(A, Bm):
    """The forward kernel's dots A Bm^T (B, N, M) on the card, as its
    tensor cores sum them (float32 operands, contiguous): the probe of the
    bound delta in the tests and ``chip_smoke.py``."""
    B, N, C = A.shape
    M = Bm.shape[1]
    if Bm.shape != (B, M, C) or C % 4 != 0 or C > _MAX_C:
        raise ValueError(f"tensor_core_dots: A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}: C a multiple of 4 up to "
                         f"{_MAX_C}")
    coords = torch.zeros((max(N, M), 2), dtype=torch.float32, device=A.device)
    partials = _scratch_for(A.device, B, N, M, C)[0]
    sums = [torch.empty(B, dtype=torch.float32, device=A.device)
            for _ in range(3)]
    dots = torch.empty((B, N, M), dtype=torch.float32, device=A.device)
    _build.check_cuda("tensor_core_dots", A=A, Bm=Bm, dots=dots)
    _build.launch("descriptor_loss", "desc_loss_fwd_launch", A, Bm, coords,
                  0, None, coords, 0, None, partials, partials.numel(), *sums,
                  dots, B, N, M, C, *_bits(250.0, 1.0, 0.2, 8.0))
    _build.launch_counts["desc_loss[fwd]"] += 1
    return dots


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
    normalization = dp.batch_sum(mask.sum()) * N
    loss = cfg.lambda_loss * s_pair.sum() / normalization
    pos = (s_pos.sum() / normalization).detach()
    neg = (s_neg.sum() / normalization).detach()
    return loss, pos, neg
