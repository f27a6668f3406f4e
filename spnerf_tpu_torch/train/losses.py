"""Training losses: detector cross-entropy and descriptor hinge
(``spnerf_tpu/train/losses.py``). NHWC; the pairwise descriptor volume of
the dense path is one batched (N, C) x (C, N) matmul; the warped cells
come from a homography or, for NeRF pairs, a depth reprojection. The
blockwise ``normalise_descriptors=False`` loss is the CUDA kernel of
``kernels/descriptor_loss.py``.

Every loss is a sum over the batch divided by a normaliser (the batch
size, the sum of the cell mask); inside a data-parallel step the
normaliser is that of the global batch (``parallel.mesh.batch_sum``), so
that each rank's loss is its share of the global loss.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from spnerf_tpu_torch.geometry.homography import warp_points
from spnerf_tpu_torch.geometry.reprojection import warp_points_nerf
from spnerf_tpu_torch.ops.space_ops import space_to_depth
from spnerf_tpu_torch.parallel import mesh as dp


def _cell_mask(valid_mask: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B, H, W) pixel mask -> (B, Hc, Wc) float cell mask: 1 where every
    pixel of the cell is valid."""
    cells = space_to_depth(valid_mask[..., None].float(), grid_size)
    return torch.prod(cells, dim=-1)


def detector_loss(noise: torch.Tensor, logits: torch.Tensor,
                  kpts_heatmap: torch.Tensor,
                  valid_mask: torch.Tensor | None = None,
                  grid_size: int = 8) -> torch.Tensor:
    """Per-cell 65-way cross-entropy with dustbin.

    logits: (B, Hc, Wc, 65); kpts_heatmap: (B, H, W) binary; valid_mask:
    (B, H, W) or None (all valid); noise: (B, Hc, Wc, 65) U(0, 0.1)
    tie-break noise, drawn by the caller (the reference draws it from its
    key, ``spnerf_tpu/train/losses.py:52``).

    Labels: the pixel-unshuffled heatmap times 2 beside an always-on
    dustbin channel, argmax after adding the noise: a cell with keypoints
    picks one of them at random, an empty cell picks the dustbin.
    """
    labels = space_to_depth(kpts_heatmap[..., None].float(), grid_size)
    B, Hc, Wc, _ = labels.shape
    dustbin = torch.ones((B, Hc, Wc, 1), dtype=torch.float32,
                         device=labels.device)
    labels = torch.cat([2.0 * labels, dustbin], dim=-1)
    label_idx = torch.argmax(labels + noise, dim=-1)  # (B, Hc, Wc)

    if valid_mask is None:
        mask = torch.ones((B, Hc, Wc), dtype=torch.float32,
                          device=labels.device)
    else:
        mask = _cell_mask(valid_mask, grid_size)

    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, label_idx[..., None], dim=-1)[..., 0]
    ce = logz - picked
    per_image = (ce * mask).sum(dim=(1, 2)) / (mask.sum(dim=(1, 2)) + 1e-10)
    return per_image.sum() / dp.batch_sum(per_image.new_tensor(float(B)))


def detector_noise(gen: torch.Generator, logits_shape) -> torch.Tensor:
    """The U(0, 0.1) tie-break noise of ``detector_loss`` for logits of
    ``logits_shape``, drawn from ``gen`` on its device."""
    return 0.1 * torch.rand(tuple(logits_shape), generator=gen,
                            dtype=torch.float32, device=gen.device)


@dataclasses.dataclass(frozen=True)
class DescriptorLossConfig:
    grid_size: int = 8
    lambda_d: float = 250.0
    lambda_loss: float = 0.0001
    positive_margin: float = 1.0
    negative_margin: float = 0.2
    normalise_descriptors: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "DescriptorLossConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def cell_grid_coords(Hc: int, Wc: int, grid_size: int,
                     device=None) -> torch.Tensor:
    """(Hc*Wc, 2) float32 (y, x) centres of the strided cell grid."""
    ys, xs = torch.meshgrid(torch.arange(Hc, device=device),
                            torch.arange(Wc, device=device), indexing="ij")
    cells = torch.stack([ys, xs], dim=-1).reshape(-1, 2)
    return (cells * grid_size + grid_size // 2).float()


def descriptor_loss_from_cells(desc_raw, warped_desc_raw, warped_cells,
                               config: DescriptorLossConfig,
                               valid_mask=None):
    """Hinge contrastive loss over all cell pairs, dense.

    desc_raw, warped_desc_raw: (B, Hc, Wc, C) raw head outputs;
    warped_cells: (B, Hc*Wc, 2) raw-image cell centres warped into the
    warped image; valid_mask: (B, H, W) over the warped image, or None.
    Returns (loss, positive summary, negative summary).
    """
    cfg = config
    g = cfg.grid_size
    B, Hc, Wc, C = desc_raw.shape
    N = Hc * Wc

    cells = cell_grid_coords(Hc, Wc, g, device=desc_raw.device)
    diff = cells[None, None, :, :] - warped_cells[:, :, None, :]
    dist = torch.linalg.norm(diff, dim=-1)  # (B, N, N)

    A = desc_raw.reshape(B, N, C)
    Bm = warped_desc_raw.reshape(B, N, C)

    if cfg.normalise_descriptors:
        s = (dist <= (g - 0.5)).float()
        A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
        Bm = Bm / (torch.linalg.norm(Bm, dim=-1, keepdim=True) + 1e-12)
        dot = torch.relu(torch.einsum("bnc,bmc->bnm", A, Bm))
        # double normalisation of the volume: across warped cells (m) per
        # (b, n), then across raw cells (n)
        dot = dot / (torch.linalg.norm(dot, dim=2, keepdim=True) + 1e-12)
        dot = dot / (torch.linalg.norm(dot, dim=1, keepdim=True) + 1e-12)
    else:
        s = (dist <= g).float()
        dot = torch.einsum("bnc,bmc->bnm", A, Bm)

    positive = torch.relu(cfg.positive_margin - dot)
    negative = torch.relu(dot - cfg.negative_margin)
    pairwise = cfg.lambda_d * s * positive + (1.0 - s) * negative

    if valid_mask is None:
        mask = torch.ones((B, 1, N), dtype=torch.float32, device=dot.device)
    else:
        mask = _cell_mask(valid_mask, g).reshape(B, 1, N)

    normalization = dp.batch_sum(mask.sum()) * N
    loss = cfg.lambda_loss * (mask * pairwise).sum() / normalization
    pos_summary = (mask * cfg.lambda_d * s * positive).sum() / normalization
    neg_summary = (mask * (1.0 - s) * negative).sum() / normalization
    return loss, pos_summary, neg_summary


def descriptor_loss(desc_raw, warped_desc_raw, homographies, config,
                    valid_mask=None):
    """Homography variant: the cell centres are warped by ``homographies``
    (B, 3, 3)."""
    B, Hc, Wc, _ = desc_raw.shape
    cells = cell_grid_coords(Hc, Wc, config.grid_size, device=desc_raw.device)
    warped = warp_points(cells, homographies)
    if warped.ndim == 2:
        warped = warped[None]
    return descriptor_loss_from_cells(desc_raw, warped_desc_raw, warped,
                                      config, valid_mask)


def descriptor_loss_nerf(desc_raw, warped_desc_raw, depth, intrinsics,
                         rotation_in, translation_in, rotation_warp,
                         translation_warp, config, valid_mask=None):
    """NeRF variant: the cell centres are reprojected into the warped view
    through ``depth`` and the two cameras (``warp_points_nerf``)."""
    B, Hc, Wc, _ = desc_raw.shape
    cells = cell_grid_coords(Hc, Wc, config.grid_size, device=desc_raw.device)
    warped = warp_points_nerf(cells, depth, intrinsics, rotation_in,
                              translation_in, rotation_warp, translation_warp)
    return descriptor_loss_from_cells(desc_raw, warped_desc_raw, warped,
                                      config, valid_mask)


def descriptor_loss_normalised_blockwise(desc_raw, warped_desc_raw,
                                         warped_cells,
                                         config: DescriptorLossConfig,
                                         valid_mask=None, tile: int = 400):
    """The ``normalise_descriptors=True`` loss in O(tile * N) memory.

    The same function as the dense normalise branch of
    ``descriptor_loss_from_cells`` without the (N, N) volume held for the
    backward. The row norm of relu(A_n . B^T) is local to a row tile and
    only the column norm couples rows, so two checkpointed passes over
    row tiles do:

        pass 1: c2[m] = sum_n (relu(dot) / r_n)[n, m]^2
        pass 2: hinge sums on V = (relu(dot) / r_n) / c_m

    Each pass recomputes its (tile, N) dot block;
    ``torch.utils.checkpoint`` runs it again in the backward.
    """
    cfg = config
    g = cfg.grid_size
    B, Hc, Wc, C = desc_raw.shape
    N = Hc * Wc
    radius = float(g) - 0.5

    cells = cell_grid_coords(Hc, Wc, g, device=desc_raw.device)
    A = desc_raw.reshape(B, N, C)
    Bm = warped_desc_raw.reshape(B, N, C)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    Bm = Bm / (torch.linalg.norm(Bm, dim=-1, keepdim=True) + 1e-12)
    if valid_mask is None:
        mask_m = torch.ones((B, N), dtype=torch.float32, device=A.device)
    else:
        mask_m = _cell_mask(valid_mask, g).reshape(B, N)

    def row_block(a_tile, bm):
        dot = torch.relu(a_tile @ bm.transpose(-1, -2))  # (B, tile, N)
        r = torch.linalg.norm(dot, dim=2, keepdim=True) + 1e-12
        return dot / r

    def pass1(a_tile, bm):
        u = row_block(a_tile, bm)
        return (u * u).sum(dim=1)

    def pass2(a_tile, bm, c, wc_tile):
        v = row_block(a_tile, bm) / c[:, None, :]
        d2 = ((cells[None, None, :, 0] - wc_tile[:, :, None, 0]) ** 2
              + (cells[None, None, :, 1] - wc_tile[:, :, None, 1]) ** 2)
        s = (d2 <= radius * radius).float()
        pos = cfg.lambda_d * s * torch.relu(cfg.positive_margin - v)
        neg = (1.0 - s) * torch.relu(v - cfg.negative_margin)
        w = mask_m[:, None, :]
        return torch.stack([(w * (pos + neg)).sum(), (w * pos).sum(),
                            (w * neg).sum()])

    tiles = [slice(t, min(t + tile, N)) for t in range(0, N, tile)]
    c2 = torch.zeros((B, N), dtype=torch.float32, device=A.device)
    for t in tiles:
        c2 = c2 + checkpoint(pass1, A[:, t], Bm, use_reentrant=False)
    c = torch.sqrt(c2) + 1e-12  # (B, N) column norms
    sums = torch.zeros(3, dtype=torch.float32, device=A.device)
    for t in tiles:
        sums = sums + checkpoint(pass2, A[:, t], Bm, c, warped_cells[:, t],
                                 use_reentrant=False)
    normalization = dp.batch_sum(mask_m.sum()) * N
    loss = cfg.lambda_loss * sums[0] / normalization
    return (loss, (sums[1] / normalization).detach(),
            (sums[2] / normalization).detach())
