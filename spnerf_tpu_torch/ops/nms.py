"""Static-shape keypoint NMS over heatmaps (``spnerf_tpu/ops/nms.py``).

- ``box_nms``: a point survives iff it is at least the maximum over the
  offsets whose size x size boxes overlap it above ``iou`` (exact ties
  keep both). It differs from greedy NMS only on suppression chains.
- ``box_nms_greedy``: exact greedy semantics, one keep per step, for
  parity checks and offline evaluation.

Both return the NMS'd heatmap: surviving scores, zeros elsewhere.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def suppression_offsets(size: int, iou: float) -> tuple[tuple[int, int], ...]:
    """Offsets (dy, dx) != (0, 0) where two size x size boxes exceed
    ``iou``."""
    offs = []
    for dy in range(-size + 1, size):
        for dx in range(-size + 1, size):
            if dy == 0 and dx == 0:
                continue
            inter = max(0, size - abs(dy)) * max(0, size - abs(dx))
            union = 2 * size * size - inter
            if inter / union > iou:
                offs.append((dy, dx))
    return tuple(offs)


def _neighborhood_max(scores: torch.Tensor, size: int,
                     iou: float) -> torch.Tensor:
    """Max of ``scores`` at (y - dy, x - dx) over the suppression
    offsets, -inf where that lies outside the image."""
    H, W = scores.shape[-2:]
    p = size - 1
    padded = torch.nn.functional.pad(scores, (p, p, p, p),
                                     value=-torch.inf)
    out = torch.full_like(scores, -torch.inf)
    for dy, dx in suppression_offsets(size, iou):
        out = torch.maximum(
            out, padded[..., p - dy:p - dy + H, p - dx:p - dx + W])
    return out


def _keep_top_k(out, keep_top_k: int, min_prob: float):
    flat = out.reshape(out.shape[:-2] + (-1,))
    k = min(keep_top_k, flat.shape[-1])
    kth = torch.topk(flat, k, dim=-1).values[..., -1:]
    thresh = torch.clamp_min(kth, min_prob).reshape(out.shape[:-2] + (1, 1))
    return torch.where(out >= thresh, out, 0.0)


def box_nms(prob: torch.Tensor, size: int = 4, iou: float = 0.1,
            min_prob: float = 0.01, keep_top_k: int = 0) -> torch.Tensor:
    """Fast NMS over (..., H, W) heatmaps; returns the NMS'd heatmap."""
    cand = prob >= min_prob
    scores = torch.where(cand, prob, -torch.inf)
    neigh = _neighborhood_max(scores, size, iou)
    keep = cand & (scores > neigh)
    # exact ties keep both
    keep = keep | (cand & (scores == neigh) & (neigh > -torch.inf))
    out = torch.where(keep, prob, 0.0)
    if keep_top_k:
        out = _keep_top_k(out, keep_top_k, min_prob)
    return out


def box_nms_greedy(prob: torch.Tensor, size: int = 4, iou: float = 0.1,
                   min_prob: float = 0.01, keep_top_k: int = 0,
                   max_iters: int | None = None) -> torch.Tensor:
    """Exact greedy box NMS on one (H, W) heatmap (parity reference).

    Repeatedly keeps the strongest remaining candidate (the first in
    row-major order among equals) and removes it and its overlap
    footprint, for at most ``max_iters`` steps (default keep_top_k or
    H*W). Stops early once no candidate remains: later steps change
    nothing.
    """
    H, W = prob.shape
    offs = torch.tensor(suppression_offsets(size, iou),
                        dtype=torch.int64).reshape(-1, 2)
    n_iters = max_iters or (keep_top_k if keep_top_k else H * W)
    alive = prob >= min_prob
    kept = torch.zeros((H, W), dtype=torch.bool, device=prob.device)
    for _ in range(n_iters):
        if not bool(alive.any()):
            break
        masked = torch.where(alive, prob, -torch.inf)
        idx = int(torch.argmax(masked))
        y, x = divmod(idx, W)
        kept[y, x] = True  # every alive score is >= min_prob
        alive[y, x] = False
        ys, xs = y + offs[:, 0], x + offs[:, 1]
        inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        alive[ys[inside], xs[inside]] = False
    out = torch.where(kept, prob, 0.0)
    if keep_top_k:
        out = _keep_top_k(out, keep_top_k, min_prob)
    return out
