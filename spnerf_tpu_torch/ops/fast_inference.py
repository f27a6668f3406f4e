"""Keypoint detection from cell probabilities and descriptor sampling.

Counterpart of ``spnerf_tpu/ops/fast_inference.py``: candidates from one
top-k over the cell probabilities, a (C, C) pairwise candidate NMS with
the box-IoU topology of ``box_nms``, and bicubic descriptor sampling at
the keypoints as one product with a (K, Hc*Wc) interpolation matrix.
Every top-k cut has a defined tie order, ``topk_lowest_index``: the
highest score first, and among equal scores the lowest raster index
y * W + x (runs of equal bf16 probabilities straddle the cut). It is
exact where the reference's ``lax.approx_max_k`` has a recall target and
leaves the order of ties to its backend. ``build_inference`` is the
serving path ``bench.py`` times.
"""

from __future__ import annotations

import torch

from spnerf_tpu_torch.ops.descriptor_sampling import cubic_weights
from spnerf_tpu_torch.ops.serving import ServingSuperPoint


def detect_keypoints(prob, min_prob: float = 0.015, size: int = 4,
                     iou: float = 0.1, num_candidates: int = 2048,
                     top_k: int = 1000):
    """(B, H, W) heatmap -> (pts (B, K, 2) float32 (y, x), scores (B, K),
    valid (B, K)): the top ``num_candidates`` pixels, candidate NMS, the
    best ``top_k`` survivors."""
    B, H, W = prob.shape
    flat = prob.reshape(B, -1)
    scores, idx = topk_lowest_index(flat, min(num_candidates, H * W))
    # float32 coordinates: bf16 would round pixel indices above 256
    ys, xs = (idx // W).float(), (idx % W).float()
    return _suppress_and_select(ys, xs, scores.float(), min_prob, size, iou,
                                top_k)


def topk_lowest_index(scores, k: int, order=None):
    """``torch.topk(scores, k, dim=1)`` in a defined order: the highest
    score first and, among equal scores, the lowest ``order[i]`` (default
    i; 0 <= order < 2^32). One top-k over an int64 key: the float32
    score's bits, mapped so that signed integers sort as the floats do, in
    the high 32 bits and 2^32 - 1 - order in the low 32. Returns (scores,
    indices)."""
    bits = scores.float().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # negative floats: flip
    if order is None:
        order = torch.arange(scores.shape[1], device=scores.device)
    key = (bits.to(torch.int64) << 32) | (0xFFFFFFFF - order)
    idx = torch.topk(key, k, dim=1).indices
    return scores.gather(1, idx), idx


def _cell_candidates(flat, Wc, grid_size, num_candidates):
    """Top candidates of cell-major probabilities (B, Hc*Wc*g^2) ->
    (ys, xs, scores) float32, pixel coordinates rebuilt from (cell,
    within-cell) indices; ties go to the lowest raster index."""
    g, g2 = grid_size, grid_size * grid_size
    pos = torch.arange(flat.shape[1], device=flat.device)
    cell, within = pos // g2, pos % g2
    raster = ((cell // Wc * g + within // g) * (Wc * g)
              + cell % Wc * g + within % g)
    scores, idx = topk_lowest_index(flat, min(num_candidates, flat.shape[1]),
                                    raster)
    ys, xs = raster[idx] // (Wc * g), raster[idx] % (Wc * g)
    return ys.float(), xs.float(), scores.float()


def detect_from_logits(logits, grid_size: int = 8, min_prob: float = 0.015,
                       size: int = 4, iou: float = 0.1,
                       num_candidates: int = 1024, top_k: int = 1000):
    """Keypoints straight from (B, Hc, Wc, 65) detector logits: float32
    softmax, dustbin dropped, candidates over the cell-major
    probabilities (the depth-to-space heatmap is never built), then
    ``_suppress_and_select``. Same keypoints as ``decode_detector_logits``
    + ``detect_keypoints``."""
    B, Hc, Wc, _ = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)[..., :-1]
    ys, xs, scores = _cell_candidates(probs.reshape(B, -1), Wc, grid_size,
                                      num_candidates)
    return _suppress_and_select(ys, xs, scores, min_prob, size, iou, top_k)


def detect_from_probs_padded(probs, grid_size: int = 8,
                             min_prob: float = 0.015, size: int = 4,
                             iou: float = 0.1, num_candidates: int = 1024,
                             top_k: int = 1000, compact: bool = True):
    """Keypoints from (B, Hc, Wc, L) cell probabilities, L >= 64 (lanes
    past grid_size**2, if any, are ignored).

    Returns pts (B, K, 2) float32 (y, x), scores (B, K) and valid (B, K).
    ``compact=False`` returns all C candidates in rank order with
    suppressed / sub-threshold ones masked by ``valid``.
    """
    B, Hc, Wc, _ = probs.shape
    g2 = grid_size * grid_size
    flat = probs[..., :g2].reshape(B, -1)  # ranked in the serving dtype
    ys, xs, scores = _cell_candidates(flat, Wc, grid_size, num_candidates)
    if not compact:
        return _suppress_only(ys, xs, scores, min_prob, size, iou)
    return _suppress_and_select(ys, xs, scores, min_prob, size, iou, top_k)


def _candidate_keep(ys, xs, scores, min_prob, size, iou):
    """(B, C) keep mask: a candidate survives iff above threshold and no
    strictly higher-scored candidate overlaps it past the IoU bound."""
    cand_valid = scores >= min_prob
    dy = (ys[:, :, None] - ys[:, None, :]).abs()
    dx = (xs[:, :, None] - xs[:, None, :]).abs()
    inter = torch.clamp_min(size - dy, 0.0) * torch.clamp_min(size - dx, 0.0)
    union = 2.0 * size * size - inter
    overlap = inter / union > iou
    stronger = scores[:, None, :] > scores[:, :, None]
    suppressed = (overlap & stronger & cand_valid[:, None, :]).any(dim=-1)
    return cand_valid & ~suppressed


def _suppress_only(ys, xs, scores, min_prob, size, iou):
    keep = _candidate_keep(ys, xs, scores, min_prob, size, iou)
    pts = torch.stack([ys, xs], dim=-1)
    return pts, torch.where(keep, scores, 0.0), keep


def _suppress_and_select(ys, xs, scores, min_prob, size, iou, top_k):
    C = scores.shape[1]
    keep = _candidate_keep(ys, xs, scores, min_prob, size, iou)
    kept = torch.where(keep, scores, -torch.inf)
    # candidates come in (score, raster) order: ties go to the lower rank
    final, sel = topk_lowest_index(kept, min(top_k, C))
    pts = torch.stack([ys.gather(1, sel), xs.gather(1, sel)], dim=-1)
    valid = torch.isfinite(final) & (final >= min_prob)
    return pts, torch.where(valid, final, 0.0), valid


def _axis_weight_matrix(coord, n: int, grid_size: int):
    """(..., K) pixel coordinates -> (..., K, n) cubic interpolation
    weights with border clamping (Keys a = -0.75)."""
    src = (coord + 0.5) / grid_size - 0.5
    base = torch.floor(src)
    t = src - base
    w = cubic_weights(t)
    taps = torch.arange(-1, 3, device=coord.device)
    idx = torch.clamp(base.to(torch.int64)[..., None] + taps, 0, n - 1)
    grid = torch.arange(n, device=coord.device)
    onehot = (idx[..., None] == grid).to(w.dtype)  # (..., K, 4, n)
    return torch.einsum("...kt,...ktn->...kn", w, onehot)


def sample_descriptors_onehot(desc_raw, points, grid_size: int = 8,
                              normalize: bool = True):
    """Bicubic descriptor interpolation at keypoints as one product.

    desc_raw (B, Hc, Wc, C), points (B, K, 2) (y, x) pixels -> (B, K, C)
    float32. The y/x weights combine into a (B, K, Hc*Wc) matrix (16
    taps per row), contracted in bf16 with float32 accumulation against
    the descriptor map.
    """
    B, Hc, Wc, C = desc_raw.shape
    Wy = _axis_weight_matrix(points[..., 0], Hc, grid_size)
    Wx = _axis_weight_matrix(points[..., 1], Wc, grid_size)
    W2 = (Wy[..., :, None] * Wx[..., None, :]).reshape(B, -1, Hc * Wc)
    out = torch.bmm(W2.to(torch.bfloat16).float(),
                    desc_raw.reshape(B, Hc * Wc, C).to(torch.bfloat16).float())
    if normalize:
        out = out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)
    return out


def sample_descriptors_matmul(desc_raw, points, grid_size: int = 8,
                              normalize: bool = True):
    """Bicubic descriptor interpolation at keypoints as two separable
    products: out[k] = sum_h Wy[k, h] sum_w Wx[k, w] desc[h, w], the
    weights in the map's dtype, float32 sums. desc_raw (B, Hc, Wc, C),
    points (B, K, 2) -> (B, K, C) float32. On no serving path: a
    yardstick for the fused sampler."""
    B, Hc, Wc, C = desc_raw.shape
    K = points.shape[1]
    Wy = _axis_weight_matrix(points[..., 0], Hc, grid_size)
    Wx = _axis_weight_matrix(points[..., 1], Wc, grid_size)
    Wy, Wx = Wy.to(desc_raw.dtype).float(), Wx.to(desc_raw.dtype).float()
    tmp = torch.bmm(Wy, desc_raw.float().reshape(B, Hc, Wc * C))
    out = (Wx[..., None] * tmp.reshape(B, K, Wc, C)).sum(dim=2)
    if normalize:
        out = out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)
    return out


def build_inference(config, state, calib, *, mode: str = "int8",
                    fused_mid: bool = True, fused_tail: bool = True,
                    device="cuda", top_k: int = 1024):
    """The serving path ``bench.py`` times: ``ServingSuperPoint`` in
    ``mode`` (int8, bf16 or mixed), then, with the fused tail, the
    in-kernel softmax and candidate NMS without compaction (top_k ==
    num_candidates), or without it ``detect_from_logits`` over 1024
    candidates; then descriptor sampling at the keypoints.

    ``state``: the ``use_bn=True`` SuperPoint (or its folded dict);
    ``calib``: (N, H, W, 1) calibration images (unused in bf16 mode).
    Returns ``infer(images) -> (pts, scores, valid, desc)``;
    ``infer.serving`` is the graph.
    """
    sp = ServingSuperPoint.build(config, state, calib_images=calib, mode=mode,
                                 fused_mid=fused_mid, fused_tail=fused_tail,
                                 device=device)
    return make_infer(sp, config, top_k)


def make_infer(sp: ServingSuperPoint, config, top_k: int = 1024):
    """``infer(images) -> (pts, scores, valid, desc)`` over a built graph."""
    cfg = config

    @torch.no_grad()
    def infer(images):
        if sp.fused_tail:
            out = sp(images, softmax=True)
            # top_k == num_candidates: compaction would only permute the set
            pts, scores, valid = detect_from_probs_padded(
                out["probs"], cfg.grid_size, min_prob=cfg.det_thresh,
                size=cfg.nms, top_k=top_k, num_candidates=top_k,
                compact=False)
        else:
            out = sp(images)
            pts, scores, valid = detect_from_logits(
                out["logits"], cfg.grid_size, min_prob=cfg.det_thresh,
                size=cfg.nms, top_k=top_k, num_candidates=1024)
        desc = sample_descriptors_onehot(out["desc_raw"], pts, cfg.grid_size)
        return pts, scores, valid, desc

    infer.serving = sp
    return infer
