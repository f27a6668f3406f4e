"""Bicubic descriptor sampling at keypoints, fused.

``sample_descriptors_fused`` replaces ``spnerf_tpu/kernels/
desc_sample_pallas.py:sample_descriptors_fused`` with the CUDA kernel
``csrc/desc_sample.cu`` (see its header for the bound and the design): a
(B, Hc, Wc, C) map in bf16 or float32 read at (B, K, 2) (y, x) pixel
coordinates -> (B, K, C) float32, optionally L2-normalized. The function
is the reference's ``vmap(sample_descriptors_onehot)`` (Keys a = -0.75,
pixel p at raw coordinate (p + 0.5) / grid_size - 0.5, taps clamped to
the map) with the Pallas kernel's roundings:

- each axis's four taps are clamped to [0, n - 1], and taps that land on
  one index are summed (in tap order) before the product;
- the combined weight is bf16(float32(wy) * float32(wx)), the map is
  read as bf16, products are summed in float32;
- the normalization is out / (sqrt(sum(out^2)) + 1e-12).

``sample_descriptors_fused_plain`` is the same in PyTorch ops, summing
over (y tap, x tap) in row-major order as the kernel does; CPU tensors
take it.

The kernel has two instances, chosen by shape alone (``instance``): the
ring (bf16 maps with C % 8 == 0 whose five rows fit a block's shared
memory), one block per (image, band of base rows) streaming each row the
band reads once into a ring of five slots, the bands split by the work
of their rows; and the gather, one warp per point reading its taps from
global memory. ``base_rows``, ``band_rows``, ``ring_bytes`` and
``ring_loads`` state the ring's row bucketing, band split, shared memory
and load schedule in Python, as the kernel computes them.
"""

from __future__ import annotations

import functools

import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.ops.descriptor_sampling import cubic_weights

# the ring instance (csrc/desc_sample.cu): row slots, a row's streaming
# cost in points sampled (the band split's weight), bytes of barriers
# before the ring, and the dynamic shared memory a block may hold (H100,
# H200)
RING_SLOTS, RING_ROW_COST, RING_OFFSET, RING_SMEM_MAX = 5, 16, 128, 232448
# launch key and C launcher mode of each instance
RING, BF16_GATHER, F32_GATHER = (("desc_sample[bf16]", 0),
                                 ("desc_sample[bf16-gather]", 1),
                                 ("desc_sample[f32]", 2))


def _src_base(coord, n: int, grid_size: int):
    """The raw coordinate, its floor and the floor as an int bounded to
    [-4, n + 4] (beyond those bounds every tap clamps to one index)."""
    src = (coord.float() + 0.5) / grid_size - 0.5
    base = torch.floor(src)
    return src, base, base.clamp(-4, n + 4).to(torch.int64)


def axis_taps(coord, n: int, grid_size: int):
    """(..., K) pixel coordinates -> (idx, w, first), each a list of the
    four taps' (..., K) tensors: the clamped index, the weight with the
    later taps of the same index added in tap order, and whether the tap
    is the first of its index (the others are merged into it)."""
    src, base, b = _src_base(coord, n, grid_size)
    raw = cubic_weights(src - base).unbind(-1)
    idx = [(b + j - 1).clamp(0, n - 1) for j in range(4)]
    w, first = [], []
    for j in range(4):
        m = raw[j]
        for k in range(j + 1, 4):
            m = torch.where(idx[k] == idx[j], m + raw[k], m)
        w.append(m)
        first.append(idx[j] != idx[j - 1] if j
                     else torch.ones_like(idx[0], dtype=torch.bool))
    return idx, w, first


def _check(desc_raw, points, bands=None):
    if desc_raw.dim() != 4 or desc_raw.dtype not in (torch.bfloat16,
                                                     torch.float32):
        raise ValueError(f"sample_descriptors_fused: desc_raw "
                         f"{tuple(desc_raw.shape)} {desc_raw.dtype}, needs "
                         "(B, Hc, Wc, C) bfloat16 or float32")
    if points.dim() != 3 or points.shape[0] != desc_raw.shape[0] \
            or points.shape[2] != 2:
        raise ValueError(f"sample_descriptors_fused: points "
                         f"{tuple(points.shape)} for {desc_raw.shape[0]} maps, "
                         "needs (B, K, 2)")
    if bands is not None and not 1 <= bands <= desc_raw.shape[1]:
        raise ValueError(f"sample_descriptors_fused: bands {bands}, needs 1 "
                         f"to Hc = {desc_raw.shape[1]}")


def base_rows(coord, n: int, grid_size: int):
    """(..., K) y pixel coordinates -> the clamped base row r of each
    point, int64: its four y taps lie in rows r - 1 .. r + 2 (clamped to
    [0, n - 1]). The ring buckets points by it."""
    return _src_base(coord, n, grid_size)[2].clamp(0, n - 1)


def band_rows(counts, bands: int):
    """The bands of an image whose ``counts[r]`` points have base row r:
    for each, its base rows [r0, r1) and the rows it loads, [lo, hi] =
    [r0 - 1, r1 + 1] within the map, as a list of (r0, r1, lo, hi). A row
    weighs its points plus RING_ROW_COST; boundary b is the first row at
    which the weight before it reaches b / bands of the whole, moved so
    that every band keeps at least one row."""
    Hc = len(counts)
    start = [0]
    for c in counts:
        start.append(start[-1] + int(c))
    total = start[Hc] + RING_ROW_COST * Hc
    bounds, r = [0], 0
    for b in range(1, bands):
        while r < Hc and (start[r] + RING_ROW_COST * r) * bands < b * total:
            r += 1
        bounds.append(min(max(r, bounds[-1] + 1), Hc - bands + b))
    bounds.append(Hc)
    return [(r0, r1, max(r0 - 1, 0), min(r1 + 1, Hc - 1))
            for r0, r1 in zip(bounds, bounds[1:])]


def default_bands(B: int, Hc: int, sms: int) -> int:
    """Bands per image so that about one ring block runs on each SM, at
    most one a base row."""
    return max(1, min(Hc, sms // B))


def ring_bytes(Hc: int, Wc: int, C: int, K: int) -> int:
    """Shared memory of a ring block: the barriers and the band, five rows
    of Wc x C bf16, the bucket starts and cursors (Hc + 1 each) and the
    band's point order (at most K)."""
    return RING_OFFSET + RING_SLOTS * 2 * Wc * C + 4 * (2 * (Hc + 1) + K)


def instance(dtype, Hc: int, Wc: int, C: int, K: int):
    """(launch key, launcher mode) of the instance a shape takes: the ring
    for a bf16 map with C % 8 == 0 whose block fits in shared memory, else
    the gather."""
    if dtype == torch.float32:
        return F32_GATHER
    if C % 8 == 0 and ring_bytes(Hc, Wc, C, K) <= RING_SMEM_MAX:
        return RING
    return BF16_GATHER


def ring_loads(r0: int, r1: int, Hc: int, counts):
    """The producer's schedule for the band [r0, r1): per row y it loads,
    in order, (y, slot, the row it replaces or None, copied), where
    ``counts[r - r0]`` is the number of the band's points of base row r.
    Row y goes to slot (y - lo) % 5 once every consumer has released the
    row five before it, which each does after base row (that row) + 1; a
    row that no base row y - 2 .. y + 1 of the band holds a point of is
    not copied."""
    lo, hi = max(r0 - 1, 0), min(r1 + 1, Hc - 1)
    out = []
    for y in range(lo, hi + 1):
        readers = counts[max(y - 2, r0) - r0:min(y + 1, r1 - 1) - r0 + 1]
        out.append((y, (y - lo) % RING_SLOTS,
                    y - RING_SLOTS if y - lo >= RING_SLOTS else None,
                    sum(readers) > 0))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sample_descriptors_fused_plain(desc_raw, points, grid_size: int = 8,
                                   normalize: bool = True):
    """Plain version of ``sample_descriptors_fused``, on any device."""
    _check(desc_raw, points)
    B, Hc, Wc, C = desc_raw.shape
    K = points.shape[1]
    flat = desc_raw.reshape(B, Hc * Wc, C).to(torch.bfloat16).float()
    iy, wy, fy = axis_taps(points[..., 0], Hc, grid_size)
    ix, wx, fx = axis_taps(points[..., 1], Wc, grid_size)
    out = torch.zeros((B, K, C), dtype=torch.float32, device=desc_raw.device)
    for i in range(4):
        for j in range(4):
            w2 = (wy[i] * wx[j]).to(torch.bfloat16).float()
            idx = (iy[i] * Wc + ix[j])[..., None].expand(B, K, C)
            term = w2[..., None] * torch.gather(flat, 1, idx)
            out = out + torch.where((fy[i] & fx[j])[..., None], term, 0.0)
    if normalize:
        out = out / (torch.sqrt((out * out).sum(-1, keepdim=True)) + 1e-12)
    return out


def sample_descriptors_fused(desc_raw, points, grid_size: int = 8,
                             normalize: bool = True, bands: int | None = None):
    """Bicubic descriptors at keypoints: desc_raw (B, Hc, Wc, C) bf16 or
    float32, points (B, K, 2) (y, x) pixels -> (B, K, C) float32. CPU
    tensors take the plain version; on the card it launches the instance
    the shape takes (counted as ``desc_sample[bf16]`` for the ring,
    ``[bf16-gather]`` or ``[f32]``) or raises. ``bands`` fixes the ring's
    bands per image (1 to Hc; by default from B and the SM count); the
    gather takes none."""
    _check(desc_raw, points, bands)
    if not desc_raw.is_cuda:
        return sample_descriptors_fused_plain(desc_raw, points, grid_size,
                                              normalize)
    B, Hc, Wc, C = desc_raw.shape
    K = points.shape[1]
    key, mode = instance(desc_raw.dtype, Hc, Wc, C, K)
    if mode != RING[1] and bands is not None:
        raise ValueError(f"sample_descriptors_fused: {key} takes no bands")
    desc = desc_raw.contiguous()
    pts = points.float().contiguous()
    out = torch.empty((B, K, C), dtype=torch.float32, device=desc.device)
    if out.numel() == 0:
        return out
    _build.check_cuda("sample_descriptors_fused", desc_raw=desc, points=pts,
                      out=out)
    if bands is None:
        bands = default_bands(B, Hc, _sm_count(desc.device.index or 0))
    _build.launch("desc_sample", "desc_sample_launch", desc, pts, out, B, K,
                  Hc, Wc, C, grid_size, int(normalize), mode, bands)
    _build.launch_counts[key] += 1
    return out
