"""Occupancy grid + per-(ray-block, sample-chunk) skip flags for the
fused NeRF renderer (``spnerf_tpu/ops/occupancy.py``).

Every sample of the fused render costs three matrix products whether or
not it lands in empty space. A coarse occupancy grid of the trained field
is reduced per ray block x sample chunk to an int32 flag; the kernel then
skips encoding + MLP + compositing for dead chunks, which leaves the
compositing state unchanged.

Probe construction (sigma in the tiny field is view-dependent: df is
added before layer 2, models/fused_tiny_nerf.py):

  - ``method="sampled"`` (default): sigma probed at 2x grid resolution
    as the MAX over a Fibonacci-sphere set of view directions, scaled
    by a safety ``margin`` (sigma domain), then max-pooled and dilated
    by one voxel. An approximation, not a proof: a direction between the
    probes could exceed the max.
  - ``method="bound"``: the provable direction-robust bound. Since
    df = sin(d@A+c) @ wd and |sin| <= 1, each feature satisfies
    |df_j| <= sum_i |wd[i,j]| =: m_j, so h2_j = relu(z_j + df_j) lies in
    [relu(z_j - m_j), relu(z_j + m_j)] and sigma = h2 @ w3[:,0] is
    maximised endpoint-wise. Conservative for any field, and loose.

Flags are per (ray-block, sample-chunk): each RAY's chunk segment gets
the axis box of its two endpoints, queried against the grid via a 3-D
integral image; the block's flag is the OR over its rays. Boxes leaving
the grid extent count as occupied (the sin-encoded field is periodic,
so nothing can be asserted outside the probed extent).
"""

from __future__ import annotations

import numpy as np
import torch

from spnerf_tpu_torch.models.fused_tiny_nerf import (
    TinyFieldConfig,
    _matmul_f32,
    direction_features,
    make_encoding,
)

_PLANES = 8  # planes of the 2x grid probed in one batch


def fibonacci_sphere(n: int, device="cpu") -> torch.Tensor:
    """(n, 3) well-spread unit directions (golden-angle spiral)."""
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    phi = torch.arccos(1.0 - 2.0 * i / n)
    theta = float(np.float32(np.pi * (1.0 + np.sqrt(5.0)))) * i
    return torch.stack([
        torch.sin(phi) * torch.cos(theta),
        torch.sin(phi) * torch.sin(theta),
        torch.cos(phi),
    ], dim=-1)


@torch.no_grad()
def field_sigma_grid(params, config: TinyFieldConfig, resolution: int = 96,
                     extent: float | None = None, method: str = "sampled",
                     n_dirs: int = 32, margin: float = 2.0) -> torch.Tensor:
    """Upper estimate of the raw density of the tiny fused field on a
    (res, res, res) grid over [-extent, extent]^3 (cell centers, 2x
    supersampled + max-pooled), on the parameters' device.

    sigma is view-dependent (df added before layer 2). ``method``:

    - "sampled": max over ``n_dirs`` Fibonacci-sphere directions, times
      ``margin`` (see the module docstring).
    - "bound": provable max over ALL directions via
      |df_j| <= sum_i |wd[i,j]|.
    """
    ext = float(extent if extent is not None else config.far)
    dev = params["w1"].device
    A, c = (torch.as_tensor(t, device=dev) for t in make_encoding(config))
    w1, w2, w3, wd = (params[k].float() for k in ("w1", "w2", "w3", "wd"))
    r2 = resolution * 2
    xs = (torch.arange(r2, device=dev) + 0.5) / r2 * (2 * ext) - ext
    w3_sigma = w3[:, 0]

    if method == "bound":
        dmax = wd.abs().sum(dim=0)  # (W,): |df_j| bound
        pos = torch.clamp_min(w3_sigma, 0.0)
        neg = torch.clamp_max(w3_sigma, 0.0)

        def head(z):
            hi = torch.relu(z + dmax)  # upper end of h2 over directions
            lo = torch.relu(z - dmax)  # lower end
            return _matmul_f32(hi, pos[:, None])[:, 0] \
                + _matmul_f32(lo, neg[:, None])[:, 0]
    elif method == "sampled":
        dfs = direction_features(params, fibonacci_sphere(n_dirs, dev), A, c)

        def head(z):
            sig = torch.full((z.shape[0],), -torch.inf, device=dev)
            for df in dfs:
                sig = torch.maximum(
                    sig, _matmul_f32(torch.relu(z + df), w3_sigma[:, None])[:, 0])
            # inflate only the positive part: occupancy thresholds are
            # positive, and scaling negative raw densities would SHRINK
            # the probe exactly where caution is needed
            return torch.where(sig > 0, margin * sig, sig)
    else:
        raise ValueError(f"unknown occupancy probe method: {method!r}")

    yy, zz = torch.meshgrid(xs, xs, indexing="ij")
    planes = []
    for x0 in range(0, r2, _PLANES):
        x = xs[x0:x0 + _PLANES]
        pts = torch.stack([x[:, None, None].expand(-1, r2, r2),
                           yy.expand(len(x), -1, -1),
                           zz.expand(len(x), -1, -1)], -1).reshape(-1, 3)
        enc = torch.sin(_matmul_f32(pts, A) + c)
        h = torch.relu(_matmul_f32(enc, w1))
        planes.append(head(_matmul_f32(h, w2)).reshape(len(x), r2, r2))
    sig = torch.cat(planes)  # (r2, r2, r2)
    # 2x2x2 max-pool back to resolution
    sig = sig.reshape(resolution, 2, resolution, 2, resolution, 2)
    return sig.amax(dim=(1, 3, 5))


def occupancy_grid(sigma_grid: torch.Tensor, dt: float,
                   alpha_thresh: float = 1e-3) -> torch.Tensor:
    """bool (res, res, res): cells whose density contributes more than
    ``alpha_thresh`` alpha over one sample step, dilated by one voxel
    (cyclically, as the reference's rolls do)."""
    sigma_thresh = -np.log(1.0 - alpha_thresh) / dt
    occ = sigma_grid > sigma_thresh
    # 3^3 dilation as three axis-wise max-pools
    for axis in range(3):
        occ = occ | torch.roll(occ, 1, axis) | torch.roll(occ, -1, axis)
    return occ


def integral_volume(occ: torch.Tensor) -> torch.Tensor:
    """(res+1,)^3 int32 3-D summed-area table of the bool grid."""
    s = occ.to(torch.int32)
    for axis in range(3):
        s = torch.cumsum(s, dim=axis, dtype=torch.int32)
    return torch.nn.functional.pad(s, (1, 0, 1, 0, 1, 0))


def _box_count(ivol, lo, hi):
    """Occupied-voxel count in [lo, hi] (inclusive voxel ranges, (..., 3)
    integer tensors): the 8 corners of the summed-area table."""
    h = hi + 1
    x0, y0, z0 = lo[..., 0], lo[..., 1], lo[..., 2]
    x1, y1, z1 = h[..., 0], h[..., 1], h[..., 2]
    return (ivol[x1, y1, z1] - ivol[x0, y1, z1] - ivol[x1, y0, z1]
            - ivol[x1, y1, z0] + ivol[x0, y0, z1] + ivol[x0, y1, z0]
            + ivol[x1, y0, z0] - ivol[x0, y0, z0])


@torch.no_grad()
def chunk_flags(origins: torch.Tensor, directions: torch.Tensor,
                ivol: torch.Tensor, *, block: int, n_samples: int,
                s_chunk: int, near: float, far: float,
                extent: float) -> torch.Tensor:
    """int32 (n_blocks, n_chunks) skip flags for ``render_fused``.

    Rays are grouped as the renderer's flags group them (consecutive rows
    of ``block`` rays, padded by repeating the last ray). Each RAY tests
    its own thin segment-endpoint box against the grid; the block flag is
    the OR over its rays: one fat box over a whole camera-fan block would
    sweep most of the scene and skip nothing."""
    N = origins.shape[0]
    pad = (-N) % block
    o = torch.cat([origins, origins[-1:].expand(pad, -1)])
    d = torch.cat([directions, directions[-1:].expand(pad, -1)])
    nb = (N + pad) // block
    nc = n_samples // s_chunk
    o = o.reshape(nb, block, 3)
    d = d.reshape(nb, block, 3)
    # chunk boundary distances (nc+1,)
    ts = near + torch.arange(nc + 1, device=o.device) * ((far - near) / nc)
    pts = o[:, None] + ts[None, :, None, None] * d[:, None]  # (nb,nc+1,B,3)
    blo = torch.minimum(pts[:, :-1], pts[:, 1:])  # (nb, nc, B, 3) per ray
    bhi = torch.maximum(pts[:, :-1], pts[:, 1:])
    res = ivol.shape[0] - 1
    scale = res / (2.0 * extent)
    vlo = torch.clamp(torch.floor((blo + extent) * scale), 0, res - 1).long()
    vhi = torch.clamp(torch.floor((bhi + extent) * scale), 0, res - 1).long()
    outside = ((blo < -extent) | (bhi > extent)).any(dim=-1)
    count = _box_count(ivol, vlo, vhi)  # (nb, nc, B)
    live = (count > 0) | outside
    return live.any(dim=-1).to(torch.int32)


def build_render_flags(params, origins, directions,
                       config: TinyFieldConfig, *, block: int,
                       s_chunk: int, resolution: int = 96,
                       extent: float | None = None):
    """One-stop: sigma grid -> occupancy -> integral -> per-render flags.
    The grid and the integral depend only on the field; keep ``ivol``
    across renders of the same field via ``field_integral_volume``."""
    ivol = field_integral_volume(params, config, resolution, extent)
    ext = float(extent if extent is not None else config.far)
    return chunk_flags(origins, directions, ivol, block=block,
                       n_samples=config.n_samples, s_chunk=s_chunk,
                       near=config.near, far=config.far, extent=ext)


def field_integral_volume(params, config: TinyFieldConfig,
                          resolution: int = 96,
                          extent: float | None = None) -> torch.Tensor:
    dt = (config.far - config.near) / config.n_samples
    sig = field_sigma_grid(params, config, resolution, extent)
    return integral_volume(occupancy_grid(sig, dt))
