"""Instant-NGP-style hash-grid NeRF (``spnerf_tpu/models/hash_nerf.py``):
a multiresolution hash encoding plus a tiny MLP, rendered in one
stratified pass.

The spatial hash multiplies in uint32 with wrap-around. torch has no
general uint32 arithmetic, so it runs in int64: each product of a corner
(at most max_resolution + 1) and a prime (below 2^32) is exact there,
masked to its low 32 bits, XORed, and reduced modulo the table size (a
power of two), which is what the reference's uint32 product gives. The
per-level resolutions and the dense-or-hash test are the reference's
float64 numpy. The table gather is ``index_select``; its backward adds
with atomics on the card, so the table's gradient is not bit-stable
there from run to run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.nerf import (
    _dense,
    composite,
    init_dense_,
    positional_encoding,
    render_weights,
    stratified_samples,
)

# large primes for spatial hashing (Instant-NGP's choice)
_PRIMES = (1, 2654435761, 805459861)
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashNeRFConfig:
    n_levels: int = 12
    features_per_level: int = 2
    log2_table_size: int = 17
    base_resolution: int = 16
    max_resolution: int = 1024
    mlp_width: int = 64
    geo_features: int = 15
    dir_freqs: int = 2
    n_samples: int = 48
    near: float = 2.0
    far: float = 6.0
    # scene bound: positions are normalized from [-bound, bound] to [0, 1]
    bound: float = 4.0


def level_resolutions(config: HashNeRFConfig) -> list[int]:
    """Grid resolution of every level (float64 numpy, floored)."""
    L = config.n_levels
    growth = np.exp((np.log(config.max_resolution)
                     - np.log(config.base_resolution)) / max(L - 1, 1))
    return [int(np.floor(config.base_resolution * growth**lvl))
            for lvl in range(L)]


def corner_offsets(corner: int) -> tuple[int, int, int]:
    return (corner >> 0) & 1, (corner >> 1) & 1, (corner >> 2) & 1


def corner_index(c: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """(N, 3) int64 corner coordinates of a level of resolution ``res`` ->
    (N,) table rows: dense when the level's (res + 1)^3 corners fit the
    table, else the spatial hash."""
    if (res + 1) ** 3 <= table_size:
        idx = (c[:, 0] * (res + 1) + c[:, 1]) * (res + 1) + c[:, 2]
        return torch.remainder(idx, table_size)
    idx = ((c[:, 0] * _PRIMES[0]) & _LOW32) \
        ^ ((c[:, 1] * _PRIMES[1]) & _LOW32) \
        ^ ((c[:, 2] * _PRIMES[2]) & _LOW32)
    return torch.remainder(idx, table_size)


class HashGridEncoding(nn.Module):
    """Multiresolution hash encoding: (N, 3) in [0, 1] -> (N, L * F)."""

    def __init__(self, config: HashNeRFConfig):
        super().__init__()
        self.config = config
        self.table = nn.Parameter(torch.zeros(
            config.n_levels, 1 << config.log2_table_size,
            config.features_per_level))

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        T = 1 << self.config.log2_table_size
        outs = []
        for lvl, res in enumerate(level_resolutions(self.config)):
            pos = x01 * res
            floor = torch.floor(pos)
            base = floor.long()
            frac = pos - floor
            table = self.table[lvl]
            feats = torch.zeros(x01.shape[0], table.shape[-1],
                                device=x01.device)
            for corner in range(8):
                off = corner_offsets(corner)
                c = base + torch.tensor(off, device=x01.device)
                idx = corner_index(c, res, T)
                sel = [frac[:, k] if off[k] else 1.0 - frac[:, k]
                       for k in range(3)]
                w = sel[0] * sel[1] * sel[2]
                feats = torch.addcmul(feats, w[:, None],
                                      table.index_select(0, idx))
            outs.append(feats)
        return torch.cat(outs, dim=-1)


class HashNeRF(nn.Module):
    """Hash encoding + tiny sigma / colour MLPs (float32)."""

    def __init__(self, config: HashNeRFConfig = HashNeRFConfig()):
        super().__init__()
        cfg = self.config = config
        enc = cfg.n_levels * cfg.features_per_level
        self.grid = HashGridEncoding(cfg)
        self.sigma1 = nn.Linear(enc, cfg.mlp_width)
        self.sigma2 = nn.Linear(cfg.mlp_width, 1 + cfg.geo_features)
        self.color1 = nn.Linear(cfg.geo_features + 3 + 6 * cfg.dir_freqs,
                                cfg.mlp_width)
        self.color2 = nn.Linear(cfg.mlp_width, 3)

    def forward(self, positions: torch.Tensor, directions: torch.Tensor):
        """positions (..., 3) world coordinates, directions (..., 3) unit,
        per point or per ray. Returns (sigma (...,), rgb (..., 3))."""
        cfg = self.config
        batch_shape = positions.shape[:-1]
        x = positions.reshape(-1, 3)
        x01 = torch.clamp((x + cfg.bound) / (2 * cfg.bound), 0.0, 1.0)
        f32 = torch.float32
        h = torch.relu(_dense(self.grid(x01), self.sigma1, f32))
        h = _dense(h, self.sigma2, f32)
        sigma, geo = h[..., 0], h[..., 1:]
        if directions.dim() == positions.dim():
            d = directions.reshape(-1, 3)
        else:
            d = directions[..., None, :].expand(positions.shape).reshape(-1, 3)
        c = torch.cat([geo, positional_encoding(d, cfg.dir_freqs)], dim=-1)
        c = torch.relu(_dense(c, self.color1, f32))
        rgb = torch.sigmoid(_dense(c, self.color2, f32))
        return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)


def render_rays_hash(model: HashNeRF, origins: torch.Tensor,
                     directions: torch.Tensor, config: HashNeRFConfig,
                     generator: torch.Generator | None = None,
                     u=None) -> dict:
    """Single-pass stratified render of (N, 3) unit rays -> {"rgb",
    "depth", "acc"}, depth along the ray. ``u`` (N, n_samples): the
    stratified draws, else drawn from ``generator``."""
    n_rays = origins.shape[0]
    t = stratified_samples(config.n_samples, config.near, config.far,
                           (n_rays,), u=u, generator=generator,
                           device=origins.device)
    pos = torch.addcmul(origins[:, None, :], directions[:, None, :],
                        t[..., None])
    sigma, rgb = model(pos, directions)
    w = render_weights(sigma, t)
    color, depth, acc = composite(w, rgb, t)
    return {"rgb": color, "depth": depth, "acc": acc}


@torch.no_grad()
def init_hash_nerf(seed: int = 0, config: HashNeRFConfig = HashNeRFConfig(),
                   device="cuda") -> HashNeRF:
    """A HashNeRF initialized as the reference's flax module is (table
    uniform in [-1e-4, 1e-4), Dense layers truncated LeCun normal with zero
    biases), drawn from a CPU generator seeded ``seed``; on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    model = HashNeRF(config)
    gen = torch.Generator().manual_seed(int(seed))
    model.grid.table.uniform_(-1e-4, 1e-4, generator=gen)
    init_dense_(model, gen)
    return model.to(device)
