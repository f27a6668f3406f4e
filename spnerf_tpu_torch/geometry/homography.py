"""Homography sampling and point warping (``spnerf_tpu/geometry/homography.py``).

The sampler is split in two so that its arithmetic can be held against
the reference fed with the reference's own random numbers:

- ``draw_homography_randoms``: every random number one sample needs,
  drawn from a CPU ``torch.Generator`` (truncated normals, uniforms and
  Gumbel noise for the two masked choices);
- ``homography_from_draws``: a deterministic function of those draws,
  batched over their leading dimensions.

As in the reference, perturbations are truncated normals on [-2, 2]
times their scale; scaling and rotation candidates come in fixed banks
with a safe candidate at index 0, and one valid candidate is picked by a
masked categorical choice (``argmax(gumbel + logits)``, index 0 when none
is valid); the 4-point homography is a Hartley-normalised 8 x 8 DLT
solve; and the returned matrix is the INVERSE transform, so that
``warp_image(img, H)`` (dst(p) = src(H^-1 p)) and ``warp_points(pts, H)``
(p' = H p) agree. All arithmetic is float32.

Points are (row, col) = (y, x); homographies act on (x, y, 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class HomographyConfig:
    """Sampling parameters (the reference's defaults)."""

    translation: bool = True
    rotation: bool = True
    scaling: bool = True
    perspective: bool = True
    scaling_amplitude: float = 0.1
    n_scales: int = 5
    n_angles: int = 25
    perspective_amplitude_x: float = 0.1
    perspective_amplitude_y: float = 0.1
    patch_ratio: float = 0.5
    max_angle: float = 1.57
    allow_artifacts: bool = False
    translation_overflow: float = 0.0

    @classmethod
    def from_dict(cls, d: dict | None) -> "HomographyConfig":
        d = dict(d or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _mean4(pts: torch.Tensor) -> torch.Tensor:
    """Mean of (..., 4, 2) points over the 4, summed in order, (..., 1, 2)."""
    return (((pts[..., 0:1, :] + pts[..., 1:2, :]) + pts[..., 2:3, :])
            + pts[..., 3:4, :]) / 4.0


def _normalizing_transform(pts: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation of (..., 4, 2) points: centroid to the
    origin, mean absolute coordinate to 1. Returns (..., 3, 3)."""
    center = _mean4(pts)
    scale = (pts - center).abs().mean(dim=(-2, -1)) + 1e-8
    inv_s = 1.0 / scale
    zero, one = torch.zeros_like(inv_s), torch.ones_like(inv_s)
    return torch.stack([
        torch.stack([inv_s, zero, -center[..., 0, 0] * inv_s], -1),
        torch.stack([zero, inv_s, -center[..., 0, 1] * inv_s], -1),
        torch.stack([zero, zero, one], -1)], -2)


def homography_from_corners(pts1: torch.Tensor,
                            pts2: torch.Tensor) -> torch.Tensor:
    """H with H @ [x1, y1, 1]^T ~ [x2, y2, 1]^T for (..., 4, 2) (x, y)
    corners; (..., 3, 3), normalised so that H[2, 2] = 1."""
    pts1, pts2 = torch.broadcast_tensors(pts1, pts2)
    T1, T2 = _normalizing_transform(pts1), _normalizing_transform(pts2)
    pts1 = pts1 @ T1[..., :2, :2].transpose(-1, -2) + T1[..., None, :2, 2]
    pts2 = pts2 @ T2[..., :2, :2].transpose(-1, -2) + T2[..., None, :2, 2]
    x, y = pts1[..., 0], pts1[..., 1]
    u, v = pts2[..., 0], pts2[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([ax, ay], dim=-2)  # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)  # (..., 8)
    h = torch.linalg.solve(A, b)
    H_norm = torch.cat([h, torch.ones_like(h[..., :1])], -1)
    H_norm = H_norm.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.inv(T2) @ H_norm @ T1
    return H / H[..., 2:3, 2:3]


def _truncated_normal(gen: torch.Generator, shape, bound: float = 2.0):
    """Standard normal truncated to [-bound, bound], by the inverse CDF
    (float64, returned as float32)."""
    cdf = lambda t: 0.5 * (1.0 + math.erf(t / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-bound), cdf(bound)
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return x.clamp(-bound, bound).float()


def _gumbel(gen: torch.Generator, shape):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return (-torch.log(-torch.log(u.clamp_min(1e-300)))).float()


def draw_homography_randoms(gen: torch.Generator, n: int,
                            config: HomographyConfig = HomographyConfig()):
    """Every random number ``n`` samples need, drawn from ``gen`` (a CPU
    generator): {"persp": (n, 3) truncated normals (perspective, left,
    right), "scales": (n, n_scales) truncated normals, "scale_gumbel":
    (n, n_scales + 1), "shift": (n, 2) uniforms, "angle_gumbel":
    (n, n_angles + 1)}, float32. All are drawn whatever the config
    enables, so that the stream does not depend on it."""
    cfg = config
    return {
        "persp": _truncated_normal(gen, (n, 3)),
        "scales": _truncated_normal(gen, (n, cfg.n_scales)),
        "scale_gumbel": _gumbel(gen, (n, cfg.n_scales + 1)),
        "shift": torch.rand((n, 2), generator=gen),
        "angle_gumbel": _gumbel(gen, (n, cfg.n_angles + 1)),
    }


def _masked_choice(gumbel, candidates, valid):
    """candidates[..., i, :, :] with i = argmax(gumbel + logits), logits
    0 where valid and -inf elsewhere; i = 0 when nothing is valid."""
    logits = torch.where(valid, 0.0, -torch.inf)
    first = torch.arange(valid.shape[-1]) == 0
    logits = torch.where(~valid.any(-1, keepdim=True) & first, 0.0, logits)
    idx = torch.argmax(gumbel + logits, dim=-1)
    return torch.take_along_dim(candidates, idx[..., None, None, None],
                                dim=-3).squeeze(-3)


def homography_from_draws(draws: dict, shape: tuple[int, int],
                          config: HomographyConfig = HomographyConfig()):
    """The (..., 3, 3) inverse homographies for an (H, W) image that the
    ``draws`` (see ``draw_homography_randoms``) select, float32 on the
    CPU."""
    cfg = config
    batch = draws["persp"].shape[:-1]
    margin = (1.0 - cfg.patch_ratio) / 2.0
    pr = cfg.patch_ratio
    pts1 = torch.tensor([[0.0, 0.0], [0.0, pr], [pr, pr], [pr, 0.0]],
                        dtype=torch.float32) + margin
    pts2 = pts1.expand(batch + (4, 2))

    if cfg.perspective:
        ax, ay = cfg.perspective_amplitude_x, cfg.perspective_amplitude_y
        if not cfg.allow_artifacts:
            ax, ay = min(ax, margin), min(ay, margin)
        d = draws["persp"]
        persp = d[..., 0] * (ay / 2.0)
        left, right = d[..., 1] * (ax / 2.0), d[..., 2] * (ax / 2.0)
        pts2 = pts2 + torch.stack([
            torch.stack([left, persp], -1), torch.stack([left, -persp], -1),
            torch.stack([right, persp], -1),
            torch.stack([right, -persp], -1)], -2)

    if cfg.scaling:
        scales = 1.0 + draws["scales"] * (cfg.scaling_amplitude / 2.0)
        scales = torch.cat([torch.ones(batch + (1,)), scales], -1)
        center = _mean4(pts2)[..., None, :, :]
        scaled = ((pts2[..., None, :, :] - center)
                  * scales[..., :, None, None] + center)
        if cfg.allow_artifacts:
            valid = (torch.arange(cfg.n_scales + 1) >= 1).expand(scales.shape)
        else:
            valid = ((scaled >= 0.0) & (scaled <= 1.0)).flatten(-2).all(-1)
        pts2 = _masked_choice(draws["scale_gumbel"], scaled, valid)

    if cfg.translation:
        t_min = pts2.amin(dim=-2)
        t_max = (1.0 - pts2).amin(dim=-2)
        if cfg.allow_artifacts:
            t_min = t_min + cfg.translation_overflow
            t_max = t_max + cfg.translation_overflow
        shift = -t_min + draws["shift"] * (t_max + t_min)
        pts2 = pts2 + shift[..., None, :]

    if cfg.rotation:
        angles = torch.linspace(-cfg.max_angle, cfg.max_angle, cfg.n_angles,
                                dtype=torch.float32)
        angles = torch.cat([torch.zeros(1), angles])  # safe candidate first
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
        center = _mean4(pts2)
        d = pts2 - center
        dx, dy = d[..., None, :, 0], d[..., None, :, 1]  # (..., 1, 4)
        rotated = torch.stack([dx * cos + dy * sin, dx * -sin + dy * cos],
                              -1) + center[..., None, :, :]
        if cfg.allow_artifacts:
            valid = (torch.arange(cfg.n_angles + 1) >= 1).expand(
                rotated.shape[:-2])
        else:
            valid = ((rotated >= 0.0) & (rotated <= 1.0)).flatten(-2).all(-1)
        pts2 = _masked_choice(draws["angle_gumbel"], rotated, valid)

    size_xy = torch.tensor([shape[1], shape[0]], dtype=torch.float32)
    H = homography_from_corners(pts1 * size_xy, pts2 * size_xy)
    return torch.linalg.inv(H)


def sample_homography(gen: torch.Generator, shape: tuple[int, int],
                      config: HomographyConfig = HomographyConfig()):
    """One (3, 3) inverse homography for an (H, W) image."""
    return sample_homographies(gen, 1, shape, config)[0]


def sample_homographies(gen: torch.Generator, n: int,
                        shape: tuple[int, int],
                        config: HomographyConfig = HomographyConfig()):
    """(n, 3, 3) sampled inverse homographies, float32 on the CPU."""
    return homography_from_draws(draw_homography_randoms(gen, n, config),
                                 shape, config)


def warp_points(points: torch.Tensor, homography: torch.Tensor):
    """Warp (..., N, 2) (y, x) points by (..., 3, 3) homographies."""
    pts_xy = points.flip(-1)
    homog = torch.cat([pts_xy, torch.ones_like(pts_xy[..., :1])], -1)
    warped = torch.einsum("...ij,...nj->...ni", homography, homog)
    return (warped[..., :2] / warped[..., 2:3]).flip(-1)


def adapt_homography_to_resize(H: torch.Tensor, orig_shape, new_shape):
    """S @ H @ S^-1, with S the (x, y) scaling from ``orig_shape`` to
    ``new_shape`` pixel coordinates."""
    sy = new_shape[0] / orig_shape[0]
    sx = new_shape[1] / orig_shape[1]
    S = torch.diag(torch.tensor([sx, sy, 1.0], dtype=torch.float32))
    S_inv = torch.diag(torch.tensor([1.0 / sx, 1.0 / sy, 1.0],
                                    dtype=torch.float32))
    return S @ H @ S_inv
