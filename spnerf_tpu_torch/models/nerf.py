"""In-framework NeRF (``spnerf_tpu/models/nerf.py``): positional encoding,
the classic 8 x 256 MLP pair, hierarchical sampling and volume rendering
with along-ray depth.

The arithmetic follows the reference's own: the encoding is the product
``x @ E`` with the selection-and-scale matrix, cos is ``sin(v + pi/2)``,
and ray points are encoded as ``o@E + (d@E) * t`` (never ``o + t d``);
every float32 product runs without TF32 (TF32 would round ``x`` to 10
mantissa bits before the x 2^9 scale). Where the reference writes
``a + b * c`` on float32 tensors, XLA contracts it into one FMA; the port
writes ``torch.addcmul`` (or ``add`` with ``alpha``), which rounds once
too. With ``compute_dtype="bfloat16"`` each Dense runs as flax runs it:
input, kernel and bias rounded to bf16, the dot (float32 sums) rounded
to bf16, then the bf16 bias added; sigma and rgb come back in float32.

Randomness: torch cannot reproduce ``jax.random``. Every function that
draws takes a ``torch.Generator`` or the draws themselves (``u``,
``draws``), so that tests can feed it the reference's draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.fused_tiny_nerf import _matmul_f32


def _matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 with float32 sums, forward and backward (flax's
    bf16 Dense): cuBLAS with reduced-precision reductions off, oneDNN on
    the CPU."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved


def _expand_matrix(D: int, F: int, include_input: bool = True) -> np.ndarray:
    """(D, [D +] D*F) selection-and-scale matrix: x @ E = [x, 2^k x_d...]."""
    freqs = 2.0 ** np.arange(F, dtype=np.float32)
    expand = np.zeros((D, D * F), np.float32)
    for d in range(D):
        expand[d, d * F : (d + 1) * F] = freqs
    if include_input:
        expand = np.concatenate([np.eye(D, dtype=np.float32), expand], axis=1)
    return expand


def _expand_on(D: int, F: int, like: torch.Tensor,
               include_input: bool = True) -> torch.Tensor:
    return torch.as_tensor(_expand_matrix(D, F, include_input),
                           device=like.device)


def _finish_encoding(xf: torch.Tensor, d_input: int) -> torch.Tensor:
    """[x, 2^k x_d...] -> [x, sin(2^k x_d), cos(2^k x_d)], cos as
    sin(v + pi/2)."""
    raw, freqpart = xf[..., :d_input], xf[..., d_input:]
    phases = torch.cat([freqpart, freqpart + math.pi / 2], dim=-1)
    return torch.cat([raw, torch.sin(phases)], dim=-1)


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """gamma(x): [x, sin(2^k x), cos(2^k x)] for k in [0, num_freqs), as
    one product with the expansion matrix and one sin."""
    D = x.shape[-1]
    xf = _matmul_f32(x, _expand_on(D, num_freqs, x, include_input))
    return _finish_encoding(xf, D if include_input else 0)


def ray_point_arguments(origins, directions, t_vals, num_freqs: int):
    """The encoding's arguments of o + t d before the sines: o@E + (d@E) * t
    with one rounding (the reference's fused multiply-add).
    origins/directions (N, 3), t_vals (N, S) -> (N, S, 3 + 3 num_freqs)."""
    E = _expand_on(3, num_freqs, origins)
    oE = _matmul_f32(origins, E)
    dE = _matmul_f32(directions, E)
    return torch.addcmul(oE[:, None, :], dE[:, None, :], t_vals[..., None])


def encode_ray_points(origins, directions, t_vals, num_freqs: int):
    """Positional encoding of o + t d without materializing (N, S, 3):
    (N, S, 3 + 6 num_freqs)."""
    return _finish_encoding(
        ray_point_arguments(origins, directions, t_vals, num_freqs), 3)


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    depth: int = 8
    width: int = 256
    skip_layer: int = 4
    pos_freqs: int = 10
    dir_freqs: int = 4
    n_coarse: int = 64
    n_fine: int = 128
    near: float = 2.0
    far: float = 6.0
    white_background: bool = False
    # the Dense layers' compute dtype: "float32" or "bfloat16" (parameters
    # and compositing stay float32)
    compute_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype)`` on ``layer``'s float32 parameters:
    the dot, then the bias added (two roundings)."""
    if dtype == torch.float32:
        return _matmul_f32(x, layer.weight.T) + layer.bias
    w = layer.weight.to(torch.bfloat16)
    return (_matmul_bf16(x.to(torch.bfloat16), w.T)
            + layer.bias.to(torch.bfloat16))


class NeRFMLP(nn.Module):
    """Classic NeRF MLP on encoded inputs: ``depth`` ReLU layers with the
    position encoding concatenated after layer ``skip_layer``, a density
    head, and a view-dependent RGB branch."""

    def __init__(self, config: NeRFConfig = NeRFConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"NeRFMLP: compute_dtype {cfg.compute_dtype!r}")
        pos_dim = 3 + 6 * cfg.pos_freqs
        dir_dim = 3 + 6 * cfg.dir_freqs
        layers, fan_in = [], pos_dim
        for i in range(cfg.depth):
            layers.append(nn.Linear(fan_in, cfg.width))
            fan_in = cfg.width + (pos_dim if i + 1 == cfg.skip_layer else 0)
        self.layers = nn.ModuleList(layers)
        self.sigma = nn.Linear(fan_in, 1)
        self.feature = nn.Linear(fan_in, cfg.width)
        self.view1 = nn.Linear(cfg.width + dir_dim, cfg.width // 2)
        self.rgb = nn.Linear(cfg.width // 2, 3)

    def forward(self, pos_enc: torch.Tensor, dir_enc: torch.Tensor):
        cfg = self.config
        dt = _DTYPES[cfg.compute_dtype]
        x = pos_enc
        for i, layer in enumerate(self.layers):
            x = torch.relu(_dense(x, layer, dt))
            if i + 1 == cfg.skip_layer:
                x = torch.cat([x, pos_enc.to(x.dtype)], dim=-1)
        sigma = _dense(x, self.sigma, dt)[..., 0]
        feat = _dense(x, self.feature, dt)
        h = torch.cat([feat, dir_enc.to(feat.dtype)], dim=-1)
        h = torch.relu(_dense(h, self.view1, dt))
        rgb = torch.sigmoid(_dense(h, self.rgb, dt))
        # composite in float32: the alpha / cumprod chain is sensitive
        return sigma.float(), rgb.float()


class NeRF(nn.Module):
    """Coarse + fine field pair (hierarchical NeRF)."""

    def __init__(self, config: NeRFConfig = NeRFConfig()):
        super().__init__()
        self.config = config
        self.coarse = NeRFMLP(config)
        self.fine = NeRFMLP(config)

    def _mlp(self, level: str) -> NeRFMLP:
        return self.coarse if level == "coarse" else self.fine

    def query(self, level: str, positions, directions):
        """Densities and colours at (..., 3) positions; ``directions``
        per point, or per ray (one fewer dimension) and broadcast over
        the samples."""
        cfg = self.config
        batch_shape = positions.shape[:-1]
        pos_enc = positional_encoding(positions.reshape(-1, 3), cfg.pos_freqs)
        dir_enc = positional_encoding(directions, cfg.dir_freqs)
        if dir_enc.dim() == positions.dim() - 1:
            dir_enc = dir_enc[..., None, :].expand(
                batch_shape + (dir_enc.shape[-1],))
        dir_enc = dir_enc.reshape(-1, dir_enc.shape[-1])
        sigma, rgb = self._mlp(level)(pos_enc, dir_enc)
        return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)

    def encoded(self, pos_enc, dir_enc, level: str = "coarse"):
        """Query with precomputed encodings (see ``encode_ray_points``)."""
        batch = pos_enc.shape[:-1]
        sigma, rgb = self._mlp(level)(
            pos_enc.reshape(-1, pos_enc.shape[-1]),
            dir_enc.reshape(-1, dir_enc.shape[-1]))
        return sigma.reshape(batch), rgb.reshape(*batch, 3)

    def forward(self, positions, directions, level: str = "coarse"):
        return self.query(level, positions, directions)


# ------------------------------------------------------------------ rendering


def render_weights(sigma: torch.Tensor, t_vals: torch.Tensor) -> torch.Tensor:
    """Alpha-composite weights from densities. sigma, t_vals (..., S):
    sample distances along unit rays; the last interval is 1e10."""
    deltas = torch.diff(t_vals, dim=-1)
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)],
                       dim=-1)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans


def composite(weights: torch.Tensor, rgb: torch.Tensor, t_vals: torch.Tensor,
              white_background: bool = False):
    """weights (..., S), rgb (..., S, 3), t_vals (..., S) -> (rgb (..., 3),
    depth (...), acc (...)); depth is the weighted mean sample distance,
    along-ray for unit directions."""
    acc = weights.sum(-1)
    color = (weights[..., None] * rgb).sum(-2)
    depth = (weights * t_vals).sum(-1)
    if white_background:
        color = color + (1.0 - acc[..., None])
    return color, depth, acc


def _uniform(shape, u, generator, device) -> torch.Tensor:
    if u is not None:
        return torch.as_tensor(u, device=device)
    return torch.rand(shape, generator=generator, device=device)


def stratified_samples(n_samples: int, near: float, far: float, shape,
                       u=None, generator: torch.Generator | None = None,
                       device=None) -> torch.Tensor:
    """Jittered uniform samples in [near, far], shape + (n_samples,): bin
    i's lower edge i / n plus its width times ``u`` (drawn from
    ``generator`` unless given)."""
    bins = torch.arange(n_samples + 1, dtype=torch.float32,
                        device=device) / n_samples
    lower, upper = bins[:-1], bins[1:]
    u = _uniform(tuple(shape) + (n_samples,), u, generator, device)
    t = torch.addcmul(lower, upper - lower, u)
    return torch.add(torch.tensor(near, device=device), t, alpha=far - near)


def pdf_cdf(weights: torch.Tensor) -> torch.Tensor:
    """(..., B) weights -> (..., B + 1) cdf of the normalized weights
    (plus 1e-5 each), starting at 0."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u=None, generator: torch.Generator | None = None):
    """Inverse-CDF sampling of the coarse weights (hierarchical NeRF).
    bins (..., B + 1) edges; weights (..., B). The bin of each draw is the
    count of cdf entries <= u (the reference's comparison count, a
    right-sided search on the nondecreasing cdf)."""
    cdf = pdf_cdf(weights)
    u = _uniform(cdf.shape[:-1] + (n_samples,), u, generator, cdf.device)
    nb = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, nb - 1)
    above = torch.clamp(idx, 0, nb - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    if bins.shape[-1] < nb:
        bins = torch.cat([bins, bins[..., -1:].expand(
            bins.shape[:-1] + (nb - bins.shape[-1],))], dim=-1)
    else:
        bins = bins[..., :nb]
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-8, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return torch.addcmul(bins_b, t, bins_a - bins_b)


def draw_ray_uniforms(n_rays: int, config: NeRFConfig,
                      generator: torch.Generator, device):
    """The draws of one ``render_rays`` call: (u_coarse (n, n_coarse),
    u_fine (n, n_fine)), in that order from ``generator``."""
    return (torch.rand((n_rays, config.n_coarse), generator=generator,
                       device=device),
            torch.rand((n_rays, config.n_fine), generator=generator,
                       device=device))


def render_rays(model: NeRF, origins: torch.Tensor, directions: torch.Tensor,
                config: NeRFConfig, generator: torch.Generator | None = None,
                draws=None) -> dict:
    """Hierarchical render of (N, 3) rays -> {"rgb_coarse", "depth_coarse",
    "acc_coarse", "rgb", "depth", "acc"}. ``directions`` must be unit
    length, so that depth is the along-ray distance. ``draws`` = (u_coarse,
    u_fine), else drawn from ``generator``."""
    n_rays = origins.shape[0]
    if draws is None:
        draws = draw_ray_uniforms(n_rays, config, generator, origins.device)
    u_coarse, u_fine = draws
    t_coarse = stratified_samples(config.n_coarse, config.near, config.far,
                                  (n_rays,), u=u_coarse, device=origins.device)
    # directions encoded once per ray, broadcast over the samples
    dir_enc = positional_encoding(directions, config.dir_freqs)

    def run(level, t_vals):
        pos_enc = encode_ray_points(origins, directions, t_vals,
                                    config.pos_freqs)
        d = dir_enc[:, None, :].expand(pos_enc.shape[:-1]
                                       + (dir_enc.shape[-1],))
        return model.encoded(pos_enc, d, level)

    sigma_c, rgb_c = run("coarse", t_coarse)
    w_c = render_weights(sigma_c, t_coarse)
    color_c, depth_c, acc_c = composite(w_c, rgb_c, t_coarse,
                                        config.white_background)

    # hierarchical: resample around the coarse distribution
    mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    edges = torch.cat([t_coarse[..., :1], mids, t_coarse[..., -1:]], dim=-1)
    t_fine = sample_pdf(edges, w_c, config.n_fine, u=u_fine)
    t_all = torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values

    sigma_f, rgb_f = run("fine", t_all)
    w_f = render_weights(sigma_f, t_all)
    color_f, depth_f, acc_f = composite(w_f, rgb_f, t_all,
                                        config.white_background)
    return {"rgb_coarse": color_c, "depth_coarse": depth_c,
            "acc_coarse": acc_c, "rgb": color_f, "depth": depth_f,
            "acc": acc_f}


def camera_rays(shape, intrinsics: torch.Tensor, cam_to_world: torch.Tensor):
    """Unit-length rays for every pixel of an (H, W) image.

    OpenCV camera convention (x right, y down, z forward); cam_to_world
    is (4, 4). Returns (origins (H*W, 3), directions (H*W, 3) unit length),
    float32 on the device of ``intrinsics``; K inverted in float32, as
    the reference does."""
    H, W = shape
    dev = intrinsics.device
    K = intrinsics.float()
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(H * W, device=dev)], dim=-1)
    K_inv = torch.linalg.inv(K)
    dirs_cam = _matmul_f32(pix, K_inv.T)
    R = cam_to_world[:3, :3].float().to(dev)
    t = cam_to_world[:3, 3].float().to(dev)
    dirs = _matmul_f32(dirs_cam, R.T)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return t.expand_as(dirs), dirs


@torch.no_grad()
def render_image(model: NeRF, shape: tuple[int, int], intrinsics,
                 cam_to_world, config: NeRFConfig, chunk: int = 4096,
                 generator: torch.Generator | None = None, draws=None,
                 device="cuda") -> dict:
    """Render every pixel of an (H, W) view in chunks of ``chunk`` rays
    (the last padded), on the card unless ``device="cpu"``. Returns
    {"rgb" (H, W, 3), "depth" (H, W) along-ray, "acc" (H, W)} on the
    device. ``draws``: one (u_coarse, u_fine) per chunk, else each chunk
    draws from ``generator`` (default: seeded 0)."""
    device = resolve_device(device)
    model = model.to(device)
    if draws is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    H, W = shape
    origins, dirs = camera_rays(
        shape, torch.as_tensor(intrinsics, device=device),
        torch.as_tensor(cam_to_world, device=device))
    n = H * W
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    origins = torch.nn.functional.pad(origins, (0, 0, 0, pad))
    dirs = torch.nn.functional.pad(dirs, (0, 0, 0, pad), value=1.0)
    outs = []
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        out = render_rays(model, origins[rows], dirs[rows], config,
                          generator=generator,
                          draws=None if draws is None else draws[c])
        outs.append((out["rgb"], out["depth"], out["acc"]))
    rgb, depth, acc = (torch.cat(parts)[:n] for parts in zip(*outs))
    return {"rgb": rgb.reshape(H, W, 3), "depth": depth.reshape(H, W),
            "acc": acc.reshape(H, W)}


@torch.no_grad()
def init_dense_(module: nn.Module, generator: torch.Generator) -> None:
    """Every ``nn.Linear`` of ``module`` as flax initializes a Dense, in
    module order: the kernel a normal truncated at two deviations and
    scaled to variance 1 / fan_in (LeCun), the bias zero."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = math.sqrt(1.0 / layer.weight.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            layer.bias.zero_()


def init_nerf(seed: int = 0, config: NeRFConfig = NeRFConfig(),
              device="cuda") -> NeRF:
    """A NeRF with flax's initialization drawn from a CPU generator seeded
    ``seed`` (not the numbers ``jax.random`` gives the reference), on the
    card unless ``device="cpu"``."""
    device = resolve_device(device)
    model = NeRF(config)
    init_dense_(model, torch.Generator().manual_seed(int(seed)))
    return model.to(device)
