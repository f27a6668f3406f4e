"""Tiny fused-renderable NeRF field (Lambertian, width 128, 64 or 32).

The field family served by ``kernels/render.render_fused``: a
Fourier-feature encoding folded into a single affine map (3 -> W, with a
constant-one bias lane), two W-wide ReLU layers and a head whose column 0
is raw density and columns 1..3 are RGB logits. View dependence enters as a
per-ray direction feature vector (sin(d @ A + c) @ wd) added before the
second layer.

Counterpart of ``spnerf_tpu/models/fused_tiny_nerf.py``. ``render_reference``
is the differentiable per-sample renderer a field is fitted through (the
reference's ``render_xla``); ``render_fused_rays`` and
``render_fused_rays_packed`` are the serving entry points, which run the
CUDA render kernels on the card. Parameters are a dict of (W, W) tensors
``w1``, ``w2``, ``w3``, ``wd``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spnerf_tpu_torch.device import resolve_device

ENC = 128
HID = 128


@dataclasses.dataclass(frozen=True)
class TinyFieldConfig:
    num_freqs: int = 16
    near: float = 2.0
    far: float = 6.0
    n_samples: int = 32
    bound: float = 4.0  # frequency base scale ~ scene extent
    # Field width (ENC == HID == width). 128 is the default; 64 and 32 are
    # the narrow serving widths of kernels/render.render_fused_packed,
    # whose products cost width^2 per sample.
    width: int = 128


def make_encoding(config: TinyFieldConfig):
    """(A (3, W), c (W,)) float32 numpy, with sin(x @ A + c) the feature
    map and W the config's width.

    Features: sin/cos of 2^f * x_d / bound for f < num_freqs, d < 3
    (2*3*F columns), one constant-one bias lane (c = pi/2, A column 0), the
    rest dead zeros. num_freqs is clamped to what the width can hold
    ((W-1)//6), so narrow fields drop the highest frequencies.
    """
    W = config.width
    F = min(config.num_freqs, (W - 1) // 6)
    A = np.zeros((3, W), np.float32)
    c = np.zeros((W,), np.float32)
    c[0] = np.pi / 2  # sin(pi/2) = 1: constant bias lane
    col = 1
    for d in range(3):
        for f in range(F):
            freq = (2.0**f) / config.bound
            A[d, col] = freq  # sin
            col += 1
            A[d, col] = freq  # cos via phase
            c[col] = np.pi / 2
            col += 1
    assert col <= W
    return A, c


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A true float32 product (no TF32), whatever the process-wide flag."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


def encode_rays(origins, directions, A, c):
    """-> (oe, de) float32 with sample encoding sin(oe + t * de)."""
    A, c = _on(A, origins), _on(c, origins)
    return _matmul_f32(origins, A) + c, _matmul_f32(directions, A)


def init_params(generator: torch.Generator, scale: float = 0.1,
                width: int = ENC, device="cuda") -> dict:
    """Normal(0, scale) weights drawn from ``generator`` (a CPU generator;
    not the numbers ``jax.random`` gives the reference for the same seed)."""
    device = resolve_device(device)
    return {k: (torch.randn((width, width), generator=generator)
                * scale).to(device) for k in ("w1", "w2", "w3", "wd")}


def direction_features(params, directions, A, c):
    """Per-ray view features injected before layer 2 (computed once)."""
    A, c = _on(A, directions), _on(c, directions)
    denc = torch.sin(_matmul_f32(directions, A) + c)
    return _matmul_f32(denc, params["wd"])


def render_reference(params, oe, de, config: TinyFieldConfig,
                     jitter: float = 0.5, df=None):
    """Reference renderer in PyTorch ops, differentiable (the reference
    package's ``render_xla``): the render kernel's math per sample, without
    its roundings to the weights' dtype."""
    cfg = config
    dt = (cfg.far - cfg.near) / cfg.n_samples
    R = oe.shape[0]
    w1, w2, w3 = (params[k].float() for k in ("w1", "w2", "w3"))
    rgb_acc = oe.new_zeros((R, 3))
    depth_acc = oe.new_zeros((R,))
    trans = oe.new_ones((R,))
    acc = oe.new_zeros((R,))
    df = oe.new_zeros((R, w2.shape[1])) if df is None else df
    for s in range(cfg.n_samples):
        t_s = cfg.near + (s + jitter) * dt
        enc = torch.sin(oe + t_s * de)
        h = torch.relu(_matmul_f32(enc, w1))
        h = torch.relu(_matmul_f32(h, w2) + df)
        head = _matmul_f32(h, w3)
        sigma = head[:, 0]
        alpha = 1.0 - torch.exp(-torch.relu(sigma) * dt)
        rgb = torch.sigmoid(head[:, 1:4])
        w = trans * alpha
        rgb_acc = rgb_acc + w[:, None] * rgb
        depth_acc = depth_acc + w * t_s
        acc = acc + w
        trans = trans * (1.0 - alpha)
    return {"rgb": rgb_acc, "depth": depth_acc, "acc": acc}


def _encode_on(params, origins, directions, config, A, c, device):
    """Rays, encodings and view features on ``device``."""
    device = resolve_device(device)
    origins = torch.as_tensor(origins, dtype=torch.float32, device=device)
    directions = torch.as_tensor(directions, dtype=torch.float32,
                                 device=device)
    if A is None or c is None:
        A, c = make_encoding(config)
    oe, de = encode_rays(origins, directions, A, c)
    df = direction_features(params, directions, A, c)
    return origins, directions, oe, de, df


@torch.no_grad()
def render_fused_rays(params, origins, directions, config: TinyFieldConfig,
                      A=None, c=None, jitter: float = 0.5, block: int = 512,
                      s_chunk: int = 8, occupancy_ivol=None,
                      early_stop_eps: float = 1e-3, device="cuda"):
    """Serving path: encode + fused render. Pass the field's integral
    occupancy volume (``ops.occupancy.field_integral_volume``) to skip empty
    sample chunks."""
    from spnerf_tpu_torch.kernels.render import render_fused

    origins, directions, oe, de, df = _encode_on(
        params, origins, directions, config, A, c, device)
    flags = None
    if occupancy_ivol is not None:
        from spnerf_tpu_torch.ops.occupancy import chunk_flags

        flags = chunk_flags(origins, directions, occupancy_ivol,
                            block=block, n_samples=config.n_samples,
                            s_chunk=s_chunk, near=config.near,
                            far=config.far, extent=float(config.far))
    rgb, depth = render_fused(
        oe, de, params["w1"], params["w2"], params["w3"], df,
        jitter=jitter, n_samples=config.n_samples, near=config.near,
        far=config.far, block=block, s_chunk=s_chunk, flags=flags,
        early_stop_eps=early_stop_eps)
    return {"rgb": rgb, "depth": depth}


@torch.no_grad()
def render_fused_rays_packed(params, origins, directions,
                             config: TinyFieldConfig, A=None, c=None,
                             jitter: float = 0.5, block: int = 512,
                             s_chunk: int = 8, early_stop_eps: float = 1e-3,
                             device="cuda"):
    """Serving path for narrow fields (config.width 64 or 32): encode +
    ``kernels.render.render_fused_packed``. The same field as
    ``render_reference`` with these parameters."""
    from spnerf_tpu_torch.kernels.render import render_fused_packed

    _, _, oe, de, df = _encode_on(params, origins, directions, config, A, c,
                                  device)
    rgb, depth = render_fused_packed(
        oe, de, params["w1"], params["w2"], params["w3"], df,
        jitter=jitter, width=config.width, n_samples=config.n_samples,
        near=config.near, far=config.far, block=block, s_chunk=s_chunk,
        early_stop_eps=early_stop_eps)
    return {"rgb": rgb, "depth": depth}
