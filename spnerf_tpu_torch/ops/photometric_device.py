"""On-device photometric augmentation
(``spnerf_tpu/ops/photometric_device.py``).

Images are (B, H, W, 1) float32 in [0, 1]; the parameters keep the
reference's 0-255 units and are rescaled inside. Parameter draws are
independent per sample; the application order of the primitives is drawn
once per batch. ``motion_blur`` and ``additive_shade`` blur with
reflect-101 padding; the shade blur takes sigma from the kernel size by
cv2's rule (sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8).

The augmentation is split in two so that its arithmetic can be held
against the reference fed with the reference's own random numbers:

- ``draw_photometric_randoms(gen, B, H, W, cfg)``: every random number
  one batch needs. The small per-sample draws come from the CPU generator
  ``gen``, in a fixed order (the order permutation, then the primitives in
  ``PRIMITIVES`` order, each drawing its fields in the order documented
  below, all of them whatever the config enables); the full-image noise
  fields of ``additive_gaussian_noise`` and ``additive_speckle_noise``
  come from ``field_gen``, a generator of the device the images are on.
- ``photometric_from_draws(images, draws, cfg)``: a deterministic
  function of those draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from spnerf_tpu_torch.parallel.mesh import Mesh, global_rows

PRIMITIVES = (
    "random_brightness",
    "random_contrast",
    "additive_gaussian_noise",
    "additive_speckle_noise",
    "motion_blur",
    "additive_shade",
)


@dataclasses.dataclass(frozen=True)
class PhotometricDeviceConfig:
    primitives: tuple[str, ...] = PRIMITIVES
    brightness_max_abs_change: float = 50.0
    contrast_strength_range: tuple[float, float] = (0.5, 1.5)
    gaussian_stddev_range: tuple[float, float] = (0.0, 10.0)
    speckle_prob_range: tuple[float, float] = (0.0, 0.005)
    motion_max_kernel_size: int = 3
    shade_nb_ellipses: int = 20
    shade_transparency_range: tuple[float, float] = (-0.5, 0.8)
    shade_kernel_size_range: tuple[int, int] = (100, 150)

    @classmethod
    def from_dict(cls, config: dict | None) -> "PhotometricDeviceConfig":
        """Build from an ``augmentation.photometric`` config block."""
        config = config or {}
        prims = config.get("primitives", "all")
        if prims == "all" or prims is None:
            prims = list(PRIMITIVES)
        prims = tuple(p for p in prims if p in PRIMITIVES)
        params = config.get("params", {}) or {}

        def rng2(name, key, default):
            v = params.get(name, {}).get(key, default)
            return (float(v[0]), float(v[1]))

        shade = params.get("additive_shade", {})
        return cls(
            primitives=prims,
            brightness_max_abs_change=float(
                params.get("random_brightness", {}).get("max_abs_change",
                                                        50.0)),
            contrast_strength_range=rng2("random_contrast", "strength_range",
                                         (0.5, 1.5)),
            gaussian_stddev_range=rng2("additive_gaussian_noise",
                                       "stddev_range", (0.0, 10.0)),
            speckle_prob_range=rng2("additive_speckle_noise", "prob_range",
                                    (0.0, 0.005)),
            motion_max_kernel_size=int(
                params.get("motion_blur", {}).get("max_kernel_size", 3)),
            shade_nb_ellipses=int(shade.get("nb_ellipses", 20)),
            shade_transparency_range=rng2("additive_shade",
                                          "transparency_range", (-0.5, 0.8)),
            shade_kernel_size_range=tuple(
                int(v) for v in shade.get("kernel_size_range", (100, 150))),
        )


# ----------------------------------------------------------------- helpers


def _depthwise_conv(images: torch.Tensor, kernels: torch.Tensor):
    """Each sample by its own kernel: (B, H, W, 1) already padded images,
    (B, kh, kw) kernels -> (B, H', W', 1), one grouped conv with the batch
    as channels (correlation, as the reference's)."""
    lhs = images[..., 0][None]  # (1, B, H, W)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(lhs, kernels[:, None], groups=images.shape[0])
    return out[0][..., None]


def _reflect_pad(images: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """reflect-101 (cv2's default border) padding on H and W."""
    x = images[..., 0][:, None]
    return F.pad(x, (rw, rw, rh, rh), mode="reflect")[:, 0][..., None]


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


# -------------------------------------------------------------- primitives
# Each takes (B, H, W, 1) images and its own draws (on the images'
# device) and returns (B, H, W, 1) in [0, 1].


def random_brightness(images, draws, cfg: PhotometricDeviceConfig):
    """draws: {"delta": (B,) in [-m, m], m = max_abs_change / 255}."""
    return torch.clamp(images + _col(draws["delta"]), 0.0, 1.0)


def random_contrast(images, draws, cfg: PhotometricDeviceConfig):
    """draws: {"strength": (B,) in strength_range}."""
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((images - mean) * _col(draws["strength"]) + mean,
                       0.0, 1.0)


def additive_gaussian_noise(images, draws, cfg: PhotometricDeviceConfig):
    """draws: {"std": (B,) in stddev_range / 255, "noise": (B, H, W, 1)
    standard normal}."""
    return torch.clamp(images + _col(draws["std"]) * draws["noise"], 0.0, 1.0)


def additive_speckle_noise(images, draws, cfg: PhotometricDeviceConfig):
    """draws: {"prob": (B,) in prob_range, "u": (B, H, W, 1) U(0, 1)}."""
    p, u = _col(draws["prob"]), draws["u"]
    out = torch.where(u < p, 0.0, images)
    return torch.where(u > 1.0 - p, 1.0, out)


def motion_blur(images, draws, cfg: PhotometricDeviceConfig):
    """Line-kernel blur: direction in {h, v, d1, d2}, odd length <= max.
    draws: {"size": (B,) int in [0, (max + 1) // 2], "direction": (B,) int
    in [0, 4)}; the radius is min(size, c), and radius 0 is the identity."""
    m = cfg.motion_max_kernel_size
    K = m if m % 2 else m + 1  # static kernel extent (odd)
    c = (K - 1) // 2
    dev = images.device
    radius = torch.clamp_max(draws["size"], c)[:, None, None]
    direction = draws["direction"][:, None, None]
    ii = torch.arange(K, device=dev)[None, :, None] - c  # rows
    jj = torch.arange(K, device=dev)[None, None, :] - c  # cols
    on_line = torch.where(
        direction == 0, ii == 0,
        torch.where(direction == 1, jj == 0,
                    torch.where(direction == 2, ii == jj, ii == -jj)))
    within = (ii.abs() <= radius) & (jj.abs() <= radius)
    kernels = (on_line & within).float()
    kernels = kernels / kernels.sum(dim=(1, 2), keepdim=True)
    return _depthwise_conv(_reflect_pad(images, c, c), kernels)


def additive_shade(images, draws, cfg: PhotometricDeviceConfig):
    """Random blurred ellipse shadows. The ellipse mask is an analytic
    field over the pixel grid; the blur is a separable Gaussian whose
    drawn radius is masked inside a kernel of the largest width, truncated
    (and renormalised) per axis where the image is smaller than it.

    draws: {"ax", "ay": (B, n) U(min_dim / 5, min_dim) with min_dim =
    min(H, W) / 4; "cx", "cy": (B, n) U(0, 1); "angle": (B, n) U(0, pi/2);
    "transparency": (B,) in transparency_range; "ksize": (B,) int in
    [lo, hi) of kernel_size_range}.
    """
    B, H, W, _ = images.shape
    dev = images.device
    ax = torch.clamp_min(draws["ax"], 1.0)
    ay = torch.clamp_min(draws["ay"], 1.0)
    max_rad = torch.maximum(ax, ay)
    cx = max_rad + draws["cx"] * torch.clamp_min(W - 2 * max_rad, 1.0)
    cy = max_rad + draws["cy"] * torch.clamp_min(H - 2 * max_rad, 1.0)
    angle = draws["angle"]

    X = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    Y = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    ca, sa = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    dx = X - cx[..., None, None]
    dy = Y - cy[..., None, None]
    xr = dx * ca + dy * sa
    yr = -dx * sa + dy * ca
    inside = ((xr / ax[..., None, None]) ** 2
              + (yr / ay[..., None, None]) ** 2) <= 1.0
    mask = inside.any(dim=1).float()[..., None]  # (B, H, W, 1)

    lo_k, hi_k = cfg.shade_kernel_size_range
    Kmax = hi_k if hi_k % 2 else hi_k + 1
    c = (Kmax - 1) // 2
    ks = draws["ksize"]
    ks = ks + (1 - ks % 2)  # next odd
    sigma = 0.3 * ((ks.float() - 1.0) * 0.5 - 1.0) + 0.8
    taps = torch.arange(Kmax, dtype=torch.float32, device=dev)[None, :] - c
    g = torch.exp(-0.5 * (taps / sigma[:, None]) ** 2)
    g = torch.where(taps.abs() <= ((ks - 1) // 2)[:, None].float(), g, 0.0)
    g = g / g.sum(dim=1, keepdim=True)  # (B, Kmax)

    def axis_kernel(dim):
        # reflect padding reaches at most dim - 1 pixels
        r = min(c, dim - 1)
        gk = g[:, c - r:c + r + 1]
        return gk / gk.sum(dim=1, keepdim=True), r

    gw, rw = axis_kernel(W)
    gh, rh = axis_kernel(H)
    blurred = _depthwise_conv(_reflect_pad(mask, 0, rw), gw[:, None, :])
    blurred = _depthwise_conv(_reflect_pad(blurred, rh, 0), gh[:, :, None])
    return torch.clamp(
        images * (1.0 - _col(draws["transparency"]) * blurred), 0.0, 1.0)


AUG_FNS = {
    "random_brightness": random_brightness,
    "random_contrast": random_contrast,
    "additive_gaussian_noise": additive_gaussian_noise,
    "additive_speckle_noise": additive_speckle_noise,
    "motion_blur": motion_blur,
    "additive_shade": additive_shade,
}


def draw_photometric_randoms(gen: torch.Generator, B: int, H: int, W: int,
                             cfg: PhotometricDeviceConfig,
                             field_gen: torch.Generator | None = None) -> dict:
    """Every random number ``photometric_from_draws`` needs for one batch:
    {"order": (len(cfg.primitives),) permutation, <primitive>: its draws}.

    ``gen`` is a CPU generator (the small draws; they are moved to
    ``field_gen``'s device); ``field_gen`` draws the two (B, H, W, 1)
    noise fields on its own device and defaults to ``gen``.
    """
    field_gen = gen if field_gen is None else field_gen
    dev = field_gen.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    def randint(shape, lo, hi):  # hi exclusive
        return torch.randint(lo, hi, shape, generator=gen)

    n = cfg.shade_nb_ellipses
    m = cfg.brightness_max_abs_change / 255.0
    min_dim = min(H, W) / 4.0
    lo_k, hi_k = cfg.shade_kernel_size_range
    small = {
        "order": torch.randperm(len(cfg.primitives), generator=gen),
        "random_brightness": {"delta": uniform((B,), -m, m)},
        "random_contrast": {
            "strength": uniform((B,), *cfg.contrast_strength_range)},
        "additive_gaussian_noise": {
            "std": uniform((B,), cfg.gaussian_stddev_range[0] / 255.0,
                           cfg.gaussian_stddev_range[1] / 255.0)},
        "additive_speckle_noise": {
            "prob": uniform((B,), *cfg.speckle_prob_range)},
        "motion_blur": {
            "size": randint((B,), 0, (cfg.motion_max_kernel_size + 1) // 2 + 1),
            "direction": randint((B,), 0, 4)},
        "additive_shade": {
            "ax": uniform((B, n), min_dim / 5, min_dim),
            "ay": uniform((B, n), min_dim / 5, min_dim),
            "cx": uniform((B, n)), "cy": uniform((B, n)),
            "angle": uniform((B, n), 0.0, math.pi / 2),
            "transparency": uniform((B,), *cfg.shade_transparency_range),
            "ksize": randint((B,), lo_k, hi_k)},
    }
    draws = {k: ({f: t.to(dev, non_blocking=True) for f, t in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in small.items()}
    draws["additive_gaussian_noise"]["noise"] = torch.randn(
        (B, H, W, 1), generator=field_gen, device=dev)
    draws["additive_speckle_noise"]["u"] = torch.rand(
        (B, H, W, 1), generator=field_gen, device=dev)
    return draws


def photometric_from_draws(images: torch.Tensor, draws: dict,
                           cfg: PhotometricDeviceConfig) -> torch.Tensor:
    """Apply ``cfg.primitives`` in the order ``draws["order"]`` (one order
    per batch, the draws independent per sample)."""
    for pos in draws["order"].tolist():
        name = cfg.primitives[pos]
        images = AUG_FNS[name](images, draws[name], cfg)
    return images


def photometric_augment(gen: torch.Generator, images: torch.Tensor,
                        cfg: PhotometricDeviceConfig,
                        field_gen: torch.Generator | None = None,
                        mesh: Mesh | None = None):
    """``photometric_from_draws`` on fresh draws; with a ``mesh``
    (``images`` being this rank's rows of the global batch) the draws are
    made for the global batch and cut to those rows."""
    if not cfg.primitives:
        return images
    B, H, W, _ = images.shape
    n, rows = global_rows(B, mesh)
    draws = draw_photometric_randoms(gen, n, H, W, cfg, field_gen)
    if mesh is not None:
        draws = {k: ({f: t[rows] for f, t in v.items()}
                     if isinstance(v, dict) else v)
                 for k, v in draws.items()}
    return photometric_from_draws(images, draws, cfg)
