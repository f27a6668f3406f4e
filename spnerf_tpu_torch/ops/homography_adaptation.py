"""Homographic adaptation: detection probabilities aggregated over random
views (``spnerf_tpu/ops/homography_adaptation.py``).

Per chunk of warps, the batch is warped by chunk * B homographies at
once, run through ONE batched forward, unwarped and folded into running
sum / count / max accumulators on the device; the (num, H, W) stack
never exists. Semantics (reference export.py:42-114):

- mask  = erode(warp(ones, H)):    border artifacts in the warped frame;
- count = erode(warp(ones, H^-1)): visibility weight in the original frame;
- prob_proj = warp(prob_fn(warp(img, H)) * mask, H^-1) * count;
- counts include the identity view's ones; "sum" gives the mean over
  visible views, "max" the pixelwise max (identity view included).

The JAX package samples the homographies inside its jitted program from
a PRNG key; its bits cannot be reproduced here, so the caller passes them
in (``image_homographies`` draws them per image from (seed, global image
index)). Where the reference pads the last chunk with dead warps, this
loop runs a shorter last chunk: there are no padding warps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spnerf_tpu_torch.geometry.homography import (
    HomographyConfig,
    draw_homography_randoms,
    homography_from_draws,
)
from spnerf_tpu_torch.kernels.warp import (
    invert_homographies,
    warp_by_inverse,
    warp_taps,
)
from spnerf_tpu_torch.ops.image_warp import valid_mask_from_inverse


@dataclasses.dataclass(frozen=True)
class HAConfig:
    """The reference's ``homography_adaptation`` keys and defaults.
    ``warp_impl: "pallas"`` (the default) selects the port's CUDA warp
    kernel, ``kernels/warp.py``; so does ``"matmul"``."""

    num: int = 100
    aggregation: str = "sum"  # "sum" (-> mean) or "max"
    valid_border_margin: int = 3
    filter_counts: int = 0
    chunk: int = 10  # warps per forward
    # warp rounding: "bfloat16" (the default) and "int8" (7-bit fixed
    # point) run the CUDA kernel of kernels/warp.py; "float32" (exact) is
    # warp_image_matmul's PyTorch ops, as it is XLA in the reference
    compute_dtype: str = "bfloat16"
    # the reference's choice between its Pallas kernel ("pallas") and XLA
    # matmuls ("matmul") for bf16 / int8, which compute the same function;
    # kept so that the same configs load. Both names run the CUDA kernel.
    warp_impl: str = "pallas"
    params: HomographyConfig = HomographyConfig()

    @classmethod
    def from_dict(cls, d: dict) -> "HAConfig":
        d = dict(d or {})
        params = HomographyConfig.from_dict(d.pop("params", {}))
        fields = {f.name for f in dataclasses.fields(cls)} - {"params"}
        return cls(params=params, **{k: v for k, v in d.items() if k in fields})


def image_homographies(seed: int, indices, n: int, shape: tuple[int, int],
                       params: HomographyConfig) -> torch.Tensor:
    """(len(indices), n, 3, 3) float32 CPU homographies: image i's are
    drawn from a generator seeded by SeedSequence((seed, i)), so they
    depend on nothing but (seed, global image index)."""
    if n == 0:
        return torch.zeros((len(indices), 0, 3, 3))
    draws = []
    for i in indices:
        state = np.random.SeedSequence((seed, int(i))).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        draws.append(draw_homography_randoms(gen, n, params))
    draws = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    return homography_from_draws(draws, shape, params)


def _warp_fn(config: HAConfig):
    """(images, H^-1) -> warped images, for ``config.compute_dtype``."""
    if config.warp_impl not in ("pallas", "matmul"):
        raise ValueError(f"HAConfig.warp_impl={config.warp_impl!r}: "
                         "'pallas' or 'matmul'")
    dtype = getattr(torch, config.compute_dtype)
    if dtype == torch.float32:
        return lambda img, hinv: warp_taps(img, hinv, None, torch.float32)
    return lambda img, hinv: warp_by_inverse(img, hinv, compute_dtype=dtype)


@torch.no_grad()
def homography_adaptation(prob_fn, image: torch.Tensor,
                          homographies: torch.Tensor,
                          config: HAConfig) -> torch.Tensor:
    """Aggregate detection probabilities over ``config.num`` views.

    prob_fn: (N, H, W, 1) images -> (N, H, W) probabilities. image:
    (B, H, W, 1). homographies: (B, num - 1, 3, 3), the random views of
    each image (the identity view is added here). Returns the aggregated
    (B, H, W) heatmap, before NMS.
    """
    B, H, W, _ = image.shape
    cfg = config
    n_extra = cfg.num - 1
    prob0 = prob_fn(image)
    if n_extra == 0:
        return prob0
    if tuple(homographies.shape) != (B, n_extra, 3, 3):
        raise ValueError(f"homography_adaptation: homographies "
                         f"{tuple(homographies.shape)}, expected "
                         f"{(B, n_extra, 3, 3)}")
    warp = _warp_fn(cfg)
    margin = cfg.valid_border_margin
    # warp j of image b at row j * B + b, the reference's order
    homs = homographies.to(image.device, torch.float32).transpose(0, 1)
    # the inverses of every chunk at once: the warp by H and its mask take
    # H^-1, the unwarp by H^-1 and its count take (H^-1)^-1
    invs = invert_homographies(homs)
    inv_invs = invert_homographies(invs)
    sum_prob, max_prob = prob0.clone(), prob0.clone()
    sum_count = torch.ones_like(prob0)
    for c0 in range(0, n_extra, cfg.chunk):
        h_inv, h_inv_inv = (t[c0:c0 + cfg.chunk].reshape(-1, 3, 3)
                            for t in (invs, inv_invs))
        k = h_inv.shape[0] // B
        warped = warp(image, h_inv)  # homography n warps image n % B
        mask = valid_mask_from_inverse((H, W), h_inv, margin)
        count = valid_mask_from_inverse((H, W), h_inv_inv, margin)
        prob = prob_fn(warped) * mask
        proj = warp(prob[..., None], h_inv_inv)[..., 0] * count
        proj = proj.reshape(k, B, H, W)
        sum_prob += proj.sum(0)
        sum_count += count.reshape(k, B, H, W).sum(0)
        max_prob = torch.maximum(max_prob, proj.amax(0))
    if cfg.aggregation == "max":
        return max_prob
    return sum_prob / torch.clamp_min(sum_count, 1e-6)
