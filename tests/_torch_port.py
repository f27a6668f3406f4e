"""Shared helpers of the ``test_torch_*`` files: seeded flax SuperPoint
weights with non-trivial BatchNorm statistics, and bf16 comparisons.
Imports JAX only inside ``flax_superpoint`` and
``jax_homography_draws``: the on-card tests use this
module where JAX is not installed."""

import numpy as np
import torch


def flax_superpoint(cfg, shape, seed=0):
    """(flax model, variables as a numpy tree). The flax init leaves BN
    at identity; random BN parameters and running stats make folding
    and weight-transfer bugs visible."""
    import jax

    from spnerf_tpu.models.superpoint import init_superpoint

    model, variables = init_superpoint(jax.random.PRNGKey(seed), cfg, shape)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    rng = np.random.default_rng(seed + 100)

    def perturb(params, stats):
        for key, node in params.items():
            if "BatchNorm_0" in node:
                bn, st = node["BatchNorm_0"], stats[key]["BatchNorm_0"]
                c = bn["scale"].shape[0]
                bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                bn["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                st["mean"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
                st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            else:
                perturb(node, stats[key])

    perturb(variables["params"], variables["batch_stats"])
    return model, variables


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max())


def bf16_scaled_ulps(got: torch.Tensor, want: torch.Tensor,
                     floor: float = 2.0 ** -8) -> torch.Tensor:
    """Per-value distance in bf16 ulps at the larger of the two values,
    and at least at ``floor`` times ``want``'s largest magnitude: float32
    sums in another order differ by an absolute amount near the tensor's
    scale times 1e-7, which is more than a bf16 ulp of a value close to
    zero. Within one binade above the floor this is the bit distance."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    mag = torch.clamp_min(mag, max(floor * float(w.abs().max()), 1e-30))
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def jax_bf16_to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)


def jax_homography_draws(key, cfg):
    """The random numbers jax's sample_homography draws from ``key``, in
    the layout of ``draw_homography_randoms``."""
    import jax
    import jax.numpy as jnp

    k_persp, k_scale_v, k_scale_p, k_trans, k_rot = jax.random.split(key, 5)
    tn = lambda k, shape: jax.random.truncated_normal(k, -2.0, 2.0, shape)  # noqa: E731
    persp = [tn(k, ()) for k in jax.random.split(k_persp, 3)]
    _, kr2 = jax.random.split(k_rot)
    draws = {
        "persp": jnp.stack(persp),
        "scales": tn(k_scale_v, (cfg.n_scales,)),
        "scale_gumbel": jax.random.gumbel(k_scale_p, (cfg.n_scales + 1,),
                                          jnp.float32),
        "shift": jax.random.uniform(k_trans, (2,)),
        "angle_gumbel": jax.random.gumbel(kr2, (cfg.n_angles + 1,),
                                          jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in draws.items()}
