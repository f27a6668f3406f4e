"""The port's homography geometry against ``spnerf_tpu.geometry.homography``
on the CPU, and its own sampler by statistics.

The port cannot reproduce ``jax.random``'s bits, so the deterministic part
of its sampler (``homography_from_draws``) is fed the random numbers that
JAX's ``sample_homography`` draws from the same key, and must return
JAX's matrix. Tolerance: atol 1e-4 on the normalised entries and rtol 1e-4
on the pixel-scale translation entries (float32 DLT solves by two LAPACK
paths, float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_homography_draws
from spnerf_tpu.geometry import homography as jh
from spnerf_tpu_torch.geometry import homography as th
from spnerf_tpu_torch.ops.homography_adaptation import image_homographies

EXPORT_PARAMS = dict(scaling_amplitude=0.2, perspective_amplitude_x=0.2,
                     perspective_amplitude_y=0.2, allow_artifacts=True,
                     patch_ratio=0.85, max_angle=1.57)


@pytest.mark.parametrize("params", [
    {}, EXPORT_PARAMS, dict(patch_ratio=0.8, scaling_amplitude=0.3,
                            max_angle=0.5)],
    ids=["defaults", "export", "no_artifacts"])
def test_homography_from_jax_draws_matches_jax(params):
    shape = (48, 64)
    jcfg = jh.HomographyConfig.from_dict(params)
    tcfg = th.HomographyConfig.from_dict(params)
    keys = jax.random.split(jax.random.PRNGKey(3), 12)
    want = np.stack([np.asarray(jh.sample_homography(k, shape, jcfg))
                     for k in keys])
    draws = [jax_homography_draws(k, jcfg) for k in keys]
    batched = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    got = th.homography_from_draws(batched, shape, tcfg).numpy()
    assert got.shape == (12, 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_homography_from_corners_matches_jax():
    rng = np.random.default_rng(20)
    for _ in range(5):
        p1 = rng.uniform(0, 300, (4, 2)).astype(np.float32)
        p2 = (p1 + rng.normal(0, 20, (4, 2))).astype(np.float32)
        want = np.asarray(jh.homography_from_corners(jnp.asarray(p1),
                                                     jnp.asarray(p2)))
        got = th.homography_from_corners(torch.from_numpy(p1),
                                         torch.from_numpy(p2)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        # and it maps the corners onto each other
        mapped = th.warp_points(torch.from_numpy(p1[:, ::-1].copy()),
                                torch.from_numpy(got)).numpy()[:, ::-1]
        np.testing.assert_allclose(mapped, p2, atol=1e-2)


def test_warp_points_matches_jax():
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 100, (3, 10, 2)).astype(np.float32)
    H = (np.eye(3) + rng.normal(0, 0.05, (3, 3, 3))).astype(np.float32)
    H[:, 2, :2] *= 0.01
    want = np.asarray(jh.warp_points(jnp.asarray(pts), jnp.asarray(H)))
    got = th.warp_points(torch.from_numpy(pts), torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_adapt_homography_to_resize_matches_jax():
    H = np.random.default_rng(22).normal(0, 1, (3, 3)).astype(np.float32)
    want = np.asarray(jh.adapt_homography_to_resize(jnp.asarray(H),
                                                    (480, 640), (240, 320)))
    got = th.adapt_homography_to_resize(torch.from_numpy(H), (480, 640),
                                        (240, 320)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_sampler_keeps_the_patch_inside_without_artifacts():
    shape = (48, 64)
    cfg = th.HomographyConfig(patch_ratio=0.6, scaling_amplitude=0.3,
                              perspective_amplitude_x=0.3,
                              perspective_amplitude_y=0.3)
    Hs = th.sample_homographies(torch.Generator().manual_seed(0), 300,
                                shape, cfg)
    # the returned matrix is the inverse: its inverse maps the patch
    # corners to where the sampler moved them
    m = (1 - cfg.patch_ratio) / 2
    c = np.array([[m, m], [m + cfg.patch_ratio, m],
                  [m + cfg.patch_ratio, m + cfg.patch_ratio],
                  [m, m + cfg.patch_ratio]], np.float32)  # (x, y) unit
    corners_yx = torch.from_numpy(c[:, ::-1] * np.array(shape, np.float32))
    moved = th.warp_points(corners_yx.expand(300, 4, 2),
                           torch.linalg.inv(Hs)).numpy()
    assert np.isfinite(moved).all()
    assert moved.min() >= -1e-3
    assert (moved[..., 0] <= shape[0] + 1e-3).all()
    assert (moved[..., 1] <= shape[1] + 1e-3).all()
    # and they do move: not the identity
    assert np.abs(moved - corners_yx.numpy()).max() > 1.0


def test_sampler_angles_come_from_the_candidate_bank():
    cfg = th.HomographyConfig(perspective=False, scaling=False,
                              translation=False, max_angle=1.2, n_angles=9)
    Hs = th.sample_homographies(torch.Generator().manual_seed(1), 200,
                                (40, 40), cfg)
    A = torch.linalg.inv(Hs)  # forward map: a rotation about the center
    angles = torch.atan2(A[:, 1, 0], A[:, 0, 0]).numpy()
    bank = np.concatenate([[0.0], np.linspace(-1.2, 1.2, 9)])
    nearest = np.abs(angles[:, None] - bank[None]).min(1)
    assert nearest.max() < 1e-4
    assert np.abs(angles).max() <= 1.2 + 1e-4
    # a uniform choice among the 10 valid candidates reaches most of them
    assert len(np.unique(np.round(angles, 3))) >= 8


def test_masked_choice_falls_back_to_the_safe_candidate():
    """Every scaled candidate leaves the unit square: index 0 (scale 1)
    is taken and the homography is the identity."""
    cfg = th.HomographyConfig(perspective=False, translation=False,
                              rotation=False, scaling_amplitude=2.0,
                              patch_ratio=0.9)
    draws = th.draw_homography_randoms(torch.Generator().manual_seed(2), 4,
                                       cfg)
    draws["scales"] = torch.full_like(draws["scales"], 2.0)  # scale 3
    Hs = th.homography_from_draws(draws, (30, 40), cfg)
    np.testing.assert_allclose(Hs.numpy(), np.broadcast_to(np.eye(3),
                                                           (4, 3, 3)),
                               atol=1e-5)


def test_image_homographies_depend_only_on_seed_and_index():
    params = th.HomographyConfig.from_dict(EXPORT_PARAMS)
    a = image_homographies(7, [3, 4, 5], 6, (24, 32), params)
    b = image_homographies(7, [5], 6, (24, 32), params)
    c = image_homographies(8, [5], 6, (24, 32), params)
    assert a.shape == (3, 6, 3, 3)
    assert torch.equal(a[2], b[0])
    assert not torch.allclose(b, c)
    assert not torch.allclose(a[0], a[1])
    assert image_homographies(7, [1, 2], 0, (24, 32), params).shape == (2, 0, 3, 3)
