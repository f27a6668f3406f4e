"""The port's warps, erosion and valid masks against
``spnerf_tpu.ops.image_warp`` and ``spnerf_tpu.kernels.warp_pallas`` on
the CPU.

``warp_image_fused`` on CPU tensors runs its plain version; JAX's Pallas
kernel runs in interpret mode, as the JAX package's own tests run it.
Tolerances: erosion and the ellipse exactly equal (0/1 counts); valid
masks equal except where round(sx) sits on a float32 tie (< 0.1% of
pixels); the bf16 and int8 warps within 1e-5 of the Pallas kernel given
the same H^-1, and within 8e-3 through the public function, whose H^-1
is the port's own (reasons at each test); float32 warps within 1e-5 of
``warp_image_matmul`` (the H^-1 ulps again, and float32 products summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.geometry.homography import HomographyConfig, sample_homography
from spnerf_tpu.kernels.warp_pallas import warp_image_fused as jax_fused
from spnerf_tpu.ops import image_warp as jw
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.warp import (
    invert_homographies,
    warp_by_inverse,
    warp_image_fused,
    warp_image_fused_plain,
    warp_taps,
)
from spnerf_tpu_torch.ops import image_warp as tw

B, H, W = 2, 40, 56  # 40 is not a multiple of the Pallas row tile (16)


def _homographies(n, shape=(H, W), seed=0):
    cfg = HomographyConfig(allow_artifacts=True, patch_ratio=0.8,
                           scaling_amplitude=0.2, max_angle=1.57)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.stack([np.asarray(sample_homography(k, shape, cfg))
                     for k in keys]).astype(np.float32)


def _image(seed=7, b=B):
    return np.random.default_rng(seed).random((b, H, W, 1)).astype(np.float32)


@pytest.mark.parametrize("size", range(1, 11))
def test_ellipse_kernel_matches_jax(size):
    np.testing.assert_array_equal(tw.ellipse_kernel(size),
                                  jw.ellipse_kernel(size))


@pytest.mark.parametrize("size", [2, 4, 6])
def test_binary_erosion_matches_jax(size):
    mask = (np.random.default_rng(size).random((2, 30, 36)) > 0.15)
    mask = mask.astype(np.float32)
    k = jw.ellipse_kernel(size)
    want = np.asarray(jw.binary_erosion(jnp.asarray(mask), k))
    got = tw.binary_erosion(torch.from_numpy(mask), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize("erosion", [0, 3])
def test_compute_valid_mask_matches_jax(erosion):
    Hs = _homographies(6, seed=1)
    want = np.asarray(jw.compute_valid_mask((H, W), jnp.asarray(Hs), erosion))
    got = tw.compute_valid_mask((H, W), torch.from_numpy(Hs), erosion)
    assert got.dtype == torch.int32 and got.shape == (6, H, W)
    assert np.mean(got.numpy() != want) < 1e-3
    assert 0.1 < want.mean() < 0.95


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_warp_taps_match_pallas_given_its_inverse(dtype):
    """The kernel's arithmetic fed JAX's own H^-1: within 1e-5. XLA on
    the CPU contracts h0 x + h1 y (+ h2) into FMAs, which moves sy by an
    ulp now and then, and one float32 ulp of sy < 64 is 3.8e-6 of a y
    weight."""
    img, Hs = _image(), _homographies(B, seed=2)
    want = np.asarray(jax_fused(jnp.asarray(img), jnp.asarray(Hs),
                                compute_dtype=getattr(jnp, dtype)))
    hinv = torch.from_numpy(np.array(jnp.linalg.inv(jnp.asarray(Hs))))
    got = warp_taps(torch.from_numpy(img), hinv, None,
                    getattr(torch, dtype)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.mean(want > 0) > 0.3  # the warp moved real content


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_warp_fused_plain_matches_pallas(dtype):
    """Through the public function, which inverts H itself (a float64
    adjugate, where XLA solves in float32): the inverses differ by ulps,
    and one ulp of sx can flip the rounding of an x weight (one bf16 ulp,
    <= 2^-8, or 1/127 in int8, per tap): within 8e-3, and 90% of values
    within 1e-5 (measured: 3.4e-3 and 0.27% for bf16)."""
    img, Hs = _image(), _homographies(B, seed=2)
    want = np.asarray(jax_fused(jnp.asarray(img), jnp.asarray(Hs),
                                compute_dtype=getattr(jnp, dtype)))
    before = sum(_build.launch_counts.values())
    got = warp_image_fused(torch.from_numpy(img), torch.from_numpy(Hs),
                           compute_dtype=getattr(torch, dtype))
    assert sum(_build.launch_counts.values()) == before  # CPU: no launch
    assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)
    assert np.mean(np.abs(got - want) > 1e-5) < 0.1


def test_warp_matmul_f32_matches_jax():
    img, Hs = _image(), _homographies(B, seed=3)
    want = np.asarray(jw.warp_image_matmul(jnp.asarray(img), jnp.asarray(Hs)))
    got = tw.warp_image_matmul(torch.from_numpy(img), torch.from_numpy(Hs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_image_gather_matches_jax(mode):
    """Within 2e-5: the two H^-1 differ by float32 ulps, which move sx and
    sy (|s| < 64) by a few ulps of 3.8e-6 each, and the output by as much
    on [0, 1] data; nearest sampling flips only on a rounding tie."""
    img = np.random.default_rng(9).random((B, H, W, 3)).astype(np.float32)
    Hs = _homographies(B, seed=4)
    want = np.asarray(jw.warp_image(jnp.asarray(img), jnp.asarray(Hs),
                                    mode=mode))
    got = tw.warp_image(torch.from_numpy(img), torch.from_numpy(Hs),
                        mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_warp_zero_denominator(dtype):
    """H^-1 = [[1,0,0],[0,1,0],[-1/16,0,1]]: d = 1 - x/16 is 0 on the
    column x = 16 and negative past it. Where sx, sy are +-inf both
    sides give 0; at (16, 0) sy is 0/0, where the dense reference gives
    nan and the port 0."""
    Hf = np.array([[[1, 0, 0], [0, 1, 0], [1 / 16, 0, 1]]], np.float32)
    img = _image(b=1)
    if dtype == "float32":
        want = np.asarray(jw.warp_image_matmul(jnp.asarray(img),
                                               jnp.asarray(Hf)))
        got = tw.warp_image_matmul(torch.from_numpy(img), torch.from_numpy(Hf))
    else:
        want = np.asarray(jax_fused(jnp.asarray(img), jnp.asarray(Hf),
                                    compute_dtype=getattr(jnp, dtype)))
        got = warp_image_fused_plain(torch.from_numpy(img),
                                     torch.from_numpy(Hf),
                                     getattr(torch, dtype))
    got = got.numpy()[0, ..., 0]
    want = want[0, ..., 0]
    assert np.isfinite(got).all()
    assert (got[:, 16:] == 0).all()
    nan = np.isnan(want)
    assert not nan[:, :16].any() and not nan[1:].any()
    np.testing.assert_allclose(got[~nan], want[~nan], atol=1e-5, rtol=0)
    # sx = x / (1 - x/16) leaves the image from x = 12 on
    assert (got[:20, :8] > 0).all()


def test_warp_fused_tiles_images_by_homography_index():
    """N = 3B homographies: homography n warps image n % B, as a warp of
    the tiled batch does."""
    img, Hs = _image(), _homographies(3 * B, seed=5)
    t_img, t_H = torch.from_numpy(img), torch.from_numpy(Hs)
    got = warp_image_fused(t_img, t_H)
    want = warp_image_fused(t_img.repeat(3, 1, 1, 1), t_H)
    assert torch.equal(got, want)
    assert torch.equal(tw.warp_image_matmul(t_img, t_H),
                       tw.warp_image_matmul(t_img.repeat(3, 1, 1, 1), t_H))


def test_warp_by_inverse_is_the_fused_warp_of_the_inverse():
    """The public function inverts H and hands H^-1 to the kernel's
    wrapper: equal to the bit."""
    img, Hs = _image(), _homographies(2 * B, seed=6)
    t_img, t_H = torch.from_numpy(img), torch.from_numpy(Hs)
    for dtype in (torch.bfloat16, torch.int8):
        assert torch.equal(
            warp_by_inverse(t_img, invert_homographies(t_H), dtype),
            warp_image_fused(t_img, t_H, dtype))


def test_warp_fused_rejects_what_the_kernel_does_not_take():
    img = torch.zeros(2, 8, 8, 1)
    with pytest.raises(ValueError, match="compute_dtype"):
        warp_image_fused(img, torch.eye(3).expand(2, 3, 3), torch.float32)
    with pytest.raises(ValueError, match="homographies"):
        warp_image_fused(img, torch.eye(3).expand(3, 3, 3))
    with pytest.raises(ValueError, match="single-channel"):
        warp_image_fused(torch.zeros(2, 8, 8, 3), torch.eye(3).expand(2, 3, 3))
