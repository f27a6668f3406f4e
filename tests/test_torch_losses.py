"""The port's losses, keypoint maps and metrics against the JAX package
on the CPU: the same numpy arrays through both.

Tolerances: float32 sums in another order, rtol 1e-5 on loss values
(2e-5 on the double-normalised descriptor loss) and rtol 1e-4 / atol 1e-5
of the largest entry on gradients; integer maps and masks are equal. The
detector loss is fed the tie-break noise that JAX draws from its key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.geometry import keypoints as jk
from spnerf_tpu.ops import space_ops as js
from spnerf_tpu.train import losses as jl
from spnerf_tpu.train import metrics as jm
from spnerf_tpu_torch.geometry import keypoints as tk
from spnerf_tpu_torch.ops import space_ops as ts
from spnerf_tpu_torch.train import losses as tl
from spnerf_tpu_torch.train import metrics as tm

G = 8
KW = dict(grid_size=G, lambda_d=250, lambda_loss=1e-4, positive_margin=1.0,
          negative_margin=0.2)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_space_to_depth_and_back():
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    got = ts.space_to_depth(_t(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(ts.depth_to_space(got, 4).numpy(), x)


def test_cell_mask():
    rng = np.random.default_rng(1)
    valid = (rng.uniform(size=(2, 32, 48)) > 0.02).astype(np.int32)
    want = np.asarray(jl._cell_mask(jnp.asarray(valid), G))
    got = tl._cell_mask(_t(valid), G).numpy()
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


def test_filter_points_mask_and_keypoint_map():
    rng = np.random.default_rng(2)
    H, W = 32, 48
    pts = rng.uniform(-4, 52, (3, 40, 2)).astype(np.float32)
    pts[0, :6] = [[0.5, 1.5], [2.5, 3.5], [-0.5, 4.0], [30.5, 46.5],
                  [31.0, 5.0], [5.0, 47.0]]  # halves round to even; edges
    pts[1, 0] = [np.nan, 3.0]
    pts[1, 1] = [1e9, -1e9]
    mask = rng.uniform(size=(3, 40)) > 0.3
    np.testing.assert_array_equal(
        tk.filter_points_mask(_t(pts), (H, W)).numpy(),
        np.asarray(jk.filter_points_mask(jnp.asarray(pts), (H, W))))
    want = np.stack([np.asarray(jk.compute_keypoint_map(
        jnp.asarray(p), (H, W), jnp.asarray(m))) for p, m in zip(pts, mask)])
    got = tk.compute_keypoint_map(_t(pts), (H, W), _t(mask))
    assert got.dtype == torch.int32 and want.sum() > 10
    np.testing.assert_array_equal(got.numpy(), want)
    # without a mask, one point set
    np.testing.assert_array_equal(
        tk.compute_keypoint_map(_t(pts[0]), (H, W)).numpy(),
        np.asarray(jk.compute_keypoint_map(jnp.asarray(pts[0]), (H, W))))


def test_top_k_keypoints():
    prob = np.random.default_rng(3).uniform(size=(12, 16)).astype(np.float32)
    want = jk.top_k_keypoints(jnp.asarray(prob), 20, 0.9)
    got = tk.top_k_keypoints(_t(prob), 20, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_precision_recall():
    rng = np.random.default_rng(4)
    pred = (rng.uniform(size=(2, 16, 24)) > 0.7).astype(np.int32)
    lab = (rng.uniform(size=(2, 16, 24)) > 0.8).astype(np.int32)
    want = jm.precision_recall(jnp.asarray(pred), jnp.asarray(lab))
    got = tm.precision_recall(_t(pred), _t(lab))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_detector_loss_fed_jax_noise(masked):
    rng = np.random.default_rng(5)
    B, Hc, Wc = 2, 4, 6
    logits = rng.standard_normal((B, Hc, Wc, 65)).astype(np.float32) * 2
    heat = (rng.uniform(size=(B, Hc * G, Wc * G)) > 0.97).astype(np.int32)
    heat[0, :G, :G] = 0  # an empty cell: the dustbin wins by value
    heat[0, G:2 * G, :G] = 1  # a full cell: the noise picks the pixel
    valid = None
    if masked:
        valid = np.ones((B, Hc * G, Wc * G), np.int32)
        valid[:, -G:] = 0
        valid[1, 3, 3] = 0
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, (B, Hc, Wc, 65), minval=0.0,
                                          maxval=0.1))
    jv = None if valid is None else jnp.asarray(valid)
    want, want_g = jax.value_and_grad(
        lambda lg: jl.detector_loss(key, lg, jnp.asarray(heat), jv, G))(
            jnp.asarray(logits))
    lg = _t(logits, True)
    got = tl.detector_loss(_t(noise), lg, _t(heat), _t(valid), G)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    _close_grads([lg.grad], [want_g])


def test_detector_noise_range():
    gen = torch.Generator().manual_seed(0)
    noise = tl.detector_noise(gen, (2, 3, 4, 65))
    assert noise.shape == (2, 3, 4, 65) and noise.dtype == torch.float32
    assert 0 <= float(noise.min()) and float(noise.max()) < 0.1
    assert float(noise.std()) > 0.02


def _desc_case(seed=6, Hc=6, Wc=8, C=32):
    rng = np.random.default_rng(seed)
    B, N = 2, Hc * Wc
    desc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    wdesc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    warped = (rng.integers(0, 4 * G * Wc, (B, N, 2)) / 4.0).astype(np.float32)
    valid = np.ones((B, Hc * G, Wc * G), np.float32)
    valid[:, :G] = 0
    return desc, wdesc, warped, valid


@pytest.mark.parametrize("normalise", [False, True], ids=["raw", "normalised"])
def test_descriptor_loss_from_cells(normalise):
    desc, wdesc, warped, valid = _desc_case()
    kw = dict(KW, normalise_descriptors=normalise)

    def jloss(a, b):
        return jl.descriptor_loss_from_cells(
            a, b, jnp.asarray(warped), jl.DescriptorLossConfig(**kw),
            jnp.asarray(valid))

    want = jloss(jnp.asarray(desc), jnp.asarray(wdesc))
    want_g = jax.grad(lambda a, b: jloss(a, b)[0], argnums=(0, 1))(
        jnp.asarray(desc), jnp.asarray(wdesc))
    a, b = _t(desc, True), _t(wdesc, True)
    got = tl.descriptor_loss_from_cells(a, b, _t(warped),
                                        tl.DescriptorLossConfig(**kw),
                                        _t(valid))
    np.testing.assert_allclose([float(v.detach()) for v in got],
                               [float(v) for v in want], rtol=2e-5)
    got[0].backward()
    _close_grads([a.grad, b.grad], want_g)


def test_descriptor_loss_through_a_homography():
    desc, wdesc, _, valid = _desc_case(seed=7)
    rng = np.random.default_rng(8)
    hom = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    hom[:, :2, :2] += rng.uniform(-0.1, 0.1, (2, 2, 2)).astype(np.float32)
    hom[:, :2, 2] = rng.uniform(-6, 6, (2, 2))
    hom[:, 2, :2] = rng.uniform(-1e-3, 1e-3, (2, 2))
    want = jl.descriptor_loss(jnp.asarray(desc), jnp.asarray(wdesc),
                              jnp.asarray(hom), jl.DescriptorLossConfig(**KW),
                              jnp.asarray(valid))
    got = tl.descriptor_loss(_t(desc), _t(wdesc), _t(hom),
                             tl.DescriptorLossConfig(**KW), _t(valid))
    # a warped cell within float32 rounding of the radius may change side:
    # one of 48 x 48 x 2 pairs moves the loss by up to 3e-4 relative
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-3)


@pytest.mark.parametrize("tile", [400, 20], ids=["one_tile", "ragged_tiles"])
def test_normalised_blockwise_value_and_gradients(tile):
    desc, wdesc, warped, valid = _desc_case(seed=9)
    jcfg = jl.DescriptorLossConfig(**dict(KW, normalise_descriptors=True))
    tcfg = tl.DescriptorLossConfig(**dict(KW, normalise_descriptors=True))

    def jloss(a, b):
        return jl.descriptor_loss_normalised_blockwise(
            a, b, jnp.asarray(warped), jcfg, jnp.asarray(valid), tile=tile)

    want = jloss(jnp.asarray(desc), jnp.asarray(wdesc))
    want_g = jax.grad(lambda a, b: jloss(a, b)[0], argnums=(0, 1))(
        jnp.asarray(desc), jnp.asarray(wdesc))
    a, b = _t(desc, True), _t(wdesc, True)
    got = tl.descriptor_loss_normalised_blockwise(a, b, _t(warped), tcfg,
                                                  _t(valid), tile=tile)
    np.testing.assert_allclose([float(v.detach()) for v in got],
                               [float(v) for v in want], rtol=2e-5)
    got[0].backward()
    _close_grads([a.grad, b.grad], want_g)
    # and it is the dense normalise branch
    dense = tl.descriptor_loss_from_cells(_t(desc), _t(wdesc), _t(warped),
                                          tcfg, _t(valid))
    np.testing.assert_allclose([float(v.detach()) for v in got],
                               [float(v) for v in dense], rtol=2e-5)


def test_nerf_variants_name_their_slice():
    """The NeRF slice's variants exist: with the same camera on both sides
    the depth reprojection maps every cell centre onto itself, so
    ``descriptor_loss_nerf`` is the dense loss on the unwarped cells, and
    ``prepare_nerf_batch`` keeps the keypoints and carries the depth and
    cameras (both held to JAX in ``test_torch_nerf_train.py``)."""
    from spnerf_tpu_torch.train import pipeline

    B, H, W, C = 2, 32, 40, 16
    rng = np.random.default_rng(5)
    desc = [torch.from_numpy(rng.standard_normal((B, H // 8, W // 8, C))
                             .astype(np.float32)) for _ in range(2)]
    K = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]).expand(
        B, 3, 3)
    R, t = torch.eye(3).expand(B, 3, 3), torch.full((B, 3, 1), 0.5)
    depth = torch.full((B, H, W), 3.0)
    # the normalised loss's radius, 7.5: at the hinge loss's 8 the
    # neighbouring cells, 8 px away, sit on the step within the
    # reprojection's rounding
    cfg = tl.DescriptorLossConfig(grid_size=8, normalise_descriptors=True)
    got = tl.descriptor_loss_nerf(*desc, depth, K, R, t, R, t, cfg)
    cells = tl.cell_grid_coords(H // 8, W // 8, 8)
    want = tl.descriptor_loss_from_cells(*desc, cells.expand(B, -1, 2), cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    kpts = torch.tensor([[[4.0, 6.0], [20.0, 30.0]]]).expand(B, 2, 2)
    batch = {"image": torch.rand((B, H, W, 1)), "kpts": kpts,
             "kpts_mask": torch.ones((B, 2), dtype=torch.bool),
             "image_warp": torch.rand((B, H, W, 1)), "depth": depth,
             "intrinsics": K, "rotation": R, "translation": t,
             "rotation_warp": R, "translation_warp": t}
    data = pipeline.prepare_nerf_batch(batch)
    assert torch.equal(data["warp"]["kpts_heatmap"],
                       data["raw"]["kpts_heatmap"])
    assert int(data["raw"]["kpts_heatmap"].sum()) == 2 * B
    assert data["raw"]["depth"] is depth and data["intrinsics"] is K
    assert data["warp"]["image"] is batch["image_warp"]


def test_descriptor_loss_config_from_dict():
    d = {"descriptor_dim": [128, 256], "grid_size": 8, "lambda_d": 250,
         "normalise_descriptors": True}
    assert dataclasses.asdict(tl.DescriptorLossConfig.from_dict(d)) == \
        dataclasses.asdict(jl.DescriptorLossConfig.from_dict(d))
