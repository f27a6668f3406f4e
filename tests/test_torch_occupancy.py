"""The port's occupancy grid and skip flags against the JAX package
(``spnerf_tpu/ops/occupancy.py``), on the same numpy inputs.

The sigma grids differ by the order of float32 sums (2e-5 of the largest
value). The sampled probe's view features take the sine of the probe
directions times frequencies up to 8,192, which turns the last bit of a
unit direction (sin and cos of angles up to 325 rad differ by an ulp
between the libraries) into 1e-3 rad: 3e-4 of the largest value (8.4e-5
measured). The occupancy grid, the integral volume and the box counts
are exact on the same input. ``chunk_flags`` computes each segment's end
points with a rounded product and a rounded sum where XLA on the CPU may
contract them; an end point within rounding of a voxel border can then
land in the next voxel, so flips are counted and bounded, not hidden: none
was measured on the rays below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.models import fused_tiny_nerf as jft
from spnerf_tpu.ops import occupancy as jocc
from spnerf_tpu_torch.models import fused_tiny_nerf as tft
from spnerf_tpu_torch.ops import occupancy as tocc
from spnerf_tpu_torch.tools.import_jax_weights import tiny_field_from_jax


def _field(width=128, seed=3, scale=0.3, sigma_shift=0.0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal((width, width)) * scale).astype(np.float32)
              for k in ("w1", "w2", "w3", "wd")}
    params["w3"][:, 0] -= sigma_shift  # lower density: part of space empties
    return ({k: jnp.asarray(v) for k, v in params.items()},
            tiny_field_from_jax(params, device="cpu"))


def test_fibonacci_sphere_matches_jax():
    got = tocc.fibonacci_sphere(32).numpy()
    np.testing.assert_allclose(got, np.asarray(jocc.fibonacci_sphere(32)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("method", ["sampled", "bound"])
@pytest.mark.parametrize("width", [128, 64])
def test_field_sigma_grid_matches_jax(method, width):
    jp, tp = _field(width)
    want = np.asarray(jocc.field_sigma_grid(
        jp, jft.TinyFieldConfig(width=width), resolution=10, method=method,
        n_dirs=8))
    got = tocc.field_sigma_grid(
        tp, tft.TinyFieldConfig(width=width), resolution=10, method=method,
        n_dirs=8).numpy()
    assert got.shape == want.shape == (10, 10, 10)
    tol = 3e-4 if method == "sampled" else 2e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_field_sigma_grid_rejects_unknown_method():
    _, tp = _field()
    with pytest.raises(ValueError, match="unknown occupancy probe"):
        tocc.field_sigma_grid(tp, tft.TinyFieldConfig(), resolution=4,
                              method="guess")


@pytest.mark.parametrize("seed", [0, 1])
def test_occupancy_grid_and_integral_volume_equal_jax(seed):
    rng = np.random.default_rng(seed)
    sigma = (rng.normal(0.0, 0.02, (12, 12, 12)) - 0.04).astype(np.float32)
    dt = 4.0 / 32
    want = jocc.occupancy_grid(jnp.asarray(sigma), dt)
    got = tocc.occupancy_grid(torch.from_numpy(sigma), dt)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()
    ivol = tocc.integral_volume(got)
    assert ivol.shape == (13, 13, 13) and ivol.dtype == torch.int32
    assert np.array_equal(ivol.numpy(), np.asarray(jocc.integral_volume(want)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_count_is_the_slice_sum(seed):
    rng = np.random.default_rng(seed)
    occ = rng.random((6, 6, 6)) > 0.6  # cubic: the reference's flat index
    ivol = tocc.integral_volume(torch.from_numpy(occ))
    lo = np.stack([rng.integers(0, s, 20) for s in occ.shape], -1)
    hi = np.stack([rng.integers(lo[:, a], s) for a, s in
                   enumerate(occ.shape)], -1)
    got = tocc._box_count(ivol, torch.from_numpy(lo), torch.from_numpy(hi))
    want = [occ[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1].sum()
            for a, b in zip(lo, hi)]
    assert got.tolist() == want
    jgot = jocc._box_count(jocc.integral_volume(jnp.asarray(occ)),
                           jnp.asarray(lo), jnp.asarray(hi))
    assert np.asarray(jgot).tolist() == want


def _orbit_like_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (0.6 * rng.standard_normal((n, 3))).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("block,s_chunk", [(64, 4), (100, 8), (512, 16)])
def test_chunk_flags_equal_jax(block, s_chunk):
    """The same rays and volume: flags equal, up to end points within
    rounding of a voxel border (at most 0.5% of flags may flip; 0
    measured)."""
    rng = np.random.default_rng(4)
    occ = np.zeros((24, 24, 24), bool)
    occ[8:16, 9:15, 10:14] = True
    occ |= rng.random(occ.shape) > 0.995
    o, d = _orbit_like_rays(1000, 5)
    kw = dict(block=block, n_samples=32, s_chunk=s_chunk, near=2.0, far=6.0,
              extent=6.0)
    want = np.asarray(jocc.chunk_flags(
        jnp.asarray(o), jnp.asarray(d),
        jocc.integral_volume(jnp.asarray(occ)), **kw))
    got = tocc.chunk_flags(torch.from_numpy(o), torch.from_numpy(d),
                           tocc.integral_volume(torch.from_numpy(occ)), **kw)
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (-(-1000 // block), 32 // s_chunk)
    flips = int((got.numpy() != want).sum())
    assert flips <= 0.005 * want.size, flips
    assert 0 < want.sum()


@pytest.mark.parametrize("case", ["hit", "miss", "mixed"])
def test_chunk_flags_per_ray_tightness(case):
    """A block mixing rays that hit an occupied core with rays that miss it
    keeps the chunks any ray needs; a block whose rays all miss skips
    every chunk."""
    occ = np.zeros((16, 16, 16), bool)
    occ[6:10, 6:10, 6:10] = True  # core at the center of [-4, 4]^3
    ivol = tocc.integral_volume(torch.from_numpy(occ))
    o_hit = np.tile(np.float32([[3.5, 0.0, 0.0]]), (4, 1))
    o_miss = np.tile(np.float32([[3.5, 3.2, 3.2]]), (4, 1))
    d = torch.from_numpy(np.tile(np.float32([[-1.0, 0.0, 0.0]]), (4, 1)))
    kw = dict(block=4, n_samples=8, s_chunk=2, near=1.0, far=3.0, extent=4.0)
    hit = tocc.chunk_flags(torch.from_numpy(o_hit), d, ivol, **kw)
    if case == "hit":
        assert 0 < int(hit.sum()) < hit.numel()  # the core's chunks only
        want = jocc.chunk_flags(jnp.asarray(o_hit), jnp.asarray(d.numpy()),
                                jnp.asarray(ivol.numpy()), **kw)
        assert np.array_equal(hit.numpy(), np.asarray(want))
    elif case == "miss":
        miss = tocc.chunk_flags(torch.from_numpy(o_miss), d, ivol, **kw)
        assert int(miss.sum()) == 0
    else:
        o_mix = np.concatenate([o_hit[:2], o_miss[:2]])
        mix = tocc.chunk_flags(torch.from_numpy(o_mix), d, ivol, **kw)
        assert torch.equal(mix, hit)


def test_rays_leaving_the_extent_count_as_occupied():
    ivol = tocc.integral_volume(torch.zeros((8, 8, 8), dtype=torch.bool))
    o = torch.tensor([[0.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    flags = tocc.chunk_flags(o, d, ivol, block=1, n_samples=8, s_chunk=2,
                             near=0.0, far=8.0, extent=4.0)
    assert flags.tolist() == [[0, 0, 1, 1]]


def test_field_integral_volume_and_render_flags_match_jax():
    """Field -> sigma grid -> occupancy -> integral volume -> flags, both
    sides: a cell whose sigma lies within float32 rounding of the threshold
    could differ (none does here)."""
    jp, tp = _field(scale=0.1, seed=0, sigma_shift=0.055)
    jcfg = jft.TinyFieldConfig(n_samples=16)
    tcfg = tft.TinyFieldConfig(n_samples=16)
    want = np.asarray(jocc.field_integral_volume(jp, jcfg, resolution=16))
    got = tocc.field_integral_volume(tp, tcfg, resolution=16)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want[-1, -1, -1] < 16 ** 3
    o, d = _orbit_like_rays(200, 6)
    jflags = jocc.build_render_flags(jp, jnp.asarray(o), jnp.asarray(d), jcfg,
                                     block=2, s_chunk=1, resolution=16)
    tflags = tocc.build_render_flags(tp, torch.from_numpy(o),
                                     torch.from_numpy(d), tcfg, block=2,
                                     s_chunk=1, resolution=16)
    assert np.array_equal(tflags.numpy(), np.asarray(jflags))
    assert 0 < int(tflags.sum()) < tflags.numel()


@pytest.mark.parametrize("method", ["bound", "sampled"])
def test_sigma_probe_covers_view_dependent_sigma(method):
    """The probe must cover sigma over view directions it did not sample
    (sigma is view-dependent: df enters before layer 2), or chunk skipping
    would drop occupied chunks: at 512 random points and directions, every
    point whose true sigma clears the alpha threshold lies in a live cell
    of the thresholded, dilated grid (up to 1%), and the provable bound
    dominates the true sigma at 95% of the points at least."""
    _, tp = _field()
    cfg = tft.TinyFieldConfig()
    A, c = tft.make_encoding(cfg)
    res, ext = 12, float(cfg.far)
    grid = tocc.field_sigma_grid(tp, cfg, resolution=res, method=method)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-ext, ext, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    df = tft.direction_features(tp, torch.from_numpy(dirs), A, c)
    enc = torch.sin(torch.from_numpy(pts) @ torch.from_numpy(A)
                    + torch.from_numpy(c))
    h = torch.relu(torch.relu(enc @ tp["w1"]) @ tp["w2"] + df)
    sigma = (h @ tp["w3"])[:, 0].numpy()
    idx = np.clip(((pts + ext) / (2 * ext) * res).astype(int), 0, res - 1)
    cell = grid.numpy()[idx[:, 0], idx[:, 1], idx[:, 2]]
    if method == "bound":
        assert float((sigma <= cell + 1e-3).mean()) >= 0.95
        sampled = tocc.field_sigma_grid(tp, cfg, resolution=res)
        assert float(sampled.mean()) < float(grid.mean())  # and is looser
    dt = 4.0 / 16
    occupied = sigma > -np.log(1.0 - 1e-3) / dt
    assert occupied.sum() > 0
    live = tocc.occupancy_grid(grid, dt).numpy()[idx[:, 0], idx[:, 1], idx[:, 2]]
    missed = occupied & ~live
    assert missed.sum() <= max(1, 0.01 * occupied.sum())
