"""``geometry/reprojection.py`` of the port against
``spnerf_tpu.geometry.reprojection`` on the CPU, and against the
procedural scene's analytic geometry (``chip_smoke.box_room``).

Tolerances: the robust depth lookup and the float -> int32 conversion
are equal; ``warp_points_nerf`` within 2e-3 px of JAX at 48 x 64 (two
float32 3 x 3 LU inverses and the products in another order; measured
under 1e-4 px), and within 1e-3 px of the analytic projection at 64 x 80
away from depth edges (float32 geometry and depth; measured 7e-6 px).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.geometry import reprojection as jr
from spnerf_tpu_torch.geometry import reprojection as tr

ROOT = Path(__file__).resolve().parents[1]
WARP_PX_TOL = 2e-3
SCENE_PX_TOL = 1e-3


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rot(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    i, j = [a for a in range(3) if a != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _cameras(rng, B):
    R = np.stack([_rot(1, a) @ _rot(0, b) for a, b in
                  rng.uniform(-0.3, 0.3, (B, 2))]).astype(np.float32)
    Rw = np.stack([_rot(1, a) @ _rot(2, b) for a, b in
                   rng.uniform(-0.3, 0.3, (B, 2))]).astype(np.float32)
    t = rng.normal(0, 0.2, (B, 3, 1)).astype(np.float32)
    tw = rng.normal(0, 0.2, (B, 3, 1)).astype(np.float32)
    return R, t, Rw, tw


def _depth_with_edges(rng, B, H, W):
    depth = rng.uniform(2.0, 2.02, (B, H, W)).astype(np.float32)
    depth[:, H // 4:H // 2, W // 4:W // 2] += 1.5  # a box in front
    depth[:, :, -W // 5:] = 4.0
    depth[0, 5, 7] = 2.5  # a lone spike: an edge to its 5 x 5 neighbours
    return depth


def _points(rng, N, H, W):
    pts = rng.uniform(0, [H, W], (N, 2)).astype(np.float32)
    # the border test is asymmetric: <= 2 and >= H - 2
    pts[:8] = [[0, 0], [2.9, 30], [3.0, 30], [H - 2.0, 20], [H - 2.1, 20],
               [20, W - 2.0], [20, W - 3.5], [5.5, 7.2]]
    return pts


def test_float_to_int32_is_xla():
    x = np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 2.0 ** 31,
                  -(2.0 ** 31), 2.0 ** 31 - 128, 2.7, -2.7, -0.5, 0.0],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = tr.float_to_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == 2 ** 31 - 1 and got[2] == -(2 ** 31)
    np.testing.assert_array_equal(
        tr.floor_int32(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32)))


def test_camera_helpers_equal_jax():
    # f within a float32 ulp: the reference takes tan in float32 (XLA's),
    # the port in float64 rounded once
    for shape, fov in (((48, 64), 44.0), ((480, 640), 60.0), ((31, 45), 20)):
        np.testing.assert_allclose(
            tr.intrinsics_from_fov(shape, fov).numpy(),
            np.asarray(jr.intrinsics_from_fov(shape, fov)), rtol=2.4e-7,
            atol=0)
    T = np.random.default_rng(0).normal(size=(3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.nerfstudio_to_cv(torch.from_numpy(T)).numpy(),
        np.asarray(jr.nerfstudio_to_cv(jnp.asarray(T))))
    R, t = tr.rotation_translation(torch.from_numpy(T))
    assert R.shape == (3, 3, 3) and t.shape == (3, 3, 1)
    np.testing.assert_array_equal(t.numpy(), T[:, :3, 3:4])


@pytest.mark.parametrize("batched_points", [False, True],
                         ids=["shared", "per-sample"])
def test_robust_depth_lookup_equals_jax(batched_points):
    rng = np.random.default_rng(1)
    B, H, W, N = 2, 48, 64, 300
    depth = _depth_with_edges(rng, B, H, W)
    if batched_points:
        pts = np.stack([_points(rng, N, H, W) for _ in range(B)])
        want = jax.vmap(jr.robust_depth_lookup)(
            jnp.asarray(depth)[:, None], jnp.asarray(pts))[:, 0]
    else:
        pts = _points(rng, N, H, W)
        want = jr.robust_depth_lookup(jnp.asarray(depth), jnp.asarray(pts))
    got = tr.robust_depth_lookup(torch.from_numpy(depth),
                                 torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the planted edges take the patch minimum somewhere, the centre elsewhere
    centre = depth[np.arange(B)[:, None],
                   np.floor(pts[..., 0]).astype(int).clip(0, H - 1),
                   np.floor(pts[..., 1]).astype(int).clip(0, W - 1)]
    assert 0 < (got.numpy() != centre).mean() < 0.5


@pytest.mark.parametrize("batched_points", [False, True],
                         ids=["shared", "per-sample"])
def test_warp_points_nerf_against_jax(batched_points):
    rng = np.random.default_rng(2)
    B, H, W, N = 2, 48, 64, 300
    depth = _depth_with_edges(rng, B, H, W)
    K = np.stack([np.asarray(jr.intrinsics_from_fov((H, W), 44.0))] * B)
    cams = _cameras(rng, B)
    args = [depth, K, cams[0], cams[1], cams[2], cams[3]]
    if batched_points:
        pts = np.stack([_points(rng, N, H, W) for _ in range(B)])
        one = lambda p, d, k, r, t, rw, tw: jr.warp_points_nerf(  # noqa: E731
            p, d[None], k[None], r[None], t[None], rw[None], tw[None])[0]
        want = jax.vmap(one)(jnp.asarray(pts), *map(jnp.asarray, args))
    else:
        pts = _points(rng, N, H, W)
        want = jr.warp_points_nerf(jnp.asarray(pts), *map(jnp.asarray, args))
    got = tr.warp_points_nerf(torch.from_numpy(pts),
                              *map(torch.from_numpy, args))
    assert got.shape == (B, N, 2) and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(want - pts).max() > 1.0  # the cameras move the points
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_PX_TOL)


def test_warp_points_nerf_identity_and_translation():
    """The reference package's own cases: the same camera maps a point to
    itself; a sideways move of the camera by b shifts x by -f b / depth."""
    H, W = 32, 32
    K = torch.tensor([[[20.0, 0, 16.0], [0, 20.0, 16.0], [0, 0, 1.0]]])
    depth = torch.full((1, H, W), 2.0)
    pts = torch.tensor([[10.0, 12.0], [20.0, 5.0]])
    eye, zero = torch.eye(3)[None], torch.zeros((1, 3, 1))
    same = tr.warp_points_nerf(pts, depth, K, eye, zero, eye, zero)[0]
    torch.testing.assert_close(same, pts, rtol=0, atol=1e-5)
    moved = tr.warp_points_nerf(pts, depth, K, eye, zero, eye,
                                torch.tensor([[[0.1], [0.0], [0.0]]]))[0]
    # along-ray depth 2 at the point: z = 2 / |K^-1 (x, y, 1)|
    ray = torch.stack([(pts[:, 1] - 16) / 20, (pts[:, 0] - 16) / 20,
                       torch.ones(2)], -1)
    z = 2.0 / ray.norm(dim=-1)
    torch.testing.assert_close(moved[:, 1], pts[:, 1] - 20 * 0.1 / z,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(moved[:, 0], pts[:, 0], rtol=0, atol=1e-4)


def test_procedural_scene_is_exact():
    """``chip_smoke.box_room``: warp_points_nerf lands on the analytic
    projection of each pixel's hit point, away from depth edges."""
    smoke = chip_smoke()
    shape = (64, 80)
    scene = smoke.box_room(0, shape=shape)
    assert scene["rgb"].shape == (20, 64, 80, 1)
    assert 0.0 <= scene["rgb"].min() and scene["rgb"].max() <= 1.0
    assert len(np.unique(scene["rgb"])) > 50  # shapes on every wall
    K = torch.from_numpy(smoke.camera_intrinsics(shape, smoke.NERF_FOV))[None]
    P = torch.from_numpy(scene["poses"])
    checked = 0
    # at 64 x 80 a pixel spans much depth: some frames have no pixel away
    # from the depth edges at all
    for src in range(15):
        pts, truth = smoke.reprojection_truth(scene, src, src + 1, 200, 1,
                                              shape)
        if not len(pts):
            continue
        dst = src + 1
        got = tr.warp_points_nerf(
            torch.from_numpy(pts), torch.from_numpy(scene["depth"][src:src + 1]),
            K, P[src:src + 1, :3, :3], P[src:src + 1, :3, 3:4],
            P[dst:dst + 1, :3, :3], P[dst:dst + 1, :3, 3:4])[0].numpy()
        np.testing.assert_allclose(got, truth, rtol=0, atol=SCENE_PX_TOL)
        assert np.abs(truth - pts).max() > 0.5
        checked += len(pts)
    assert checked >= 1000
