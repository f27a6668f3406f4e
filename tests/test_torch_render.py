"""The port's tiny-NeRF field and fused renderer against the JAX package.

Inputs are made from a numpy seed and fed to both sides; weights cross
through ``tools.import_jax_weights.tiny_field_from_jax``. The Pallas
kernels run in interpret mode, as ``tests/test_fused_render.py`` runs them;
on CPU tensors the port's wrappers run their plain versions.

Tolerances. The port takes the sine of each sample's argument directly,
the Pallas kernels rotate by the angle-addition recurrence from the
chunk's first sample, so the two differ by the recurrence's rounding: rgb
within 5e-5 and depth within 5e-4 (measured 2.7e-5 and 3.3e-4, of depths
up to 6), where the JAX
package's own tests hold its kernel to 2e-3 and 5e-3 against
``render_xla``. With bf16 weights such a difference can land on the other
side of a rounding of a hidden activation: 2e-3 and 5e-3. int8: an encoding
or a requantization one step apart, 1e-2 and 3e-2 (the JAX package's test
holds 2.5e-2 and 6e-2 against the float reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.kernels import render_pallas as jrp
from spnerf_tpu.models import fused_tiny_nerf as jft
from spnerf_tpu_torch.kernels import render as trk
from spnerf_tpu_torch.models import fused_tiny_nerf as tft
from spnerf_tpu_torch.tools.import_jax_weights import tiny_field_from_jax

RGB_TOL, DEPTH_TOL = 5e-5, 5e-4
BF16_TOL = (2e-3, 5e-3)
INT8_TOL = (1e-2, 3e-2)


def _field(width, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((width, width)) * scale).astype(np.float32)
            for k in ("w1", "w2", "w3", "wd")}


def _rays(n=40, seed=1, origin_scale=0.1):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.standard_normal((n, 3)) * origin_scale).astype(np.float32)
    return o, d


def _both(width, n_samples, params=None, rays=None):
    """(JAX config, params, encoding; the port's; rays)."""
    params = _field(width) if params is None else params
    o, d = _rays() if rays is None else rays
    jcfg = jft.TinyFieldConfig(n_samples=n_samples, width=width)
    tcfg = tft.TinyFieldConfig(n_samples=n_samples, width=width)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tiny_field_from_jax(params, device="cpu")
    return jcfg, jp, tcfg, tp, o, d


def _encoded(cfg, params, o, d, side):
    mod = jft if side == "jax" else tft
    A, c = mod.make_encoding(cfg)
    conv = jnp.asarray if side == "jax" else torch.from_numpy
    oe, de = mod.encode_rays(conv(o), conv(d), A, c)
    return oe, de, mod.direction_features(params, conv(d), A, c)


def _close(got, want, rgb_tol=RGB_TOL, depth_tol=DEPTH_TOL):
    rgb, depth = (got["rgb"], got["depth"]) if isinstance(got, dict) else got
    wrgb, wdepth = (want["rgb"], want["depth"]) if isinstance(want, dict) \
        else want
    np.testing.assert_allclose(rgb.numpy(), np.asarray(wrgb), atol=rgb_tol,
                               rtol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(wdepth),
                               atol=depth_tol, rtol=0)
    assert float(np.asarray(wrgb).max()) > 0.05  # not an empty render


@pytest.mark.parametrize("width", [128, 64, 32])
def test_make_encoding_equal_to_the_bit(width):
    A, c = tft.make_encoding(tft.TinyFieldConfig(width=width))
    Aj, cj = jft.make_encoding(jft.TinyFieldConfig(width=width))
    assert A.dtype == c.dtype == np.float32
    assert np.array_equal(A, np.asarray(Aj))
    assert np.array_equal(c, np.asarray(cj))


@pytest.mark.parametrize("width", [128, 64, 32])
def test_encodings_and_reference_renderer_match_jax(width):
    """encode_rays is exact on both sides (one non-zero power-of-two
    frequency per column); direction_features and the per-sample reference
    renderer differ by the order of float32 sums: rtol 1e-5 of the largest
    value."""
    jcfg, jp, tcfg, tp, o, d = _both(width, 16)
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    assert np.array_equal(toe.numpy(), np.asarray(joe))
    assert np.array_equal(tde.numpy(), np.asarray(jde))
    np.testing.assert_allclose(tdf.numpy(), np.asarray(jdf), rtol=0,
                               atol=1e-5 * float(np.abs(jdf).max()))
    want = jft.render_xla(jp, joe, jde, jcfg, df=jdf)
    got = tft.render_reference(tp, toe, tde, tcfg, df=tdf)
    for key in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want[key]).max())))


@pytest.mark.parametrize("case", ["one_chunk", "several_chunks", "ragged_block",
                                  "flags", "bf16", "bf16_flags"])
def test_render_fused_matches_pallas(case):
    n_samples, s_chunk, block = {"one_chunk": (8, 8, 512),
                                 "several_chunks": (16, 4, 512),
                                 "ragged_block": (16, 4, 16),
                                 "flags": (16, 4, 16),
                                 "bf16": (16, 4, 512),
                                 "bf16_flags": (16, 2, 16)}[case]
    jcfg, jp, tcfg, tp, o, d = _both(128, n_samples)
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    tol = (RGB_TOL, DEPTH_TOL)
    if case.startswith("bf16"):
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
        tol = BF16_TOL
    flags = None
    if case.endswith("flags"):
        rng = np.random.default_rng(3)
        flags = (rng.uniform(size=(3, n_samples // s_chunk)) > 0.4).astype(
            np.int32)
        assert 0 < flags.sum() < flags.size
    kw = dict(jitter=0.37, n_samples=n_samples, near=2.0, far=6.0,
              block=block, s_chunk=s_chunk, early_stop_eps=0.0)
    want = jrp.render_fused(
        joe, jde, jp["w1"], jp["w2"], jp["w3"], jdf, interpret=True,
        flags=None if flags is None else jnp.asarray(flags), **kw)
    got = trk.render_fused(
        toe, tde, tp["w1"], tp["w2"], tp["w3"], tdf,
        flags=None if flags is None else torch.from_numpy(flags), **kw)
    assert got[0].shape == (40, 3) and got[1].shape == (40,)
    _close(got, want, *tol)


def _hot(params):
    hot = dict(params)
    hot["w3"] = params["w3"].copy()
    hot["w3"][:, 0] = np.abs(params["w3"][:, 0]) * 50.0 + 2.0
    return hot


def test_early_stop_matches_dense_and_pallas():
    """On a dense field rays saturate after the first chunks: the early
    stop changes outputs by at most about eps (the JAX package's own test
    holds 3e-3 and 2e-2), and agrees with the Pallas kernel's, whose tile
    is ``block`` = 8 rays where the port's is 64."""
    jcfg, jp, tcfg, tp, o, d = _both(128, 16, params=_hot(_field(128)))
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    kw = dict(n_samples=16, near=2.0, far=6.0, block=8, s_chunk=4)
    ws = [tp[k] for k in ("w1", "w2", "w3")]
    dense = trk.render_fused(toe, tde, *ws, tdf, early_stop_eps=0.0, **kw)
    fast = trk.render_fused(toe, tde, *ws, tdf, early_stop_eps=1e-3, **kw)
    _close(fast, dense, 3e-3, 2e-2)
    head = trk.float_mlp_head(*ws, False)
    counted = dict(width=128, n_samples=16, chunk=4, near=2.0, far=6.0,
                   jitter=0.5, block=8, flags=None, packed=False)
    n_fast = trk.render_plain_counted(toe, tde, tdf, head,
                                      early_stop_eps=1e-3, **counted)[2]
    n_dense = trk.render_plain_counted(toe, tde, tdf, head,
                                       early_stop_eps=0.0, **counted)[2]
    assert n_fast < n_dense == 40 * 16  # chunks really were skipped
    want = jrp.render_fused(joe, jde, jp["w1"], jp["w2"], jp["w3"], jdf,
                            interpret=True, early_stop_eps=1e-3, **kw)
    _close(fast, want, 2e-3, 1e-2)


@pytest.mark.parametrize("width,s_chunk", [(64, 4), (64, 2), (32, 2)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_render_fused_packed_matches_pallas(width, s_chunk, dtype):
    jcfg, jp, tcfg, tp, o, d = _both(width, 16)
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    tol = (RGB_TOL, DEPTH_TOL)
    if dtype == "bf16":
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
        tol = BF16_TOL
        if width == 32:
            # a narrow field keeps 5 frequencies, so the recurrence and the
            # direct sine agree and no rounding lands on the other side
            # (7.5e-8 and 5.4e-7 measured): this pins every rounding to
            # bf16; leaving out the encoding's, either hidden layer's or
            # the head's moves rgb by 1.2e-4 to 2.8e-4
            tol = (2e-5, 1e-4)
    kw = dict(jitter=0.37, width=width, n_samples=16, near=2.0, far=6.0,
              block=512, s_chunk=s_chunk, early_stop_eps=0.0)
    want = jrp.render_fused_packed(joe, jde, jp["w1"], jp["w2"], jp["w3"],
                                   jdf, interpret=True, **kw)
    got = trk.render_fused_packed(toe, tde, tp["w1"], tp["w2"], tp["w3"],
                                  tdf, **kw)
    _close(got, want, *tol)


def test_packed_early_stop_matches_dense_and_pallas():
    params = _field(64, seed=5)
    params["w3"][:, 0] += 2.0  # a hot field: rays saturate early
    o, d = _rays(24, seed=6, origin_scale=0.0)
    jcfg, jp, tcfg, tp, o, d = _both(64, 16, params=params, rays=(o, d))
    kw = dict(block=8, s_chunk=2)
    dense = tft.render_fused_rays_packed(tp, o, d, tcfg, early_stop_eps=0.0,
                                         device="cpu", **kw)
    fast = tft.render_fused_rays_packed(tp, o, d, tcfg, early_stop_eps=1e-3,
                                        device="cpu", **kw)
    _close(fast, dense, 3e-3, 2e-2)
    want = jft.render_fused_rays_packed(jp, jnp.asarray(o), jnp.asarray(d),
                                        jcfg, interpret=True,
                                        early_stop_eps=1e-3, **kw)
    _close(fast, want, 2e-3, 1e-2)


def test_quantize_field_equal_to_jax():
    """numpy on both sides, the same operations: every array equal."""
    jcfg, jp, tcfg, tp, o, d = _both(128, 8)
    oe, de, df = (np.asarray(t) for t in _encoded(jcfg, jp, o, d, "jax"))
    params = {k: np.asarray(v) for k, v in jp.items()}
    kw = dict(n_samples=8, near=2.0, far=6.0, jitter=0.37)
    want = jrp.quantize_field(params, oe, de, df, **kw)
    got = trk.quantize_field(params, oe, de, df, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        assert np.array_equal(got[key], value), key


@pytest.mark.parametrize("case", ["dense", "flags"])
def test_render_fused_int8_matches_pallas(case):
    jcfg, jp, tcfg, tp, o, d = _both(128, 8)
    joe, jde, jdf = _encoded(jcfg, jp, o, d, "jax")
    toe, tde, tdf = _encoded(tcfg, tp, o, d, "torch")
    qf = trk.quantize_field({k: np.asarray(v) for k, v in jp.items()},
                            np.asarray(joe), np.asarray(jde), np.asarray(jdf),
                            n_samples=8, near=2.0, far=6.0)
    flags = None
    if case == "flags":
        flags = np.array([[1, 0], [1, 1], [0, 1], [1, 1], [0, 0]], np.int32)
    kw = dict(n_samples=8, near=2.0, far=6.0, block=8, s_chunk=4,
              early_stop_eps=0.0)
    want = jrp.render_fused_int8(
        joe, jde, qf, jdf, interpret=True,
        flags=None if flags is None else jnp.asarray(flags), **kw)
    got = trk.render_fused_int8(
        toe, tde, qf, tdf,
        flags=None if flags is None else torch.from_numpy(flags), **kw)
    _close(got, want, *INT8_TOL)
    # and the float reference, as the JAX package's own test holds it
    ref = jft.render_xla(jp, joe, jde, jcfg, df=jdf)
    if flags is None:
        _close(got, ref, 2.5e-2, 6e-2)


def test_render_fused_rays_with_occupancy_matches_jax():
    """The slice as a whole on the committed sphere field (float32
    weights) and rays of its scene: encode, flags from the field's own
    occupancy volume (some 0, some 1), fused render."""
    from spnerf_tpu.ops import occupancy as jocc
    from spnerf_tpu_torch.ops import occupancy as tocc

    o, d, _ = _sphere_rays(96, 7)
    jcfg, jp, tcfg, tp, o, d = _both(128, 32, params=_sphere_field(128),
                                     rays=(o, d))
    # a probe within float32 rounding of the threshold may fall on either
    # side: at most 10 of 32,768 cells (0 measured); both sides then render
    # with the port's volume, so that they skip the same chunks
    dt = 4.0 / 32
    jgrid = jocc.occupancy_grid(
        jocc.field_sigma_grid(jp, jcfg, resolution=32), dt)
    tgrid = tocc.occupancy_grid(
        tocc.field_sigma_grid(tp, tcfg, resolution=32), dt)
    assert int((tgrid.numpy() != np.asarray(jgrid)).sum()) <= 10
    tivol = tocc.field_integral_volume(tp, tcfg, resolution=32)
    assert torch.equal(tivol, tocc.integral_volume(tgrid))
    # rays aimed at the sphere cross its dilated cells in all but the first
    # and last chunks, so only flags as fine as a ray x 2 samples hold zeros
    kw = dict(block=1, s_chunk=2)
    flags = tocc.chunk_flags(torch.from_numpy(o), torch.from_numpy(d), tivol,
                             n_samples=32, near=2.0, far=6.0, extent=6.0, **kw)
    assert 0 < int(flags.sum()) < flags.numel()
    want = jft.render_fused_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg,
                                 occupancy_ivol=jnp.asarray(tivol.numpy()),
                                 interpret=True, **kw)
    got = tft.render_fused_rays(tp, o, d, tcfg, occupancy_ivol=tivol,
                                device="cpu", **kw)
    # at this scene's arguments (up to 8e4 rad, one float32 ulp 8e-3) the
    # Pallas kernel's recurrence and the direct sine are further apart than
    # on the small random fields above: 5.9e-4 of rgb and 3.9e-3 of depth
    # measured (the JAX package holds its kernel to 2e-3 and 5e-3 against
    # its float reference)
    _close(got, want, 2e-3, 1e-2)
    dense = tft.render_fused_rays(tp, o, d, tcfg, device="cpu", **kw)
    _close(got, dense, 5e-3, 5e-2)  # skipping is lossless, as the JAX test


def _sphere_rays(n, seed):
    """The analytic scene of benchmarks/nerf_quality_sphere.py from a numpy
    seed: (origins, directions, rgb)."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = 0.25 * rng.standard_normal((n, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = np.sum(o * d, axis=-1)
    disc = b * b - (np.sum(o * o, axis=-1) - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    t = np.where((disc > 0) & (t > 2.0) & (t < 6.0), t, 6.0)
    p = o + t[:, None] * d
    rgb = np.where((t < 6.0)[:, None], 0.5 * p + 0.5, 0.0)
    return o, d.astype(np.float32), rgb.astype(np.float32)


def _sphere_field(width):
    from pathlib import Path

    name = "sphere_field.npz" if width == 128 else f"sphere_field_w{width}.npz"
    with np.load(Path(__file__).parents[1] / "benchmarks" / "data" / name) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("width", [128, 64, 32])
def test_committed_sphere_field_renders_the_sphere(width):
    """2,048 rays of the analytic sphere through each committed field, bf16
    weights as the render benchmark serves them: the port's PSNR within 0.1
    dB of the JAX package's, both above 38.5 dB."""
    params = _sphere_field(width)
    o, d, rgb = _sphere_rays(2048, 9)
    jcfg = jft.TinyFieldConfig(n_samples=32, width=width)
    tcfg = tft.TinyFieldConfig(n_samples=32, width=width)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = tiny_field_from_jax(params, device="cpu", dtype=torch.bfloat16)
    if width == 128:
        want = jft.render_fused_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg,
                                     interpret=True)
        got = tft.render_fused_rays(tp, o, d, tcfg, device="cpu")
    else:
        want = jft.render_fused_rays_packed(jp, jnp.asarray(o), jnp.asarray(d),
                                            jcfg, interpret=True)
        got = tft.render_fused_rays_packed(tp, o, d, tcfg, device="cpu")
    psnr = lambda x: -10.0 * np.log10(np.mean((np.asarray(x) - rgb) ** 2))  # noqa: E731
    p_jax, p_port = psnr(want["rgb"]), psnr(got["rgb"].numpy())
    assert p_jax > 38.5 and p_port > 38.5, (p_jax, p_port)
    assert abs(p_jax - p_port) < 0.1, (p_jax, p_port)
    _close(got, want, 5e-3, 5e-2)


def test_camera_helpers_match_jax():
    from spnerf_tpu.data import nerf_dataset as jnd
    from spnerf_tpu.models.nerf import camera_rays as jcamera_rays
    from spnerf_tpu.tasks.nerf_task import pose_orbit as jpose_orbit
    from spnerf_tpu_torch.data import nerf_dataset as tnd
    from spnerf_tpu_torch.models.nerf import camera_rays
    from spnerf_tpu_torch.tasks.nerf_task import pose_orbit

    K = tnd.camera_intrinsics((36, 48), 60.0)
    assert np.array_equal(K, jnd.camera_intrinsics((36, 48), 60.0))
    poses = pose_orbit(8, radius=4.0, height=0.4)
    assert np.array_equal(poses, jpose_orbit(8, radius=4.0, height=0.4))
    assert np.array_equal(tnd.axis_transform(poses[1]),
                          jnd.axis_transform(poses[1]))
    o, d = camera_rays((36, 48), torch.from_numpy(K),
                       torch.from_numpy(poses[3]))
    jo, jd = jcamera_rays((36, 48), jnp.asarray(K), jnp.asarray(poses[3]))
    assert o.shape == d.shape == (36 * 48, 3)
    assert np.array_equal(o.numpy(), np.asarray(jo))
    # K^-1 in float32 on both sides (LAPACK's and XLA's inverse differ by
    # an ulp in an entry) and products in another order: unit directions
    # within 2.4e-7 (measured 1.79e-7)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2.4e-7)


def test_tiny_field_overfits():
    """The differentiable reference fits a constant target (120 Adam steps,
    64 rays); the fused renderer then reproduces the fitted field."""
    cfg = tft.TinyFieldConfig(n_samples=8)
    gen = torch.Generator().manual_seed(0)
    params = tft.init_params(gen, device="cpu")
    for p in params.values():
        p.requires_grad_()
    A, c = tft.make_encoding(cfg)
    o = torch.zeros((64, 3))
    d = torch.randn((64, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    oe, de = tft.encode_rays(o, d, A, c)
    target = torch.tensor([[0.7, 0.2, 0.4]]).expand(64, 3)
    opt = torch.optim.Adam(params.values(), lr=3e-3)
    first = None
    for _ in range(120):
        opt.zero_grad()
        out = tft.render_reference(
            params, oe, de, cfg, df=tft.direction_features(params, d, A, c))
        loss = ((out["rgb"] - target) ** 2).mean()
        loss.backward()
        opt.step()
        first = float(loss.detach()) if first is None else first
    assert float(loss.detach()) < first * 0.5
    fitted = {k: v.detach() for k, v in params.items()}
    got = tft.render_fused_rays(fitted, o, d, cfg, device="cpu")
    ref = tft.render_reference(
        fitted, oe, de, cfg, df=tft.direction_features(fitted, d, A, c))
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"].numpy(),
                               atol=1e-5, rtol=0)


def test_init_params_and_import():
    a = tft.init_params(torch.Generator().manual_seed(3), width=64,
                        device="cpu")
    b = tft.init_params(torch.Generator().manual_seed(3), width=64,
                        device="cpu")
    assert set(a) == {"w1", "w2", "w3", "wd"}
    assert all(v.shape == (64, 64) and v.dtype == torch.float32
               for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 0.05 < float(a["w1"].std()) < 0.15
    field = _field(32)
    got = tiny_field_from_jax(field, device="cpu", dtype=torch.bfloat16)
    assert all(got[k].dtype == torch.bfloat16 for k in field)
    assert torch.equal(got["w2"].float(),
                       torch.from_numpy(field["w2"]).to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="dtype"):
        tiny_field_from_jax(field, device="cpu", dtype=torch.float16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tiny_field_from_jax(field)  # the card is the default


def test_wrappers_reject_what_the_kernels_do_not_take():
    jcfg, jp, tcfg, tp, o, d = _both(128, 16)
    oe, de, df = _encoded(tcfg, tp, o, d, "torch")
    ws = [tp[k] for k in ("w1", "w2", "w3")]
    with pytest.raises(ValueError, match="s_chunk|chunk"):
        trk.render_fused(oe, de, *ws, df, n_samples=16, s_chunk=5)
    with pytest.raises(ValueError, match="flags must be int32"):
        trk.render_fused(oe, de, *ws, df, n_samples=16, s_chunk=4, block=16,
                         flags=torch.ones((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trk.render_fused(oe, de, *[w.half() for w in ws], df, n_samples=16)
    with pytest.raises(ValueError, match="must be float32"):
        trk.render_fused(oe.double(), de, *ws, df, n_samples=16)
    with pytest.raises(ValueError, match="pack width"):
        trk.render_fused_packed(oe, de, *ws, df, width=128, n_samples=16)
    with pytest.raises(ValueError, match="field width"):
        trk.render_fused_packed(oe, de, *ws, df, width=64, n_samples=16)
    with pytest.raises(ValueError, match="not divisible"):
        trk.render_fused_packed(oe[:, :64].contiguous(), de[:, :64].contiguous(),
                                *[w[:64, :64].contiguous() for w in ws],
                                df[:, :64].contiguous(), width=64,
                                n_samples=16, s_chunk=3)
    assert trk.tile_rays(128) == 64 and trk.tile_rays(32) == 256
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.render_fused_rays(tp, o, d, tcfg)  # the card is the default
