"""The port's NeRF model (``spnerf_tpu_torch/models/nerf.py``) against
``spnerf_tpu/models/nerf.py`` on the CPU, at a small config (depth 4,
width 32, skip 2, 4 and 2 frequencies, 8 + 8 samples).

Both sides take the same inputs, JAX's weights (``nerf_from_jax``) and
JAX's uniform draws, split as the reference splits its keys.

Tolerances. The encoding's arguments (``x @ E``, ``o@E + (d@E) t`` with
XLA's fused multiply-add, the stratified samples) are equal; after the
sines within 1.2e-7 (XLA's and torch's float32 sin are each within an ulp
of the truth). Weights, composites and float32 fields within 1e-6 of
their scale (sums in another order); depth within 2e-5. ``sample_pdf``'s
bins: the two cdfs (cumsum and normalization in another order) differ by
ulps, and a draw within ulps of an edge may take the neighbouring bin:
measured 0 of 4,096 draws here, allowed 0.1%; where the bins agree the
samples are within 2e-4 (measured 7.8e-5: the cdfs' ulps over a bin's
small probability, with weights drawn as u^4). bf16 fields within 2 bf16
ulps (the dot's float32 sums in another order, sigmoid's rounding), bf16
renders within 5e-3 of rgb and 1e-3 of depth. At full width (8 x 256,
64 + 128 samples) the renders as ``RENDER_TOL`` states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.models import nerf as jn
from spnerf_tpu_torch.models import nerf as tn
from spnerf_tpu_torch.tasks.nerf_task import pose_orbit
from spnerf_tpu_torch.tools.import_jax_weights import nerf_from_jax

# the first vectorized sin of a process beside JAX's threads has come back
# wrong in one thread's share of the elements (seen once in a few runs);
# every later call is right
torch.sin(torch.zeros(1 << 18))

SMALL = dict(depth=4, width=32, skip_layer=2, pos_freqs=4, dir_freqs=2,
             n_coarse=8, n_fine=8)
RNG_SEED = 0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _configs(dtype="float32"):
    jcfg = jn.NeRFConfig(**SMALL, compute_dtype=dtype)
    return jcfg, tn.NeRFConfig(**SMALL, compute_dtype=dtype)


def _models(dtype="float32", seed=0):
    jcfg, tcfg = _configs(dtype)
    model, variables = jn.init_nerf(jax.random.PRNGKey(seed), jcfg)
    port = nerf_from_jax(jax.tree.map(np.asarray, variables), tcfg,
                         device="cpu")
    return model, variables, port, jcfg, tcfg


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def ray_draws(key, n, cfg):
    """render_rays' draws under ``key``: (u_coarse, u_fine)."""
    k_strat, k_fine = jax.random.split(key)
    return (_t(jax.random.uniform(k_strat, (n, cfg.n_coarse))),
            _t(jax.random.uniform(k_fine, (n, cfg.n_fine))))


def image_draws(key, n_rays, chunk, cfg):
    """render_image's per-chunk draws under ``key``."""
    n_chunks = -(-n_rays // chunk)
    return [ray_draws(k, chunk, cfg)
            for k in jax.random.split(key, n_chunks)]


@pytest.mark.parametrize("F", [4, 10])
def test_encoding_matches_jax(F):
    rng = np.random.default_rng(RNG_SEED)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    t = rng.uniform(2, 6, (64, 16)).astype(np.float32)
    E = jnp.asarray(jn._expand_matrix(3, F))
    assert np.array_equal(tn._expand_matrix(3, F), np.asarray(E))
    want_args = jax.jit(lambda o, d, t: (o @ E)[:, None, :]
                        + (d @ E)[:, None, :] * t[..., None])(o, d, t)
    got_args = tn.ray_point_arguments(_t(o), _t(d), _t(t), F)
    assert np.array_equal(got_args.numpy(), np.asarray(want_args))
    want = jax.jit(lambda o, d, t: jn.encode_ray_points(o, d, t, F))(o, d, t)
    got = tn.encode_ray_points(_t(o), _t(d), _t(t), F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1.2e-7)
    want = jax.jit(lambda x: jn.positional_encoding(x, F))(o)
    got = tn.positional_encoding(_t(o), F)
    assert got.shape == (64, 3 + 6 * F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1.2e-7)


def test_weights_and_composite_match_jax():
    rng = np.random.default_rng(RNG_SEED + 1)
    sigma = rng.uniform(-1, 5, (64, 16)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (64, 16)).astype(np.float32), -1)
    rgb = rng.uniform(0, 1, (64, 16, 3)).astype(np.float32)
    want_w = np.asarray(jax.jit(jn.render_weights)(sigma, t))
    got_w = tn.render_weights(_t(sigma), _t(t)).numpy()
    np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-6)
    for white in (False, True):
        want = jax.jit(jn.composite, static_argnums=3)(want_w, rgb, t, white)
        got = tn.composite(_t(want_w), _t(rgb), _t(t), white)
        for g, w, tol in zip(got, want, (1e-6, 2e-5, 1e-6)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=tol)


def test_samplers_match_jax():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jn.stratified_samples(key, 16, 2.0, 6.0, (256,)))
    u = _t(jax.random.uniform(key, (256, 16)))
    got = tn.stratified_samples(16, 2.0, 6.0, (256,), u=u).numpy()
    assert np.array_equal(got, want)

    rng = np.random.default_rng(RNG_SEED + 2)
    weights = rng.uniform(0, 1, (256, 15)).astype(np.float32) ** 4
    t = want
    edges = np.concatenate([t[:, :1], 0.5 * (t[:, 1:] + t[:, :-1]),
                            t[:, -1:]], -1)
    k_fine = jax.random.PRNGKey(5)
    want = np.asarray(jn.sample_pdf(k_fine, edges, weights, 16))
    u = _t(jax.random.uniform(k_fine, (256, 16)))
    got = tn.sample_pdf(_t(edges), _t(weights), 16, u=u).numpy()
    # the bins each side picks, from its own cdf
    jcdf = np.asarray(jax.jit(lambda w: jnp.concatenate(
        [jnp.zeros_like(w[..., :1]),
         jnp.cumsum((w + 1e-5) / (w + 1e-5).sum(-1, keepdims=True), -1)],
        -1))(weights))
    want_idx = (u.numpy()[..., :, None] >= jcdf[..., None, :]).sum(-1)
    got_idx = torch.searchsorted(tn.pdf_cdf(_t(weights)), u,
                                 right=True).numpy()
    flipped = got_idx != want_idx
    assert flipped.mean() <= 1e-3, flipped.mean()
    np.testing.assert_allclose(got[~flipped], want[~flipped], rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_matches_jax(dtype):
    """The fine MLP on encodings, the coarse one through ``query``."""
    model, variables, port, *_ = _models(dtype)
    rng = np.random.default_rng(RNG_SEED + 3)
    pos_enc = rng.standard_normal((500, 27)).astype(np.float32)
    dir_enc = rng.standard_normal((500, 15)).astype(np.float32)
    positions = rng.uniform(-1, 1, (20, 6, 3)).astype(np.float32)
    dirs, _ = _rays(20, 7)
    want = jax.jit(lambda v: (
        model.apply(v, pos_enc, dir_enc, "fine", method=jn.NeRF.encoded),
        model.apply(v, positions, dirs, "coarse")))(variables)
    with torch.no_grad():
        got = (port.encoded(_t(pos_enc), _t(dir_enc), "fine"),
               port(_t(positions), _t(dirs), "coarse"))
    for g, w in zip(sum(got, ()), sum(want, ())):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
        else:  # 2 bf16 ulps of the value
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -8)))
                          - 7)
            assert (np.abs(g.numpy() - w) <= 2 * ulp).all()


# render tolerances (rgb, acc, depth) by config and dtype. At full width
# (NeRFConfig(), near 0.5, far 4.5) the fine samples are ill-conditioned:
# t = (u - cdf_b) / (cdf_a - cdf_b) in a bin of weight ~1e-5 moves by up
# to 5e-5 when the cdfs differ by ulps (measured card against CPU on
# identical inputs), and at 2^9 |x| that turns the top frequency by 0.026
# rad. Measured on 512 rays, JAX against the port: float32 rgb 6.0e-6,
# acc 1.1e-5, depth 2.3e-4; bf16 rgb 2.7e-3, acc 7.6e-4, depth 9.1e-3.
# The card against the CPU (H100, chip_smoke.py's [nerf-scene-small]):
# float32 rgb 2.8e-4, acc 5.2e-4, depth 8.7e-4; bf16 rgb 2.5e-3, acc
# 4.4e-3, depth 1.4e-2
RENDER_TOL = {("small", "float32"): (1e-6, 1e-6, 2e-5),
              ("small", "bfloat16"): (5e-3, 1e-6, 1e-3),
              ("full", "float32"): (1e-3, 2e-3, 5e-3),
              ("full", "bfloat16"): (1e-2, 1e-2, 3e-2)}


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_rays_matches_jax(dtype, width):
    if width == "small":
        model, variables, port, jcfg, tcfg = _models(dtype)
        n = 300
    else:
        jcfg = jn.NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
        tcfg = tn.NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
        model, variables = jn.init_nerf(jax.random.PRNGKey(0), jcfg)
        port = nerf_from_jax(jax.tree.map(np.asarray, variables), tcfg,
                             device="cpu")
        n = 64
    o, d = _rays(n, 11)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda v: jn.render_rays(model, v, key, o, d, jcfg))(
        variables)
    with torch.no_grad():
        got = tn.render_rays(port, _t(o), _t(d), tcfg,
                             draws=ray_draws(key, n, tcfg))
    tol = dict(zip(("rgb", "acc", "depth"), RENDER_TOL[width, dtype]))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=tol[k.split("_")[0]], err_msg=k)


def test_render_image_matches_jax():
    """12 x 16 = 192 rays in chunks of 50: the last chunk padded."""
    model, variables, port, jcfg, tcfg = _models("float32", seed=2)
    K = np.array([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
    c2w = pose_orbit(4, radius=1.0)[1]
    key = jax.random.PRNGKey(2)
    want = jn.render_image(model, variables, key, (12, 16), jnp.asarray(K),
                           jnp.asarray(c2w), jcfg, chunk=50)
    got = tn.render_image(port, (12, 16), K, c2w, tcfg, chunk=50,
                          draws=image_draws(key, 192, 50, tcfg),
                          device="cpu")
    assert got["rgb"].shape == (12, 16, 3) and got["depth"].shape == (12, 16)
    for k, tol in (("rgb", 1e-6), ("acc", 1e-6), ("depth", 2e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)
    # drawn from a generator instead: seeded, repeatable
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    a = tn.render_image(port, (12, 16), K, c2w, tcfg, chunk=50,
                        generator=gen(), device="cpu")
    b = tn.render_image(port, (12, 16), K, c2w, tcfg, chunk=50,
                        generator=gen(), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_nerf_is_flax_shaped():
    """Every parameter of the port's init has the flax tree's shape
    (transposed kernels), zero biases and the truncated LeCun spread."""
    _, variables = jn.init_nerf(jax.random.PRNGKey(0), _configs()[0])
    port = tn.init_nerf(0, _configs()[1], device="cpu")
    mirror = nerf_from_jax(jax.tree.map(np.asarray, variables),
                           _configs()[1], device="cpu")
    for (name, p), (_, q) in zip(port.named_parameters(),
                                 mirror.named_parameters()):
        assert p.shape == q.shape, name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            bound = 2 / 0.87962566103423978 / np.sqrt(p.shape[1])
            assert float(p.detach().abs().max()) <= bound + 1e-7, name
    again = tn.init_nerf(0, _configs()[1], device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(port.parameters(),
                                                 again.parameters()))


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tn.init_nerf(0, _configs()[1])
    port = tn.init_nerf(0, _configs()[1], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tn.render_image(port, (4, 4), np.eye(3, dtype=np.float32),
                        np.eye(4, dtype=np.float32), _configs()[1])
