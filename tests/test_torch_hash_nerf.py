"""The port's hash-grid NeRF (``spnerf_tpu_torch/models/hash_nerf.py``)
against ``spnerf_tpu/models/hash_nerf.py`` on the CPU, at a small config
(4 levels of resolution 4, 8, 16, 32 over a 2^12 table: two dense levels
and two hashed ones).

Both sides take JAX's weights (``hash_nerf_from_jax``) and, for the
render, JAX's stratified draws.

Tolerances: table rows of every corner equal (the reference's uint32 hash
written out in jnp beside the port's int64 one); the encoding within 1e-6
of its largest value, the field's sigma and rgb within 1e-6 of theirs,
the render's rgb and acc within 1e-6, depth within 2e-5 (float32 sums
and products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.models import hash_nerf as jh
from spnerf_tpu_torch.models import hash_nerf as th
from spnerf_tpu_torch.tools.import_jax_weights import hash_nerf_from_jax

torch.sin(torch.zeros(1 << 18))  # see test_torch_nerf_model.py

TINY = dict(n_levels=4, log2_table_size=12, base_resolution=4,
            max_resolution=32, mlp_width=16, geo_features=7, n_samples=16)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _models(seed=0):
    jcfg, tcfg = jh.HashNeRFConfig(**TINY), th.HashNeRFConfig(**TINY)
    model, variables = jh.init_hash_nerf(jax.random.PRNGKey(seed), jcfg)
    port = hash_nerf_from_jax(jax.tree.map(np.asarray, variables), tcfg,
                              device="cpu")
    return model, variables, port, jcfg, tcfg


def _reference_rows(x01, res, table_size):
    """The reference's per-corner table rows (its lines, in jnp)."""
    pos = x01 * res
    base = jnp.floor(pos).astype(jnp.int32)
    rows = []
    for corner in range(8):
        off = jnp.array([(corner >> 0) & 1, (corner >> 1) & 1,
                         (corner >> 2) & 1], jnp.int32)
        c = base + off
        if (res + 1) ** 3 <= table_size:
            idx = (c[:, 0] * (res + 1) + c[:, 1]) * (res + 1) + c[:, 2]
            idx = jnp.remainder(idx, table_size)
        else:
            cu = c.astype(jnp.uint32)
            idx = (cu[:, 0] * jnp.uint32(jh._PRIMES[0])
                   ^ cu[:, 1] * jnp.uint32(jh._PRIMES[1])
                   ^ cu[:, 2] * jnp.uint32(jh._PRIMES[2]))
            idx = jnp.remainder(idx, jnp.uint32(table_size)).astype(jnp.int32)
        rows.append(np.asarray(idx))
    return rows


@pytest.mark.parametrize("res,table_log2,dense", [
    (8, 12, True), (32, 12, False), (1024, 17, False), (48, 17, True)])
def test_hash_rows_equal_jax(res, table_log2, dense):
    T = 1 << table_log2
    assert ((res + 1) ** 3 <= T) == dense
    rng = np.random.default_rng(res)
    x01 = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    x01[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0]] * 2  # edges
    base = torch.floor(_t(x01) * res).long()
    for corner, want in enumerate(_reference_rows(x01, res, T)):
        got = th.corner_index(base + torch.tensor(th.corner_offsets(corner)),
                              res, T)
        assert np.array_equal(got.numpy(), want), corner


def test_resolutions_match_jax():
    for cfg in (TINY, {}):
        got = th.level_resolutions(th.HashNeRFConfig(**cfg))
        jcfg = jh.HashNeRFConfig(**cfg)
        growth = np.exp((np.log(jcfg.max_resolution)
                         - np.log(jcfg.base_resolution))
                        / max(jcfg.n_levels - 1, 1))
        assert got == [int(np.floor(jcfg.base_resolution * growth**lvl))
                       for lvl in range(jcfg.n_levels)]


def test_encoding_and_field_match_jax():
    model, variables, port, jcfg, _ = _models()
    rng = np.random.default_rng(1)
    x01 = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jh.HashGridEncoding(jcfg).apply)(
        {"params": variables["params"]["grid"]}, x01))
    got = port.grid(_t(x01)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    pos = rng.uniform(-3, 3, (50, 16, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jr = jax.jit(model.apply)(variables, pos, d)
    with torch.no_grad():
        ps, pr = port(_t(pos), _t(d))
        qs, qr = port(_t(pos), _t(d)[:, None, :].expand(50, 16, 3))
    for g, w in ((ps, js), (pr, jr), (qs, js), (qr, jr)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_render_rays_hash_matches_jax():
    model, variables, port, jcfg, tcfg = _models(seed=3)
    rng = np.random.default_rng(2)
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda v: jh.render_rays_hash(model, v, key, o, d, jcfg))(
        variables)
    with torch.no_grad():
        got = th.render_rays_hash(port, _t(o), _t(d), tcfg,
                                  u=_t(jax.random.uniform(key, (64, 16))))
    for k, tol in (("rgb", 1e-6), ("acc", 1e-6), ("depth", 2e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_init_and_training_step():
    """The port's init: the table within +-1e-4, the field seeded; one Adam
    step on the table's rows (``index_select``'s backward) lowers a loss."""
    port = th.init_hash_nerf(0, th.HashNeRFConfig(**TINY), device="cpu")
    table = port.grid.table.detach()
    assert table.abs().max() <= 1e-4 and table.std() > 4e-5
    again = th.init_hash_nerf(0, th.HashNeRFConfig(**TINY), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(port.parameters(),
                                                 again.parameters()))
    cfg = th.HashNeRFConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    o = torch.zeros(32, 3)
    d = torch.nn.functional.normalize(torch.randn(32, 3, generator=gen), dim=-1)
    target = torch.tensor([0.8, 0.3, 0.5]).expand(32, 3)
    opt = torch.optim.Adam(port.parameters(), lr=1e-2)
    losses = []
    for _ in range(20):
        opt.zero_grad()
        out = th.render_rays_hash(port, o, d, cfg, generator=gen)
        loss = torch.mean((out["rgb"] - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert port.grid.table.grad.abs().sum() > 0
    assert losses[-1] < 0.5 * losses[0], losses
