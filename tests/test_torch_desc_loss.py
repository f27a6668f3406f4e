"""The port's blockwise descriptor hinge loss against the JAX package's
Pallas kernel (interpret mode) and its dense path, on the CPU, where the
port's wrapper runs its plain version.

Tolerances: the warped cells sit on a quarter-pixel grid, so d2 is exact
on both sides and every pair takes the same side of the radius. The three
sums are float32 sums over N x N pairs in another order: rtol 2e-5. The
inputs keep every dot at least 2e-6 from both margins (checked; the dots'
float32 rounding is some 1e-7), so that
no pair takes the other side of a step in the gradients: rtol 1e-4, atol
1e-5 of the largest entry. Against the dense JAX path,
which measures the distance with a square root: the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.kernels.descriptor_loss_pallas import descriptor_loss_pallas
from spnerf_tpu.train import losses as jl
from spnerf_tpu_torch.kernels.descriptor_loss import (
    descriptor_hinge_sums,
    descriptor_loss_blockwise,
    hinge_sums_plain,
)
from spnerf_tpu_torch.train import losses as tl

G = 8
KW = dict(grid_size=G, lambda_d=250, lambda_loss=1e-4, positive_margin=1.0,
          negative_margin=0.2)


def _case(Hc, Wc, C, masked, on_radius=False, seed=0):
    rng = np.random.default_rng(seed)
    B, N = 2, Hc * Wc
    desc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    wdesc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    # keep every dot away from both margins: no step is taken by rounding
    dot = np.einsum("bnc,bmc->bnm", desc.reshape(B, N, C).astype(np.float64),
                    wdesc.reshape(B, N, C).astype(np.float64))
    assert min(np.abs(dot - 1.0).min(), np.abs(dot - 0.2).min()) > 2e-6
    warped = (rng.integers(0, 4 * G * max(Hc, Wc), (B, N, 2)) / 4.0)
    warped = warped.astype(np.float32)
    if on_radius:  # exactly G from a cell centre, along y, x and (3, 4, 5)
        cells = np.asarray(jl.cell_grid_coords(Hc, Wc, G))
        warped[:, :N // 3] = cells[:N // 3] + np.float32([G, 0])
        warped[:, N // 3:2 * N // 3] = (cells[N // 3:2 * N // 3]
                                        - np.float32([0, G]))
        warped[0, -4:] = cells[-4:] - np.float32([4.8, 6.4]) * (G / 8)
    valid = None
    if masked:
        valid = np.ones((B, Hc * G, Wc * G), np.float32)
        valid[:, :G] = 0
        valid[1, 20:30, 9:40] = 0
    return desc, wdesc, warped, valid


def _torch(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _jax(a):
    return None if a is None else jnp.asarray(a)


CASES = {
    "masked": dict(Hc=6, Wc=8, C=32, masked=True),
    "no_mask": dict(Hc=6, Wc=8, C=32, masked=False),
    # N = 165 and 130: more than one 128-tile, not a multiple of it
    "ragged": dict(Hc=11, Wc=15, C=16, masked=True, seed=1),
    "on_radius": dict(Hc=10, Wc=13, C=16, masked=False, on_radius=True,
                      seed=2),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    desc, wdesc, warped, valid = _case(**CASES[request.param])
    jcfg = jl.DescriptorLossConfig(**KW)

    def pallas_loss(a, b):
        return descriptor_loss_pallas(a, b, _jax(warped), jcfg, _jax(valid),
                                      interpret=True)

    want = [float(v) for v in pallas_loss(_jax(desc), _jax(wdesc))]
    grads = jax.grad(lambda a, b: pallas_loss(a, b)[0], argnums=(0, 1))(
        _jax(desc), _jax(wdesc))
    return desc, wdesc, warped, valid, want, [np.asarray(g) for g in grads]


def _plain_loss(a, b, warped, valid):
    """``descriptor_loss_blockwise``'s normalisation around
    ``hinge_sums_plain`` itself."""
    B, Hc, Wc, C = a.shape
    N = Hc * Wc
    mask = (torch.ones((B, N)) if valid is None
            else tl._cell_mask(valid, G).reshape(B, N))
    sums = hinge_sums_plain(a.reshape(B, N, C), b.reshape(B, N, C), warped,
                            tl.cell_grid_coords(Hc, Wc, G), mask, 250.0, 1.0,
                            0.2, float(G))
    return tuple(scale * s.sum() / (mask.sum() * N)
                 for scale, s in zip((1e-4, 1.0, 1.0), sums))


@pytest.mark.parametrize("route", ["wrapper", "plain"])
def test_values_and_gradients_match_pallas(case, route):
    desc, wdesc, warped, valid, want, want_grads = case
    a, b = _torch(desc, True), _torch(wdesc, True)
    if route == "wrapper":
        got = descriptor_loss_blockwise(a, b, _torch(warped),
                                        tl.DescriptorLossConfig(**KW),
                                        _torch(valid))
    else:
        got = _plain_loss(a, b, _torch(warped), _torch(valid))
    np.testing.assert_allclose([float(v.detach()) for v in got], want,
                               rtol=2e-5)
    assert not got[1].requires_grad and not got[2].requires_grad
    got[0].backward()
    for g, w in zip((a.grad, b.grad), want_grads):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_matches_dense_jax_path(case):
    desc, wdesc, warped, valid, _, _ = case
    jcfg = jl.DescriptorLossConfig(**KW)
    want = jl.descriptor_loss_from_cells(_jax(desc), _jax(wdesc),
                                         _jax(warped), jcfg, _jax(valid))
    got = descriptor_loss_blockwise(_torch(desc), _torch(wdesc),
                                    _torch(warped),
                                    tl.DescriptorLossConfig(**KW),
                                    _torch(valid))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=2e-5)


def test_per_item_sums_and_cotangent():
    """The sums are per batch item, and only S_pair's cotangent reaches
    the descriptors: weighting item b by b + 1 scales its gradient."""
    desc, wdesc, warped, _ = _case(6, 8, 32, False)
    B, N = 2, 48
    a, b = _torch(desc.reshape(B, N, 32), True), _torch(wdesc.reshape(B, N, 32), True)
    cells = tl.cell_grid_coords(6, 8, G)
    mask = torch.ones((B, N))
    sums = descriptor_hinge_sums(a, b, _torch(warped), cells, mask, 250.0,
                                 1.0, 0.2, float(G))
    assert all(s.shape == (B,) for s in sums)
    torch.testing.assert_close(sums[0], sums[1] + sums[2], rtol=1e-5, atol=0)
    (sums[0] * torch.tensor([1.0, 2.0])).sum().backward()
    first = a.grad.clone()
    a.grad = None
    one = descriptor_hinge_sums(a, b, _torch(warped), cells, mask, 250.0,
                                1.0, 0.2, float(G))
    one[0].sum().backward()
    torch.testing.assert_close(first[0], a.grad[0], rtol=0, atol=0)
    torch.testing.assert_close(first[1], 2 * a.grad[1], rtol=1e-6, atol=0)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    a = torch.zeros((1, 4, 6))
    cells, wc, mask = torch.zeros((4, 2)), torch.zeros((1, 4, 2)), torch.ones((1, 4))
    with pytest.raises(ValueError, match="multiple of 4"):
        descriptor_hinge_sums(a, a, wc, cells, mask, 250.0, 1.0, 0.2, 8.0)
    with pytest.raises(ValueError, match="mask"):
        descriptor_hinge_sums(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8)),
                              wc, cells, torch.ones((2, 4)), 250.0, 1.0, 0.2,
                              8.0)
