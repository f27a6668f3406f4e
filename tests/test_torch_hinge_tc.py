"""The descriptor-loss kernels on the TF32 tensor cores (``csrc/
descriptor_loss.cu``), checked on the CPU.

The kernels cannot run here, so these tests restate their index formulas
(the fragment order of X, the [j][c] and [c][j] tiles of Y, ddot's tile,
the units' split over blocks and the partial slots) and hold them against
the wgmma operand layouts (K-major core matrices of 8 rows x 16 bytes at
the descriptors' leading and stride byte offsets; A fragments rows g, g +
8 at columns t, t + 4). Then ``_hinge_tc``'s model of the kernels'
arithmetic: the split, the dot within the bound delta = kappa(C) ||a||
||b|| that ``descriptor_loss.cu`` states, at the test and the training
operands' scales, C 16, 64, 256; the band catching dots planted near
both margins; a mask that is not 0/1 (ddot split too); and the modelled
sums and gradients against the JAX Pallas kernel in interpret mode.

Tolerances: the sums rtol 2e-5 and the gradients rtol 1e-4, atol 1e-5 of
the largest entry, as ``tests/test_torch_desc_loss.py`` holds the port's
plain version (its inputs keep every dot 2e-6 from both margins, so the
float32 dots of the Pallas kernel step as the exact ones do).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _hinge_tc as hm
from spnerf_tpu.kernels.descriptor_loss_pallas import descriptor_loss_pallas
from spnerf_tpu.train import losses as jl
from spnerf_tpu_torch.kernels.descriptor_loss import hinge_sums_plain, kappa
from spnerf_tpu_torch.train import losses as tl

G = 8
KW = dict(grid_size=G, lambda_d=250, lambda_loss=1e-4, positive_margin=1.0,
          negative_margin=0.2)


# ---- the kernels' layouts -------------------------------------------------

def _kmajor(start, lbo, sbo, n, k):
    """Byte of element (row n, column k) of a K-major wgmma operand without
    swizzle: 8 x 4 core matrices of 128 contiguous bytes, LBO apart along K
    and SBO apart along the rows."""
    return start + (n // 8) * sbo + (k // 4) * lbo + (n % 8) * 16 + (k % 4) * 4


def _y_byte(j, c):  # store_y: Yh / Yl
    return ((c // 4) * 4 + j // 8) * 128 + (j % 8) * 16 + (c % 4) * 4


def _d_byte(r, j):  # hinge_bwd_tc_kernel: ddot's A tile
    return ((j // 4) * 8 + r // 8) * 128 + (r % 8) * 16 + (j % 4) * 4


def _x_float(r, c):  # load_x: X in fragment order, 64-row blocks
    rr = r % 64
    return (r // 64) * 16384 + (((c // 8) * 4 + rr // 16) * 32 + (rr % 8) * 4
                                + c % 4) * 4 + (rr % 16) // 8 + 2 * ((c % 8) // 4)


def _x_load_word(r, c):  # load_x's base and at, as the kernel forms them
    base = (r // 64) * 16384 + ((r % 64) // 16) * 32 * 4 + (r % 8) * 16 + (r % 16) // 8
    c4 = c // 4
    return base + (c4 // 2) * 512 + 2 * (c4 % 2) + 4 * (c % 4)


@pytest.mark.parametrize("layout", ["y", "ddot", "x"])
def test_tiles_are_one_to_one(layout):
    """Every element of a tile has its own slot, and the tile fills its
    buffer."""
    shape, fn, size = {"y": ((32, 256), _y_byte, 32 * 256 * 4),
                       "ddot": ((64, 32), _d_byte, 64 * 32 * 4),
                       "x": ((128, 256), _x_float, 128 * 256)}[layout]
    slots = {fn(a, b) for a in range(shape[0]) for b in range(shape[1])}
    assert len(slots) == shape[0] * shape[1]
    assert min(slots) == 0 and max(slots) < size


def test_descriptors_read_the_stored_tiles():
    """The wgmma descriptors of dot_tile (B = Y as [j][c]: start 256 wg +
    1024 k8, LBO 512, SBO 128; N 16, K 8) and of the gradient (B = ddot^T:
    the [i][j] tile at start 2048 s, LBO 1024, SBO 128; N 64 rows i, K 8 of
    j) address the elements the stores put there."""
    for wg in range(2):
        for k8 in range(32):
            for n in range(16):
                for k in range(8):
                    assert _kmajor(256 * wg + 1024 * k8, 512, 128, n, k) == \
                        _y_byte(16 * wg + n, 8 * k8 + k)
    for s in range(4):
        for n in range(64):
            for k in range(8):
                assert _kmajor(2048 * s, 1024, 128, n, k) == _d_byte(n, 8 * s + k)


def test_gradient_fragments_and_outputs():
    """The gradient's A fragments (Y^T: register q of k-step s is column c =
    c0 + 16 warp + g + 8 (q % 2) at row j = 8 s + t + 4 (q // 2) of the [j][c]
    tile) are the wgmma A layout's rows and columns, each (c, j) once per
    M-tile; its accumulator entry 4 jn + 2 h + e (row c0 + 16 warp + g + 8 h,
    column i = 8 jn + 2 t + e of m64n64) covers the 64 x 64 output once."""
    for c0 in (0, 64, 128, 192):
        seen, out = set(), set()
        for s in range(4):
            for warp in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    want = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
                    for q, (m, k) in enumerate(want):
                        c = c0 + 16 * warp + g + 8 * (q % 2)
                        j = 8 * s + t + 4 * (q // 2)
                        assert (c - c0 - 16 * warp, j - 8 * s) == (m, k)
                        seen.add((c, j, _y_byte(j, c)))
        for warp in range(4):
            for lane in range(32):
                for jn in range(8):
                    for h in range(2):
                        for e in range(2):
                            out.add((c0 + 16 * warp + lane // 4 + 8 * h,
                                     8 * jn + 2 * (lane % 4) + e))
        assert len(seen) == 64 * 32 and len(out) == 64 * 64


def test_x_fragments_hold_the_wgmma_a_layout():
    """load_x puts (r, c) where the layout says, and warpgroup wg's 16-byte
    load at wg * 16384 + (k8 * 512 + (warp * 32 + lane) * 4) holds its A
    fragment of k-step k8 (m64nNk8 .tf32: registers 0-3 are rows g, g + 8,
    g, g + 8 of the warp's 16 at columns t, t, t + 4, t + 4)."""
    for r in range(128):
        for c in range(256):
            assert _x_load_word(r, c) == _x_float(r, c)
    for wg in range(2):
        for k8 in range(32):
            for warp in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    want = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
                    base = wg * 16384 + k8 * 512 + (warp * 32 + lane) * 4
                    for q, (r, c) in enumerate(want):
                        assert _x_float(64 * wg + 16 * warp + r, 8 * k8 + c) == base + q


def _block_of(u, U, G):
    return ((u + 1) * G - 1) // U


@pytest.mark.parametrize("B,NX,NY,sms", [(2, 1200, 1200, 132),
                                         (2, 4800, 4800, 132),
                                         (3, 165, 130, 132), (1, 7, 9, 132),
                                         (2, 1200, 1200, 114)])
def test_units_cover_once_and_slots_are_distinct(B, NX, NY, sms):
    """Block c's run [c U / G, (c + 1) U / G) of units covers each unit
    once; block_of finds the block of a unit; a tile's blocks are
    consecutive and fit the slots kmax gives; the grid is one block an SM
    (at least 132 at the training shape)."""
    n_i, n_j = -(-NX // 64), -(-NY // 32)
    U = B * n_i * n_j
    G = min(sms, U)
    runs = [(c * U // G, (c + 1) * U // G) for c in range(G)]
    assert runs[0][0] == 0 and runs[-1][1] == U
    assert all(a < b for a, b in runs)
    assert all(runs[c][1] == runs[c + 1][0] for c in range(G - 1))
    for c, (a, b) in enumerate(runs):
        assert _block_of(a, U, G) == c and _block_of(b - 1, U, G) == c
    kmax = max(_block_of((T + 1) * n_j - 1, U, G) - _block_of(T * n_j, U, G)
               + 1 for T in range(B * n_i))
    slots = set()
    for c, (a, b) in enumerate(runs):
        for T in range(a // n_j, (b - 1) // n_j + 1):
            k = c - _block_of(T * n_j, U, G)
            assert 0 <= k < kmax
            slots.add((T, k))
    assert len(slots) == len({(T, c) for c, (a, b) in enumerate(runs)
                              for T in range(a // n_j, (b - 1) // n_j + 1)})
    if (B, NX) == (2, 1200) and sms == 132:
        assert G == 132 and kmax <= 5


# ---- the model of the arithmetic -----------------------------------------

def test_split_and_tf32_rounding():
    """cvt.rna: ties away from zero; hi + lo within 2^-22 |x| of x, both
    TF32 values, |lo| <= 2^-11 |x|."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    ties = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2
                         - np.float32(2.0 ** -23)], dtype=torch.float32)
    assert hm.tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000)
                         .astype(np.float32) * 3)
    hi, lo = hm.split(x)
    assert bool(hm.is_tf32(hi).all() and hm.is_tf32(lo).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize("C", [16, 64, 256])
@pytest.mark.parametrize("scale", ["test", "train"])
def test_model_dot_within_delta(C, scale):
    """The modelled tensor-core dots, the forward's and the gradient's
    (halves), against float64: within kappa(C) ||a|| ||b|| everywhere, and
    not equal to the float32 rounding of the exact dot everywhere (the
    model's truncation shows)."""
    rng = np.random.default_rng(C)
    s = (0.16 / C) ** 0.25 if scale == "test" else 0.08
    a = torch.from_numpy((rng.standard_normal((48, C)) * s).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((40, C)) * s).astype(np.float32))
    exact = a.double() @ b.double().T
    norms = a.double().norm(dim=-1)[:, None] * b.double().norm(dim=-1)[None]
    for halves in (False, True):
        got = hm.tc_dot(a, b, halves).double()
        ratio = (got - exact).abs() / (kappa(C) * norms)
        assert float(ratio.max()) <= 1.0
        assert bool((got != exact.float().double()).any())


def _planted(C, rng, offsets):
    """Rows a (N, C), b (M, C) and near (N, M) with the dots of the first
    len(offsets) pairs (k, k) planted at margin + offset in float64 (pos
    margin where near, neg margin elsewhere, alternately)."""
    s = (0.16 / C) ** 0.25
    a = (rng.standard_normal((24, C)) * s).astype(np.float32)
    b = (rng.standard_normal((24, C)) * s).astype(np.float32)
    near = rng.uniform(size=(24, 24)) < 0.3
    for k, off in enumerate(offsets):
        near[k, k] = k % 2 == 0
        target = (1.0 if near[k, k] else 0.2) + off
        c = int(np.abs(a[k]).argmax())
        for _ in range(3):
            dot = float(a[k].astype(np.float64) @ b[k].astype(np.float64))
            b[k, c] = np.float32(b[k, c] + (target - dot) / float(a[k, c]))
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(near)


@pytest.mark.parametrize("C", [64, 256])
def test_band_catches_planted_pairs(C):
    """Dots planted at +- 5e-7 and +- delta / 4 of both margins: the
    modelled band takes every one, and every modelled step equals the
    float64 dot's."""
    rng = np.random.default_rng(7)
    delta = kappa(C) * (0.16 / C) ** 0.5 * C  # at the rows' typical norms
    offsets = [5e-7, -5e-7, 5e-7, -5e-7, delta / 4, -delta / 4, delta / 4,
               -delta / 4]
    a, b, near = _planted(C, rng, offsets)
    step, repaired = hm.step(a, b, near, 250.0, 1.0, 0.2)
    assert bool(repaired.diagonal()[:len(offsets)].all())
    exact = a.double() @ b.double().T
    margin = torch.where(near, 1.0, 0.2).double()
    want = torch.where(near, torch.where(exact < margin, -250.0, 0.0),
                       torch.where(exact > margin, 1.0, 0.0)).float()
    assert torch.equal(step, want)


def test_fractional_mask_splits_ddot():
    """With a mask of 0.3 (no TF32 value: a pair beyond the negative
    margin has ddot = mask) the modelled gradient takes ddot's lo pass and
    matches the float64 plain version's gradient."""
    rng = np.random.default_rng(11)
    B, N, C = 1, 70, 32
    s = (0.16 / C) ** 0.25
    a = torch.from_numpy((rng.standard_normal((B, N, C)) * s).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((B, N, C)) * s).astype(np.float32))
    cells = tl.cell_grid_coords(7, 10, G)
    wcells = torch.from_numpy((rng.integers(0, 320, (B, N, 2)) / 4.0)
                              .astype(np.float32))
    mask = torch.from_numpy(rng.choice(np.float32([0.3, 0.5, 1.0, 0.0]),
                                       (B, N)))
    assert not bool(hm.is_tf32(mask).all())
    _, dA, dB, _ = hm.hinge(a[0], b[0], wcells[0], cells, mask[0], 250.0,
                            1.0, 0.2, float(G), 1.0)
    a64, b64 = a.double().requires_grad_(), b.double().requires_grad_()
    sums = hinge_sums_plain(a64, b64, wcells.double(), cells.double(),
                            mask.double(), 250.0, 1.0, 0.2, float(G))
    wA, wB = torch.autograd.grad(sums[0].sum(), (a64, b64))
    for got, want in ((dA, wA[0]), (dB, wB[0])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


CASES = {
    "masked": dict(Hc=6, Wc=8, C=32, masked=True),
    "no_mask": dict(Hc=6, Wc=8, C=32, masked=False),
    "ragged": dict(Hc=11, Wc=15, C=16, masked=True, seed=1),
}


def _case(Hc, Wc, C, masked, seed=0):
    """tests/test_torch_desc_loss.py's operands: every dot 2e-6 from both
    margins, the warped cells on a quarter-pixel grid."""
    rng = np.random.default_rng(seed)
    B, N = 2, Hc * Wc
    desc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    wdesc = (rng.standard_normal((B, Hc, Wc, C)) * 0.25).astype(np.float32)
    dot = np.einsum("bnc,bmc->bnm", desc.reshape(B, N, C).astype(np.float64),
                    wdesc.reshape(B, N, C).astype(np.float64))
    assert min(np.abs(dot - 1.0).min(), np.abs(dot - 0.2).min()) > 2e-6
    warped = (rng.integers(0, 4 * G * max(Hc, Wc), (B, N, 2)) / 4.0)
    valid = None
    if masked:
        valid = np.ones((B, Hc * G, Wc * G), np.float32)
        valid[:, :G] = 0
        valid[1, 20:30, 9:40] = 0
    return desc, wdesc, warped.astype(np.float32), valid


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_pallas(name):
    """The modelled kernels' sums and gradients, normalised as
    ``descriptor_loss_blockwise`` does, against the JAX Pallas kernel in
    interpret mode."""
    import jax

    desc, wdesc, warped, valid = _case(**CASES[name])
    B, Hc, Wc, C = desc.shape
    N = Hc * Wc
    jcfg = jl.DescriptorLossConfig(**KW)
    jv = None if valid is None else jnp.asarray(valid)

    def pallas(a, b):
        return descriptor_loss_pallas(a, b, jnp.asarray(warped), jcfg, jv,
                                      interpret=True)

    want = [float(v) for v in pallas(jnp.asarray(desc), jnp.asarray(wdesc))]
    want_grads = jax.grad(lambda a, b: pallas(a, b)[0], argnums=(0, 1))(
        jnp.asarray(desc), jnp.asarray(wdesc))
    mask = (torch.ones((B, N)) if valid is None
            else tl._cell_mask(torch.from_numpy(valid), G).reshape(B, N))
    norm = float(mask.sum()) * N
    cells = tl.cell_grid_coords(Hc, Wc, G)
    g = 1e-4 / norm
    sums, grads = np.zeros(3), ([], [])
    for bi in range(B):
        s, dA, dB, _ = hm.hinge(
            torch.from_numpy(desc[bi].reshape(N, C)),
            torch.from_numpy(wdesc[bi].reshape(N, C)),
            torch.from_numpy(warped[bi]), cells, mask[bi], 250.0, 1.0, 0.2,
            float(G), g)
        sums += s
        grads[0].append(dA.reshape(Hc, Wc, C).numpy())
        grads[1].append(dB.reshape(Hc, Wc, C).numpy())
    got = [1e-4 * sums[0] / norm, sums[1] / norm, sums[2] / norm]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for gm, w in zip(grads, want_grads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(np.stack(gm), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
