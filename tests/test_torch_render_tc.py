"""The bf16 render on the tensor cores (``csrc/render.cu``
``render_tc_kernel``), checked on the CPU.

The kernel cannot run here, so these tests restate its index formulas
(``TcTile::group_ray``, ``row_sample``, ``encode``, ``tc_layer``,
``stage_rays``, the head's columns, the shuffles of the compositing and
the repair's stashed rows) and hold them against the register
layouts of ``wgmma`` m64nNk16 as the PTX ISA defines them: each (ray,
sample, k) of an M-tile lies in exactly one A-fragment element, and a
layer's accumulators land in the next layer's A fragments at the same
(ray, sample) and k. Then ``_render_tc``'s model of the tensor cores'
sums (``tc_step``, checked against the instruction by
``tests/test_torch_cuda.py``) is held on hand-made cases where its
truncation and rounding show, and the kernel's MLP built on it
(``kernel_head``: wgmma's sums, FMAs in k order where a sum is within its
bound of a bf16 rounding boundary) against the library's order
(``fma_head``) on the committed sphere fields: the same bf16 activations.
Last, renders through that MLP against the plain version and the Pallas
kernels in interpret mode.

Tolerances: the two sum orders agree within 4 float32 ulps of the sum of
|products| per k-step; renders within the bf16 tolerances of
``tests/test_torch_render.py`` against the CPU's library (its own order of
sums) and Pallas, and within ``chip_smoke.py``'s 1e-4 (rgb) and 1e-3
(depth) against the FMA order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.kernels import render_pallas as jrp
from spnerf_tpu.models import fused_tiny_nerf as jft
from spnerf_tpu_torch.kernels import render as trk
from spnerf_tpu_torch.models import fused_tiny_nerf as tft
from spnerf_tpu_torch.tools.import_jax_weights import tiny_field_from_jax
from spnerf_tpu_torch.tools.kernel_times import FIELD_DIR, RENDER_FIELDS

import _render_tc as tc

BF16_TOL = (2e-3, 5e-3)  # tests/test_torch_render.py


# ---- the kernel's index formulas, restated ----

def spr_of(width):
    """Samples of a ray in an M-tile (TcTile::SPR)."""
    return 4 if width == 128 else 2


def group_ray(spr, warp, g):
    """TcTile::group_ray: the ray (within its group) of rows g, g + 8."""
    return 8 * warp + g if spr == 2 else 4 * warp + (g & 3)


def row_sample(spr, g, h):
    """TcTile::row_sample: the sample offset of row g + 8 h."""
    return h if spr == 2 else 2 * h + (g >> 2)


def ptx_a(warp, lane, reg, half):
    """(row, k) of a bf16 m64k16 A-fragment element (PTX ISA: register i
    of lane 4 g + t4 holds row g + 8 (i % 2), columns 2 t4 + 8 (i // 2) +
    {0, 1})."""
    g, t4 = lane // 4, lane % 4
    return 16 * warp + g + 8 * (reg % 2), 2 * t4 + 8 * (reg // 2) + half


def ptx_d(warp, lane, reg):
    """(row, column) of an m64nN float32 accumulator element (register
    4 j + 2 h + i: row g + 8 h, column 8 j + 2 t4 + i)."""
    g, t4 = lane // 4, lane % 4
    j, h, i = reg // 4, (reg // 2) % 2, reg % 2
    return 16 * warp + g + 8 * h, 8 * j + 2 * t4 + i


def row_of(spr, row):
    """(ray, sample offset) of an M-tile row in the kernel's order."""
    warp, r = row // 16, row % 16
    return group_ray(spr, warp, r % 8), row_sample(spr, r % 8, r // 8)


def encode_element(spr, warp, lane, ks, reg, half):
    """(ray, sample offset, k) that ``encode`` writes into register reg,
    half of k-step ks: a[ks][2 e + h] holds the ray at t_h, operands
    o[2 e + half], and o[q] is column 16 ks + 2 t4 + 8 (q // 2) + q % 2."""
    g, t4 = lane // 4, lane % 4
    e, h = reg // 2, reg % 2
    q = 2 * e + half
    return (group_ray(spr, warp, g), row_sample(spr, g, h),
            16 * ks + 2 * t4 + 8 * (q // 2) + q % 2)


@pytest.mark.parametrize("width", [128, 64, 32])
def test_a_fragments_cover_the_m_tile_once(width):
    spr, ks_n = spr_of(width), width // 16
    seen = {}
    for warp in range(4):
        for lane in range(32):
            for ks in range(ks_n):
                for reg in range(4):
                    for half in range(2):
                        mine = encode_element(spr, warp, lane, ks, reg, half)
                        row, k = ptx_a(warp, lane, reg, half)
                        direct = (*row_of(spr, row), 16 * ks + k)
                        assert mine == direct
                        seen[mine] = seen.get(mine, 0) + 1
    rays = 64 // spr
    assert sorted(seen) == [(r, s, k) for r in range(rays) for s in range(spr)
                            for k in range(width)]
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("width", [128, 64, 32])
def test_accumulators_become_the_next_a_fragments(width):
    """tc_layer: accumulator register 4 j + 2 h + i of piece p goes to
    out[(p NP + 8 j) / 16][2 (j % 2) + h], half i; that element must be
    the same (row, k = column) in the A layout."""
    np_cols = min(width, 64)
    for p in range(width // np_cols):
        for warp in range(4):
            for lane in range(32):
                for reg in range(np_cols // 2):
                    row, col = ptx_d(warp, lane, reg)
                    col += p * np_cols
                    j, h, i = reg // 4, (reg // 2) % 2, reg % 2
                    ks, a_reg = (p * np_cols + 8 * j) // 16, 2 * (j % 2) + h
                    a_row, a_k = ptx_a(warp, lane, a_reg, i)
                    assert (a_row, 16 * ks + a_k) == (row, col)


@pytest.mark.parametrize("width", [128, 64, 32])
def test_staged_rows_hold_each_fragment_column_once(width):
    """stage_rays writes column c to 16 (c / 16) + 2 ((c % 16) / 8) + 4 t4
    + c % 2 with t4 = (c % 8) / 2; encode reads the float4 at 16 ks + 4 t4
    as columns 16 ks + 2 t4 + {0, 1, 8, 9}, and tc_layer's df at
    16 (col / 16) + 2 ((col / 8) % 2) + 4 t4 as col + 2 t4 + {0, 1}."""
    pos = {}
    for c in range(width):
        t4 = (c % 8) // 2
        pos[c] = (c // 16) * 16 + 2 * ((c % 16) // 8) + 4 * t4 + c % 2
    assert sorted(pos.values()) == list(range(width))
    where = {v: c for c, v in pos.items()}
    for ks in range(width // 16):
        for t4 in range(4):
            got = [where[16 * ks + 4 * t4 + e] for e in range(4)]
            want = [16 * ks + 2 * t4 + off for off in (0, 1, 8, 9)]
            assert got == want
    for col in range(0, width, 8):
        for t4 in range(4):
            at = (col // 16) * 16 + 2 * ((col // 8) % 2) + 4 * t4
            assert [where[at], where[at + 1]] == [col + 2 * t4, col + 2 * t4 + 1]


@pytest.mark.parametrize("width", [128, 64, 32])
def test_compositing_reads_each_sample_from_its_lanes(width):
    """The compositing: w3's column c is staged at n = 2 c of the head's 8,
    so that lane 4 g + t4 holds head column t4 of rows g and g + 8 and
    forms part t4 (alpha, or a sigmoid) of those two samples; sample s + i
    of the ray of lane (g, t4) is then read from lanes src + k, k = 0..3,
    register 2 r: SPR 2, src = this quad, r = i; SPR 4, src = 4 (g % 4 +
    4 (i % 2)), r = i / 2. Each of the ray's lanes sees every sample's
    four parts, in sample order."""
    spr = spr_of(width)
    for warp in range(4):
        for lane in range(32):
            g = lane // 4
            ray = group_ray(spr, warp, g)
            for i in range(spr):
                src = lane & ~3 if spr == 2 else 4 * ((g & 3) + 4 * (i % 2))
                r = i if spr == 2 else i // 2
                for k in range(4):
                    row, col = ptx_d(warp, src + k, 2 * r)
                    assert row_of(spr, row) == (ray, i)
                    assert col == 2 * k  # head column k


# ---- the tensor cores' sums ----

def _bf16(values):
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)


def test_tc_step_cuts_each_product_below_the_largest():
    """Products below 2^(e - 25) of the largest product's exponent e are
    cut toward zero before the sum: 1 - 2^-30 gives 1, where the exact
    sum rounded toward zero gives the float below 1."""
    a = _bf16([[1.0, -2.0 ** -30] + [0.0] * 14])
    b = _bf16([[1.0]] * 16)
    got = tc.tc_step(a, b, None)
    assert float(got) == 1.0
    exact_rz = np.nextafter(np.float32(1.0), np.float32(0.0))
    assert float(got) != float(exact_rz)


def test_tc_step_rounds_the_sum_toward_zero():
    """1 + 1.5 * 2^-24 keeps all its bits before the rounding (above
    2^-25) and rounds toward zero to 1, where to nearest it is 1 + 2^-23;
    the same holds for the running sum: c = 1, product 1.5 * 2^-24."""
    b = _bf16([[1.0]] * 16)
    a = _bf16([[1.0, 1.5 * 2.0 ** -24] + [0.0] * 14])
    assert float(tc.tc_step(a, b, None)) == 1.0
    a = _bf16([[1.5 * 2.0 ** -24] + [0.0] * 15])
    c = torch.ones((1, 1))
    assert float(tc.tc_step(a, b, c)) == 1.0
    assert float(tc.tc_step(-a, b, -c)) == -1.0


def test_tc_step_equals_the_exact_sum_where_nothing_is_cut():
    """Products within 11 exponents of the largest keep every bit: the
    result is the exact sum rounded toward zero."""
    rng = np.random.default_rng(40)
    m = rng.integers(128, 256, (64, 16)) / 128.0
    a = torch.from_numpy((m * 2.0 ** rng.integers(-3, 3, (64, 16))
                          * rng.choice([-1, 1], (64, 16))).astype(np.float32))
    b = torch.from_numpy((rng.integers(128, 256, (16, 8)) / 128.0
                          * 2.0 ** rng.integers(-2, 2, (16, 8))).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    exact = a.double() @ b.double()
    rn = exact.float()
    rz = torch.where(rn.double().abs() > exact.abs(),
                     torch.nextafter(rn, torch.zeros_like(rn)), rn)
    assert torch.equal(tc.tc_step(a, b, None), rz)


@pytest.mark.parametrize("width", [128, 64, 32])
def test_tc_matmul_against_the_library_order(width):
    rng = np.random.default_rng(41 + width)
    x = torch.from_numpy(np.sin(rng.uniform(-3, 3, (96, width)))
                         .astype(np.float32)).to(torch.bfloat16).float()
    w = torch.from_numpy((rng.standard_normal((width, width)) * 0.1)
                         .astype(np.float32)).to(torch.bfloat16).float()
    got = tc.tc_matmul(x, w)
    lib = tc.fma_matmul(x, w)
    scale = (x.abs() @ w.abs())
    assert float(((got - lib).abs() / scale).max()) <= 4 * (width // 16) * 2.0 ** -23


@pytest.mark.parametrize("width", [128, 64, 32])
def test_stashed_rows_hold_the_a_rows_in_k_order(width):
    """stash_rows: register i of k-step ks of lane 4 g + t4 in warp w,
    M-tile m, goes to word (64 m + 16 w + g + 8 (i % 2)) RSTR + 8 ks +
    4 (i // 2) + t4 of the stash; that must be the element's row (64 m +
    its row in the M-tile) at k = 2 (word in the row) + half, so that
    fma_row reads a row's k in order. w's column n at k lies at
    64 (n / 8) (W / 8) + 8 (n % 8) + 64 (k / 8) + k % 8 (stage_weights'
    K-major core matrices): fma_row's B reads."""
    mt, rstr = (2 if width == 32 else 1), width // 2 + 4
    seen = set()
    for m in range(mt):
        for warp in range(4):
            for lane in range(32):
                g, t4 = lane // 4, lane % 4
                for ks in range(width // 16):
                    for i in range(4):
                        word = ((64 * m + 16 * warp + g + 8 * (i % 2)) * rstr
                                + 8 * ks + 4 * (i // 2) + t4)
                        row, at = divmod(word, rstr)
                        for half in range(2):
                            a_row, k = ptx_a(warp, lane, i, half)
                            assert row == 64 * m + a_row
                            assert 2 * at + half == 16 * ks + k
                            seen.add((row, 2 * at + half))
    assert len(seen) == 64 * mt * width
    at = {}
    for k in range(width):
        for n in range(width):
            staged = ((n >> 3) * (width // 8) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7)
            base = (n >> 3) * (width // 8) * 64 + (n & 7) * 8
            assert staged == base + 64 * (k // 8) + k % 8
            at[staged] = (k, n)
    assert len(at) == width * width


def _field_rows(width, n_rays=48):
    """enc and df rows of the committed sphere field at ``width``: rays of
    bench_nerf.py's orbit camera at 32 samples, bf16 weights."""
    from spnerf_tpu_torch.data.nerf_dataset import camera_intrinsics
    from spnerf_tpu_torch.models.nerf import camera_rays
    from spnerf_tpu_torch.tasks.nerf_task import pose_orbit

    side = 362
    K = torch.from_numpy(camera_intrinsics((side, side), 60.0))
    pose = torch.from_numpy(pose_orbit(8, radius=4.0, height=0.4)[0])
    o, d = camera_rays((side, side), K, pose)
    pick = torch.arange(0, side * side, side * side // n_rays)[:n_rays]
    o, d = o[pick], d[pick]
    with np.load(FIELD_DIR / RENDER_FIELDS[width][0]) as data:
        params = tiny_field_from_jax({k: data[k] for k in data.files}, "cpu",
                                     torch.bfloat16)
    cfg = tft.TinyFieldConfig(n_samples=32, width=width)
    A, c = (torch.from_numpy(t) for t in tft.make_encoding(cfg))
    oe, de = tft.encode_rays(o, d, A, c)
    df = tft.direction_features(params, d, A, c)
    dt = np.float32((cfg.far - cfg.near) / 32)
    ts = torch.tensor([trk._sample_t(s, 0.5, cfg.near, dt) for s in range(32)])
    enc = torch.sin(oe[:, None] + ts[None, :, None] * de[:, None]).reshape(-1, width)
    dfr = df[:, None].expand(-1, 32, -1).reshape(-1, width)
    return [params[k] for k in ("w1", "w2", "w3")], enc, dfr


@pytest.mark.parametrize("width", [128, 64, 32])
def test_kernel_mlp_rounds_as_the_library_order(width):
    """The kernel's MLP (wgmma's sums, FMAs in k order for the undecided
    ones) against the FMA order on the committed field: every bf16 hidden
    activation and (packed) head value equal, with a few percent of the
    elements summed twice."""
    ws, enc, df = _field_rows(width)
    packed = width != 128
    mine = tc.kernel_head(*ws, packed)
    got = mine(enc, df)
    want = tc.fma_head(*ws, packed)(enc, df)
    assert all(0.0 < u < 0.03 for u in mine.undecided[:2 + packed])
    if packed:
        assert torch.equal(got, want)
    else:  # the dense head is not rounded: wgmma's sum of the same h
        scale = tc.fma_matmul(_h2(ws, enc, df), ws[2][:, :4].float().abs())
        assert float(((got - want).abs() / scale).max()) <= 4 * 8 * 2.0 ** -23


@pytest.mark.parametrize("width", [128, 64, 32])
def test_order_gap_within_half_the_slack(width):
    """The kernel's bound (8 units of 2^-24 * max_k |a_k| * sum_k |b_k|)
    against the two orders' largest distance on the committed field, for
    each product with the kernel's row bounds (1 for the sines): within
    half of it."""
    ws, enc, df = _field_rows(width)
    w1, w2, w3 = (w.float() for w in (ws[0], ws[1], ws[2][:, :4]))
    x = tc._bf16(enc)
    h1 = tc._bf16(torch.relu(tc.fma_matmul(x, w1)))
    h2 = _h2(ws, enc, df)
    gaps = [tc.order_gap(x, w1, torch.ones(x.shape[0])),
            tc.order_gap(h1, w2, h1.amax(1)), tc.order_gap(h2, w3, h2.amax(1))]
    assert max(gaps) <= tc.SLACK / 2.0 ** -24 / 2


def _h2(ws, enc, df):
    """The second hidden activation in the FMA order."""
    w1, w2 = ws[0].float(), ws[1].float()
    h = tc._bf16(torch.relu(tc.fma_matmul(tc._bf16(enc), w1)))
    return tc._bf16(torch.relu(tc.fma_matmul(h, w2) + df))


def _pallas_case(width):
    rng = np.random.default_rng(7)
    params = {k: (rng.standard_normal((width, width)) * 0.1).astype(np.float32)
              for k in ("w1", "w2", "w3", "wd")}
    dirs = rng.standard_normal((40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    orig = (rng.standard_normal((40, 3)) * 0.1).astype(np.float32)
    jcfg = jft.TinyFieldConfig(n_samples=16, width=width)
    tcfg = tft.TinyFieldConfig(n_samples=16, width=width)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in
          tiny_field_from_jax(params, device="cpu").items()}
    A, c = jft.make_encoding(jcfg)
    joe, jde = jft.encode_rays(jnp.asarray(orig), jnp.asarray(dirs), A, c)
    jdf = jft.direction_features(jp, jnp.asarray(dirs), A, c)
    A, c = tft.make_encoding(tcfg)
    toe, tde = tft.encode_rays(torch.from_numpy(orig), torch.from_numpy(dirs),
                               A, c)
    tdf = tft.direction_features(tp, torch.from_numpy(dirs), A, c)
    return (joe, jde, jdf, jp), (toe, tde, tdf, tp)


@pytest.mark.parametrize("width", [128, 64])
def test_kernel_mlp_render_against_plain_and_pallas(width):
    """A render through the kernel's MLP against the same render through
    the FMA order (within chip_smoke's 1e-4 / 1e-3), through the CPU's
    library order (the plain version here) and the Pallas kernel in
    interpret mode (within the bf16 tolerances)."""
    (joe, jde, jdf, jp), (toe, tde, tdf, tp) = _pallas_case(width)
    ws = [tp[k] for k in ("w1", "w2", "w3")]
    packed = width != 128
    kw = dict(jitter=0.37, n_samples=16, near=2.0, far=6.0, block=512,
              early_stop_eps=0.0)
    s_chunk = 4 if width == 128 else 2
    chunk = s_chunk * (128 // width if packed else 1)
    counted = dict(width=width, n_samples=16, chunk=chunk, near=2.0, far=6.0,
                   jitter=0.37, block=512, flags=None, early_stop_eps=0.0,
                   packed=packed)
    got = trk.render_plain_counted(toe, tde, tdf, tc.kernel_head(*ws, packed),
                                   **counted)
    fma = trk.render_plain_counted(toe, tde, tdf, tc.fma_head(*ws, packed),
                                   **counted)
    assert got[2] == fma[2] == 40 * 16
    assert float((got[0] - fma[0]).abs().max()) <= 1e-4
    assert float((got[1] - fma[1]).abs().max()) <= 1e-3
    if packed:
        want = jrp.render_fused_packed(joe, jde, jp["w1"], jp["w2"], jp["w3"],
                                       jdf, interpret=True, width=width,
                                       s_chunk=s_chunk, **kw)
        plain = trk.render_fused_packed(toe, tde, *ws, tdf, width=width,
                                        s_chunk=s_chunk, **kw)
    else:
        want = jrp.render_fused(joe, jde, jp["w1"], jp["w2"], jp["w3"], jdf,
                                interpret=True, s_chunk=s_chunk, **kw)
        plain = trk.render_fused(toe, tde, *ws, tdf, s_chunk=s_chunk, **kw)
    for ref in (plain, (np.asarray(want[0]), np.asarray(want[1]))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=BF16_TOL[0], rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=BF16_TOL[1], rtol=0)
    assert float(np.asarray(want[0]).max()) > 0.05
