"""The float32 render on the TF32 tensor cores (``csrc/render.cu``
``render_f32_kernel``), checked on the CPU.

The kernel cannot run here, so these tests restate its index formulas
(the hidden-unit order of its A fragments, ``prepare_render_f32``'s B
operands, the ring slots of lo(w2) at width 128) and hold them against the
register layouts of wgmma m64nNk8 .tf32 as the PTX ISA defines them, and
hold the split of a float32 word into the top 19 bits the tensor cores
read and ``tf32_lo``. Then ``_render_f32_tc``'s model of the kernel's sums
(three TF32 passes into one accumulator, each k-step ``_render_tc.tc_step``)
renders ``test_torch_cuda``'s small cases and the committed sphere fields
against the plain version (the CPU's library order), and one case against
the Pallas kernel in interpret mode.

Tolerances: the card's, which the model must meet with room to spare:
rgb 2e-5 and depth 1e-4 against the plain version
(``test_render_matches_plain_on_card``), (5e-6, 2e-5) on the sphere
fields (``chip_smoke.SMALL_RENDER_TOL["f32"]``), and
``test_torch_render.py``'s float32 tolerances against Pallas.
"""

import numpy as np
import pytest
import torch

from _render_f32_tc import CK, f32_matmul, hidden_order, kernel_head, tf32_lo, trunc
from spnerf_tpu_torch.kernels import render as trk

CARD_TOL = (2e-5, 1e-4)  # tests/test_torch_cuda.py, float32 kinds
SMALL_TOL = (5e-6, 2e-5)  # chip_smoke.SMALL_RENDER_TOL["f32"]


# ---- the kernel's index formulas, restated ----

def ptx_a(lane, reg):
    """(row, k) of a tf32 m64k8 A-fragment element within a warp's 16 rows
    (PTX ISA: register i of lane 4 g + t holds row g + 8 (i % 2), column
    t + 4 (i // 2))."""
    g, t = lane // 4, lane % 4
    return g + 8 * (reg % 2), t + 4 * (reg // 2)


def ptx_d(lane, reg):
    """(row, column) of an m64nN float32 accumulator element within a
    warp's 16 rows (register 4 j + 2 h + i: row g + 8 h, column
    8 j + 2 t + i)."""
    g, t = lane // 4, lane % 4
    j, h, i = reg // 4, (reg // 2) % 2, reg % 2
    return g + 8 * h, 8 * j + 2 * t + i


@pytest.mark.parametrize("width", [128, 64, 32])
def test_hidden_order_puts_each_accumulator_in_its_own_fragment(width):
    """relu_frags moves accumulator register 4 j + 2 h + e to fragment
    register h + 2 e of k-step j: same lane, same row, and the fragment's
    column there holds (by ``hidden_order``) the accumulator's unit.
    The encoding reads units 8 s + 2 t + {0, 1}: one float2 a k-step."""
    order = hidden_order(width).tolist()
    assert sorted(order) == list(range(width))
    for s in range(width // 8):
        assert sorted(order[8 * s:8 * s + 8]) == list(range(8 * s, 8 * s + 8))
    for lane in range(32):
        for j in range(width // 8):
            for h in range(2):
                for e in range(2):
                    row_d, unit = ptx_d(lane, 4 * j + 2 * h + e)
                    row_a, col = ptx_a(lane, h + 2 * e)
                    assert row_a == row_d
                    assert order[8 * j + col] == unit == 8 * j + 2 * (lane % 4) + e


def _unpack(flat, K, N):
    """A (K, N) matrix of prepare_render_f32's layout, by its element
    formula."""
    out = torch.empty((K, N), dtype=flat.dtype)
    for k in range(K):
        for n in range(N):
            out[k, n] = flat[((n // 8) * (K // 4) + k // 4) * 32 + (n % 8) * 4 + k % 4]
    return out


def test_layout_matches_the_descriptor_offsets():
    """Element (k, n) of a B operand of prepare_render_f32 (of w2 here)
    lies in core matrix (k // 4, n // 8) of 8 rows x 16 bytes at byte 128
    (k // 4) + 32 K (n // 8): the kernel's descriptor steps 256 bytes a
    k-step (two core matrices, leading byte offset 128) and 32 K bytes an
    N-group (the stride byte offset)."""
    K = 32
    w = torch.arange(K * K, dtype=torch.float32).reshape(K, K)
    b = trk.prepare_render_f32(torch.zeros(K, K), w, torch.zeros(K, K))
    flat, m = b[K * K:2 * K * K], w[hidden_order(K)]
    assert torch.equal(_unpack(flat, K, K), m)
    for k in range(K):
        for n in range(K):
            byte = 4 * int((flat == m[k, n]).nonzero())
            assert byte == 256 * (k // 8) + 128 * ((k % 8) // 4) + 32 * K * (n // 8) \
                + 16 * (n % 8) + 4 * (k % 4)


def test_ring_slot_holds_its_chunk_in_the_cut_layout():
    """make_lo_chunk at width 128: 16-byte word q of chunk c's slot (CK
    k-steps, KG = 2 CK core matrices a column group) comes from word
    ((q / 8 KG) W / 4 + KG c + (q / 8) % KG) 8 + q % 8 of the raw B, and
    holds the elements the slot's layout (the matrix's, cut to the chunk's
    8 CK rows: stride byte offset 128 KG) puts there, every element of the
    chunk once."""
    W, KG = 128, 2 * CK
    for c in range(W // (8 * CK)):
        seen = set()
        for q in range(KG * W):
            raw_q = ((q // (8 * KG)) * (W // 4) + KG * c + (q // 8) % KG) * 8 + q % 8
            for i in range(4):
                word = 4 * raw_q + i  # (k, n) of the raw word, by _unpack's formula
                n = (word // 32 // (W // 4)) * 8 + (word % 32) // 4
                k = ((word // 32) % (W // 4)) * 4 + word % 4
                slot = 4 * q + i
                assert (k - 8 * CK * c, n) == (((slot // 32) % KG) * 4 + slot % 4,
                                               (slot // (32 * KG)) * 8 + (slot % 32) // 4)
                seen.add((k, n))
        assert len(seen) == 8 * CK * W


def test_prepare_permutes_rows_so_the_mlp_is_unchanged():
    """prepare_render_f32 lays out w1, w2 and w3 (columns at n = 0, 2, 4,
    6 of 8) with rows permuted by hidden_order; an MLP
    on integer values (exact float32 sums) through the permuted operands,
    each layer's output read in the kernel's fragment order, equals the
    unpermuted one bit for bit."""
    W = 32
    rng = np.random.default_rng(3)
    w1, w2, w3 = (torch.from_numpy(rng.integers(-4, 5, (W, W)).astype(np.float32))
                  for _ in range(3))
    b = trk.prepare_render_f32(w1, w2, w3)
    assert b.shape == (2 * W * W + 8 * W,) and b.dtype == torch.float32
    m1 = _unpack(b[:W * W], W, W)
    m2 = _unpack(b[W * W:2 * W * W], W, W)
    m3 = _unpack(b[2 * W * W:], W, 8)
    order = hidden_order(W)
    assert torch.equal(m1, w1[order]) and torch.equal(m2, w2[order])
    assert torch.equal(m3[:, 0::2], w3[order, :4])
    assert not m3[:, 1::2].any()
    enc = torch.from_numpy(rng.integers(-3, 4, (40, W)).astype(np.float32))
    df = torch.from_numpy(rng.integers(-9, 10, (40, W)).astype(np.float32))
    h = torch.relu(enc[:, order] @ m1)
    h = torch.relu(h[:, order] @ m2 + df)
    got = (h[:, order] @ m3)[:, 0::2]
    want = torch.relu(torch.relu(enc @ w1) @ w2 + df) @ w3[:, :4]
    assert torch.equal(got, want)


def test_tf32_lo_carries_what_the_tensor_cores_cut():
    """trunc(x) is x's top 19 bits; x - trunc(x) is exact in float32;
    tf32_lo(x) is that rest rounded to TF32: x = trunc(x) + tf32_lo(x)
    exactly wherever the rest is a TF32 value (bf16 values: lo = 0), and
    within 2^-21 |x| everywhere."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.choice([-1.0, 1.0], 20000) * rng.uniform(1, 2, 20000)
                          * 2.0 ** rng.integers(-30, 30, 20000)).astype(np.float32))
    hi, lo = trunc(x), tf32_lo(x)
    assert torch.equal(trunc(hi), hi) and torch.equal(trunc(lo), lo)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    rest = x - hi
    assert torch.equal(rest.double(), x.double() - hi.double())
    assert (rest.abs() < 2.0 ** -10 * x.abs()).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    exact = trunc(rest) == rest
    assert exact.any() and (~exact).any()
    assert (err[exact] == 0).all() and (err[~exact] > 0).all()
    b = x.to(torch.bfloat16).float()
    assert torch.equal(trunc(b), b) and not tf32_lo(b).any()


def test_f32_matmul_is_float32_grade():
    """The model's product against float64 on random float32 operands of
    K 128: within 8 float32 ulps of the sum of |products| (the library's
    FMAs in k order may lie up to K / 2 ulps off)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (64, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 32)) * 0.1).astype(np.float32))
    got = f32_matmul(x, w).double()
    exact = x.double() @ w.double()
    scale = x.double().abs() @ w.double().abs()
    assert float(((got - exact).abs() / scale).max()) <= 8 * 2.0 ** -24


def _case(kind, N=64, n_samples=16, chunk=4):
    """test_torch_cuda._render_case's operands on the CPU at a smaller N:
    (width, float32 weights, (oe, de, df), keywords of
    render_plain_counted)."""
    rng = np.random.default_rng(20)
    width = 64 if "w64" in kind else 32 if "w32" in kind else 128
    hot = kind.startswith("hot")
    block = 48 if width == 128 else 80
    p = {k: (rng.standard_normal((width, width)) * 0.1).astype(np.float32)
         for k in ("w1", "w2", "w3")}
    oe = rng.uniform(-3, 3, (N, width)).astype(np.float32)
    de = rng.uniform(-2, 2, (N, width)).astype(np.float32)
    oe[:, 0], de[:, 0] = np.pi / 2, 0.0  # the constant-one lane
    df = (rng.standard_normal((N, width)) * 0.1).astype(np.float32)
    if hot:
        mul, add = {128: (1.0, 0.05), 64: (6.0, 0.3), 32: (25.0, 1.2)}[width]
        p["w3"][:, 0] = np.abs(p["w3"][:, 0]) * mul + add
        df[(np.arange(N) // 50) % 2 == 0] += 0.5
    flags = rng.uniform(size=(-(-N // block), n_samples // chunk)) > 0.3
    kw = dict(width=width, n_samples=n_samples, chunk=chunk, near=2.0, far=6.0,
              jitter=0.37, block=block, packed=width != 128,
              flags=None if hot else torch.from_numpy(flags.astype(np.int32)),
              early_stop_eps=1e-3 if hot else 0.0)
    ws = [torch.from_numpy(p[k]) for k in ("w1", "w2", "w3")]
    return ws, [torch.from_numpy(a) for a in (oe, de, df)], kw


def _errors(got, want):
    return (float((got[0] - want[0]).abs().max()),
            float((got[1] - want[1]).abs().max()))


@pytest.mark.parametrize("kind", ["f32", "hot", "w64", "hot_w64", "w32", "hot_w32"])
def test_kernel_mlp_render_within_the_card_tolerances(kind):
    """A render through the model of the kernel's sums against the plain
    version on test_torch_cuda's small cases (the hot ones stop early)."""
    ws, (oe, de, df), kw = _case(kind)
    got = trk.render_plain_counted(oe, de, df, kernel_head(*ws), **kw)
    want = trk.render_plain_counted(
        oe, de, df, trk.float_mlp_head(*ws, kw["packed"]), **kw)
    assert got[2] == want[2] and float(want[0].max()) > 0.05
    if kind.startswith("hot"):
        assert want[2] < oe.shape[0] * 16  # the early stop fired
    rgb_err, depth_err = _errors(got, want)
    assert rgb_err <= CARD_TOL[0] / 4 and depth_err <= CARD_TOL[1] / 4


def _sphere_rays(width, n_rays=24):
    """The committed sphere field at ``width`` (bf16 weights, as float32)
    and (oe, de, df) of rays of bench_nerf.py's orbit camera."""
    from spnerf_tpu_torch.data.nerf_dataset import camera_intrinsics
    from spnerf_tpu_torch.models import fused_tiny_nerf as tft
    from spnerf_tpu_torch.models.nerf import camera_rays
    from spnerf_tpu_torch.tasks.nerf_task import pose_orbit
    from spnerf_tpu_torch.tools.import_jax_weights import tiny_field_from_jax
    from spnerf_tpu_torch.tools.kernel_times import FIELD_DIR, RENDER_FIELDS

    side = 362
    K = torch.from_numpy(camera_intrinsics((side, side), 60.0))
    pose = torch.from_numpy(pose_orbit(8, radius=4.0, height=0.4)[0])
    o, d = camera_rays((side, side), K, pose)
    pick = torch.arange(0, side * side, side * side // n_rays)[:n_rays]
    o, d = o[pick], d[pick]
    with np.load(FIELD_DIR / RENDER_FIELDS[width][0]) as data:
        params = tiny_field_from_jax({k: data[k] for k in data.files}, "cpu",
                                     torch.bfloat16)
    params = {k: v.float() for k, v in params.items()}
    cfg = tft.TinyFieldConfig(n_samples=32, width=width)
    A, c = (torch.from_numpy(t) for t in tft.make_encoding(cfg))
    oe, de = tft.encode_rays(o, d, A, c)
    df = tft.direction_features(params, d, A, c)
    return [params[k] for k in ("w1", "w2", "w3")], (oe, de, df), cfg


@pytest.mark.parametrize("width", [128, 64, 32])
def test_kernel_mlp_on_the_sphere_fields(width):
    """The committed sphere fields (bf16 weights as float32: lo(w) = 0,
    lo(x) carries the activations' rest) on orbit rays at 32 samples,
    chunks of 4 samples and the early stop, as chip_smoke's render_small
    renders them: within its card-against-CPU tolerances."""
    ws, (oe, de, df), cfg = _sphere_rays(width)
    kw = dict(width=width, n_samples=32, chunk=4, near=cfg.near, far=cfg.far,
              jitter=0.5, block=64, flags=None, early_stop_eps=1e-3,
              packed=width != 128)
    got = trk.render_plain_counted(oe, de, df, kernel_head(*ws), **kw)
    want = trk.render_plain_counted(
        oe, de, df, trk.float_mlp_head(*ws, kw["packed"]), **kw)
    assert got[2] == want[2] and float(want[0].max()) > 0.05
    rgb_err, depth_err = _errors(got, want)
    assert rgb_err <= SMALL_TOL[0] / 2 and depth_err <= SMALL_TOL[1] / 2
