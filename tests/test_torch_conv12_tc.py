"""Row 1 on the int8 tensor cores (``csrc/conv12_fused.cu`` over
``csrc/conv_tc_s8.cuh``), on the CPU.

* The operand layouts of ``prepare_conv12``, read back by the kernel's
  address formulas: the K-padded f16 conv1 slab (16 x 64) and the nine
  int8 conv2 slabs (64 x 64), both ``pack_slabs`` K-major core matrices
  of 8 output channels x 16 bytes.
* The K-padded conv1 product (each mid position's 9 quantized image taps
  and 7 zeros, times the slab, in float32 as the f16 tensor cores sum)
  against ``F.conv2d`` of the quantized image.
* The mid tile in planes of 16 channels (``conv_tc_s8.cuh``'s A layout):
  every byte once, conv1's stores free of bank conflicts, and each core
  matrix of conv2's A descriptor 128 contiguous bytes.
* The kernel's whole tile in plain PyTorch (the conv1 A rows built from
  the image window, the mid planes, conv2's A rows by the descriptor's
  core matrices over 8 x 8 output blocks and the taps' shifts, the pool
  partners of a lane) equals ``conv12_fused_plain`` at ragged shapes.
* Prepared operands run the plain version and give the raw calls' bits;
  ``ServingSuperPoint`` prepares conv12's operands once, when it is built,
  and with them equals the JAX package in int8 and mixed modes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _serving_cases as C
from spnerf_tpu_torch.kernels import conv12_fused as K
from spnerf_tpu_torch.kernels.requant import affine, cast_int8

TH, TW = 16, 32  # the kernel's output tile
MW, IW = TW + 2, TW + 4  # mid tile and image window widths
NMID = (TH + 2) * MW
PLANE = NMID * 16  # bytes of a mid plane (16 channels)


def _raw(seed, B=1, H=20, W=40):
    rng = np.random.default_rng(seed)
    s1 = np.float32(0.02)
    t = torch.from_numpy
    image = t(rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32))
    raw = (t((rng.standard_normal((3, 3, 1, 64)) * 0.3).astype(np.float32)),
           t(np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1))),
           t((rng.standard_normal(64) * 0.1 / s1).astype(np.float32)),
           t(rng.integers(-127, 128, (3, 3, 64, 64)).astype(np.int8)),
           t(rng.uniform(1e-4, 6e-4, 64).astype(np.float32)),
           t(rng.uniform(-20, 20, 64).astype(np.float32)))
    return image, raw


def _slab(packed, cin, cout=64):
    """(cin, cout) slab read by the kernel's formula: e = 16 bytes of K
    (16 int8 or 8 f16 values), element (k, n) at ((n // 8) * (cin // e) +
    k // e) * 8 e + (n % 8) * e + k % e."""
    e = 16 // packed.element_size()
    k = torch.arange(cin)[:, None]
    n = torch.arange(cout)[None, :]
    off = ((n // 8) * (cin // e) + k // e) * 8 * e + (n % 8) * e + k % e
    return packed.reshape(-1)[off]


def test_conv1_slab_layout():
    _, raw = _raw(1)
    ops = K.prepare_conv12(*raw)
    kq1, s1w = K.quantize_conv1_weights(raw[0])
    assert ops.k1p.dtype == torch.float16 and ops.k1p.numel() == 16 * 64
    got = _slab(ops.k1p, 16)
    assert torch.equal(got[:9], kq1.reshape(9, 64).to(torch.float16))
    assert torch.equal(got[:9].to(torch.int8), kq1.reshape(9, 64))
    assert not got[9:].any()
    assert torch.equal(ops.m1, raw[1].float() * s1w)


def test_w2_slab_layout():
    _, raw = _raw(2)
    ops = K.prepare_conv12(*raw)
    assert ops.w2p.dtype == torch.int8 and ops.w2p.numel() == 9 * 64 * 64
    slabs = ops.w2p.reshape(9, -1)
    for tap in range(9):
        assert torch.equal(_slab(slabs[tap], 64), raw[3][tap // 3, tap % 3])


def _conv1_rows(win, q, mw=MW):
    """The kernel's conv1 A rows for mid positions ``q`` (rows mw wide):
    tap k = 3 dy + dx of position (r, c) is window pixel (r + dy, c + dx),
    k 9-15 zero."""
    r, c = q // mw, q % mw
    a = torch.zeros(len(q), 16, dtype=torch.int64)
    for k in range(9):
        a[:, k] = win[r + k // 3, c + k % 3]
    return a


@pytest.mark.parametrize("H,W", [(7, 13), (16, 32), (20, 40)])
def test_k_padded_conv1_product_matches_conv2d(H, W):
    image, raw = _raw(3 + H, 1, H, W)
    ops = K.prepare_conv12(*raw)
    kq1, _ = K.quantize_conv1_weights(raw[0])
    xq = K.quantize_image(image)[0, ..., 0].to(torch.int64)
    win = F.pad(xq, (1, 1, 1, 1))  # one window covering the image
    # float32 sums of f16 products, in the tensor cores' k order
    acc = _conv1_rows(win, torch.arange(H * W), W).float() @ _slab(
        ops.k1p, 16).float()
    want = F.conv2d(xq[None, None].double(),
                    kq1.double().permute(2, 0, 1)[:, None], padding=1)
    assert torch.equal(acc.double().reshape(H, W, 64),
                       want[0].permute(1, 2, 0))


def _mid_offset(q, ch):
    """Byte of channel ch of mid position q: plane ch // 16, 16 q."""
    return (ch // 16) * PLANE + q * 16 + ch % 16


def test_mid_planes_layout():
    q = torch.arange(NMID)[:, None]
    ch = torch.arange(64)[None, :]
    off = _mid_offset(q, ch)
    assert torch.equal(torch.sort(off.reshape(-1)).values,
                       torch.arange(NMID * 64))
    # conv1's stores: lane (g, tq) writes channels 8 j + 2 tq, + 1 of mid
    # position q0 + g; for each j, 16 different 4-byte banks (the lanes
    # tq and tq ^ 1 share a word)
    for q0 in (0, 5, 577):
        for j in range(8):
            words = {int(_mid_offset(q0 + g, 8 * j + 2 * tq)) // 4
                     for g in range(8) for tq in range(4)}
            assert len(words) == 16 and len({w % 32 for w in words}) == 16
    # conv2's A: core matrix i of the block at tile pixel p0 (tap
    # included) is 8 consecutive pixels of one plane, 128 bytes
    for p0 in (0, 1, 35, 8 * MW + 24):
        for i in range(8):
            rows = _mid_offset(p0 + i * MW + torch.arange(8), 16)
            assert torch.equal(rows - rows[0], torch.arange(8) * 16)


def _out_pixel(row):
    """Tile output (y, x) of conv2's M-row ``row``: M-tile row // 64 is
    the 8 x 8 block (mt // 4, mt % 4), row % 64 its pixel in row order."""
    mt, r = row // 64, row % 64
    return 8 * (mt // (TW // 8)) + r // 8, 8 * (mt % (TW // 8)) + r % 8


def _tile(xq, ops, b, y0, x0, relu, pool, out):
    """One output tile as the kernel computes it, into ``out``."""
    H, W = xq.shape[1:]
    win = torch.zeros(TH + 4, IW, dtype=torch.int64)
    ys, xs = slice(max(y0 - 2, 0), min(y0 + TH + 2, H)), \
        slice(max(x0 - 2, 0), min(x0 + TW + 2, W))
    win[ys.start - (y0 - 2):ys.stop - (y0 - 2),
        xs.start - (x0 - 2):xs.stop - (x0 - 2)] = xq[b, ys, xs]
    # conv1 over 10 M-tiles (rows past NMID clamped, then dropped)
    q = torch.clamp(torch.arange(640), max=NMID - 1)
    acc1 = _conv1_rows(win, q).float() @ _slab(ops.k1p, 16).float()
    v = cast_int8(affine(acc1[:NMID], ops.m1, ops.b1, True))
    q = torch.arange(NMID)
    gy, gx = y0 - 1 + q // MW, x0 - 1 + q % MW
    v[(gy < 0) | (gy >= H) | (gx < 0) | (gx >= W)] = 0
    mid = torch.zeros(NMID * 64, dtype=torch.int8)
    ch = torch.arange(64)
    mid[_mid_offset(q[:, None], ch[None])] = v
    # conv2: M-row m reads the planes at mid pixel p0 + tap shift
    m = torch.arange(TH * TW)
    ty, tx = _out_pixel(m)
    p0 = ty * MW + tx
    cols = []
    for tap in range(9):
        p = p0 + (tap // 3) * MW + tap % 3
        cols.append(mid[_mid_offset(p[:, None], ch[None])])
    a2 = torch.cat(cols, 1).to(torch.int64)
    w2 = torch.cat([_slab(s, 64) for s in ops.w2p.reshape(9, -1)])
    acc2 = a2 @ w2.to(torch.int64)
    if pool:  # lane g's rows m (top) and m + 8, its partner lane g ^ 1:
        # the sums' max where mult >= 0, their min below, then one affine
        top = m[(m % 16 < 8) & (m % 2 == 0)]
        quad = torch.stack([acc2[top], acc2[top + 8], acc2[top ^ 1],
                            acc2[(top ^ 1) + 8]])
        pooled = torch.where(ops.m2 >= 0, quad.amax(0), quad.amin(0))
        p = affine(pooled.float(), ops.m2, ops.b2, relu)
        oy, ox = (y0 + ty[top]) // 2, (x0 + tx[top]) // 2
        keep = (oy < H // 2) & (ox < W // 2)
        out[b, oy[keep], ox[keep]] = cast_int8(p[keep])
    else:
        y = affine(acc2.float(), ops.m2, ops.b2, relu)
        gy, gx = y0 + ty, x0 + tx
        keep = (gy < H) & (gx < W)
        out[b, gy[keep], gx[keep]] = cast_int8(y[keep])


@pytest.mark.parametrize("shape,pool,relu", [
    ((1, 20, 40), True, True), ((2, 18, 36), True, False),
    ((1, 7, 13), False, True)])
def test_kernel_tile_emulation_matches_plain(shape, pool, relu):
    image, raw = _raw(10 + shape[1], *shape)
    ops = K.prepare_conv12(*raw)
    B, H, W = shape
    xq = K.quantize_image(image)[..., 0].to(torch.int64)
    out = torch.zeros((B, H // 2, W // 2, 64) if pool else (B, H, W, 64),
                      dtype=torch.int8)
    for b in range(B):
        for y0 in range(0, H, TH):
            for x0 in range(0, W, TW):
                _tile(xq, ops, b, y0, x0, relu, pool, out)
    want = K.conv12_fused_plain(image, *raw, relu=relu, pool=pool)
    assert torch.equal(out, want)
    assert (want > 0).any()


@pytest.mark.parametrize("pool,relu", [(True, True), (False, True),
                                       (True, False)])
def test_prepared_conv12_equals_raw(pool, relu):
    image, raw = _raw(20, 2, 8, 14)
    ops = K.prepare_conv12(*raw)
    assert ops.raw == raw
    got = K.conv12_fused(image, ops, relu=relu, pool=pool)
    assert got.dtype == torch.int8 and got.shape == (
        (2, 4, 7, 64) if pool else (2, 8, 14, 64))
    assert torch.equal(got, K.conv12_fused(image, *raw, relu=relu, pool=pool))
    assert torch.equal(got, K.conv12_fused_plain(image, ops, relu=relu,
                                                 pool=pool))


def test_conv12_raises_on_what_it_does_not_take():
    image, raw = _raw(21, 1, 7, 13)
    with pytest.raises(ValueError, match="even"):
        K.conv12_fused(image, *raw, pool=True)
    with pytest.raises(ValueError, match="int8"):
        K.prepare_conv12(*raw[:3], raw[3].float(), *raw[4:])


@pytest.fixture(scope="module")
def variables():
    return C.jax_variables()


@pytest.mark.parametrize("mode", ["int8", "mixed"])
def test_serving_prepares_conv12_once_and_matches_jax(variables, mode,
                                                      monkeypatch):
    """The int8 and mixed graphs prepare conv12's operands when they are
    built and never on a call; two calls give the same bits and the JAX
    package's outputs, keypoints and descriptors within the bounds of
    ``_serving_cases``."""
    from spnerf_tpu_torch.ops import fast_inference as tfi
    from spnerf_tpu_torch.ops import serving
    from spnerf_tpu_torch.tools.import_jax_weights import serving_from_folded

    ref = C.jax_case(variables, mode, True, True, 64)
    prepared = []
    monkeypatch.setattr(serving, "prepare_conv12", lambda *a: (
        prepared.append(a), K.prepare_conv12(*a))[1])
    raw_calls = []
    monkeypatch.setattr(serving, "conv12_fused", lambda x, ops, **kw: (
        raw_calls.append(type(ops)), K.conv12_fused(x, ops, **kw))[1])
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             mode=mode)
    assert len(prepared) == 1
    x = torch.from_numpy(ref["x"])
    out = sp(x, softmax=True)
    again = sp(x, softmax=True)
    assert len(prepared) == 1
    assert raw_calls == [K.Conv12Operands] * 2
    for key in out:
        assert torch.equal(out[key], again[key])
    n_all = ref["n_all"]
    dets = tfi.detect_from_probs_padded(
        out["probs"], 8, min_prob=C.THRESH, size=4, num_candidates=n_all,
        top_k=n_all, compact=False)
    C.check_outputs(ref, out)
    C.check_keypoints(ref, dets)
    C.check_descriptors(ref, out)
