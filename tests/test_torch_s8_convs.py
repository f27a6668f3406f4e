"""The int8 instances of ``double_conv3x3`` (rows 2-3) and ``head`` (row
4) on the int8 tensor cores (``csrc/double_conv3x3.cu``, ``csrc/head.cu``
over ``csrc/conv_tc_s8.cuh``), on the CPU.

* The weight layouts of ``prepare_double_conv`` and ``prepare_head``,
  read back by the kernels' descriptor formulas: the 3x3 tap slabs
  (``pack_slabs``, core matrices of 8 output channels x 16 bytes, the
  64-channel chunks 64 C_in bytes apart) and the head's 1x1 slabs (one
  256 x 80 slab for the detector, two 128 x 256 K-halves for the
  descriptor).
* The A operand in planes of 16 channels: a core matrix is 128
  contiguous bytes both for conv_a's rows in row order (stride byte
  offset 128) and for an 8 x 8 block (one tile row).
* Each kernel's whole tile emulated in plain PyTorch from those address
  formulas (conv_a's M-tiles over the input tile's pitch with the columns
  past the mid and the rows past its last dropped, the mid planes zero
  outside the image, conv_b's 8 x 8 blocks, the pool on int32 sums taking
  the max or the min by the multiplier's sign, ``relu=False``; the
  head's 8 x 8 cell blocks, its mid planes and the 1x1 over the slabs)
  equals ``double_conv3x3_plain`` / ``head_plain``.
* Prepared double-conv operands give the raw calls' bits;
  ``ServingSuperPoint`` prepares blocks 3-4, 5-6 and 7-8 once, when it is
  built, and with them equals the JAX package in int8 (bit for bit) and
  mixed modes.
"""

import numpy as np
import pytest
import torch

import _serving_cases as C
from _torch_port import bf16_ulp_diff
from spnerf_tpu_torch.kernels import mid_fused as M
from spnerf_tpu_torch.kernels import tail_fused as T
from spnerf_tpu_torch.kernels.requant import affine, cast_int8

OH, OW = 16, 16  # the double conv's output tile


def _i8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


def _f32(rng, shape, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _dc_raw(rng, cin, cm, co, mult_b=(5e-5, 4e-4)):
    return (_i8(rng, (3, 3, cin, cm)), _f32(rng, cm, 5e-5, 4e-4),
            _f32(rng, cm, -20, 20), _i8(rng, (3, 3, cm, co)),
            _f32(rng, co, *mult_b), _f32(rng, co, -20, 20))


def _core_addr(m, k, sbo, lbo):
    """Byte of element (row m, K index k) of a K-major operand without
    swizzle: core matrix (m // 8, k // 16) at (m // 8) sbo + (k // 16)
    lbo, 8 rows of 16 bytes."""
    return (m // 8) * sbo + (m % 8) * 16 + (k // 16) * lbo + k % 16


def _slab(packed, cin, n0, n):
    """(cin, n) B operand from ``packed`` (one tap's slab) read by the
    kernels' descriptor: 64-channel chunk n0 // 64 at 64 cin bytes, then
    leading byte offset 128, stride byte offset 8 cin."""
    k = torch.arange(cin)[:, None]
    col = torch.arange(n)[None, :]
    off = (n0 // 64) * 64 * cin + _core_addr(col, k, 8 * cin, 128)
    return packed.reshape(-1)[off]


def test_double_conv_slabs_read_back():
    rng = np.random.default_rng(1)
    for cin, cm, co in ((64, 64, 64), (64, 128, 128), (128, 128, 128)):
        raw = _dc_raw(rng, cin, cm, co)
        ops = M.prepare_double_conv(*raw)
        assert ops.raw == raw
        for w, wp, ci, c in ((raw[0], ops.wap, cin, cm),
                             (raw[3], ops.wbp, cm, co)):
            assert wp.dtype == torch.int8 and wp.numel() == 9 * ci * c
            slabs = wp.reshape(9, -1)
            for tap in range(9):
                for n0 in range(0, c, 64):
                    assert torch.equal(_slab(slabs[tap], ci, n0, 64),
                                       w[tap // 3, tap % 3][:, n0:n0 + 64])
        assert ops.ma.dtype == torch.float32 and torch.equal(ops.mb, raw[4])


def test_head_slabs_read_back():
    rng = np.random.default_rng(2)
    for cout, coutp in ((65, 80), (256, 256)):
        raw = _head_raw(rng, cout)
        ops = T.prepare_head(*raw)
        assert ops.coutp == coutp and ops.w1p.numel() == 256 * coutp
        slabs = ops.w3p.reshape(9, -1)
        for tap in range(9):
            for n0 in range(0, 256, 64):
                assert torch.equal(_slab(slabs[tap], 128, n0, 64),
                                   raw[0][tap // 3, tap % 3][:, n0:n0 + 64])
        w1 = _head_1x1(ops)
        assert torch.equal(w1[:, :cout], raw[3])
        assert not w1[:, cout:].any()
        assert not ops.m1p[cout:].any() and torch.equal(ops.m1p[:cout],
                                                        raw[4])


def test_planes_give_contiguous_core_matrices():
    """An A core matrix is 8 pixels x 16 bytes of one plane: 128
    contiguous bytes for conv_a's row order (8 consecutive input pixels)
    and for a row of an 8 x 8 block (stride one tile row); every (pixel,
    channel) of a tile has one byte."""
    n, cin = 20 * 36, 64
    plane = n * 16
    p = torch.arange(n)[:, None]
    ch = torch.arange(cin)[None, :]
    off = (ch // 16) * plane + p * 16 + ch % 16
    assert torch.equal(torch.sort(off.reshape(-1)).values,
                       torch.arange(n * cin))
    m = torch.arange(64)
    for sbo, start in ((128, 16 * 37), (36 * 16, 16 * (2 * 36 + 8))):
        for kk in range(cin // 16):
            a = start + _core_addr(m, 16 * kk, sbo, plane)
            for i in range(8):
                rows = a[8 * i:8 * i + 8]
                assert torch.equal(rows - rows[0], torch.arange(8) * 16)
                assert int(rows[0]) == start + i * sbo + kk * plane


def _planes(pix, n_alloc):
    """(n, C) int8 pixels -> the flat planes of 16 channels (plane c at
    c * 16 n, pixel p at 16 p), with ``n_alloc`` zero bytes after them (the
    kernel's last rows read past the tile)."""
    n, c = pix.shape
    buf = pix.reshape(n, c // 16, 16).permute(1, 0, 2).reshape(-1)
    return torch.cat([buf, torch.zeros(n_alloc, dtype=torch.int8)])


def _window(x, b, y0, x0, th, tw):
    """th x tw pixels of image b from (y0, x0), zero outside."""
    H, W = x.shape[1:3]
    out = torch.zeros((th, tw, x.shape[-1]), dtype=torch.int8)
    ys = slice(max(y0, 0), min(y0 + th, H))
    xs = slice(max(x0, 0), min(x0 + tw, W))
    out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = x[b, ys, xs]
    return out


def _tap_conv(buf, starts, tw, plane, sbo, cin, slabs, n0, n):
    """int64 sums of one M-tile and channels n0 .. n0 + n over the 9
    taps, A read at ``starts`` (the M-tile's byte of row 0) plus each
    tap's shift, B from the tap slabs."""
    m = torch.arange(64)[:, None]
    k = torch.arange(cin)[None, :]
    acc = torch.zeros(64, n, dtype=torch.int64)
    for tap in range(9):
        shift = ((tap // 3) * tw + tap % 3) * 16
        a = buf[starts + shift + _core_addr(m, k, sbo, plane)]
        acc += a.long() @ _slab(slabs[tap], cin, n0, n).long()
    return acc


def _dc_tile(x, ops, inst, b, y0, x0, relu, out):
    """One output tile as ``double_conv3x3_s8_kernel`` computes it."""
    cin, cm, co, pool = inst
    H, W = x.shape[1:3]
    IW, MW = OW + 4, OW + 2
    NIN, NMID = (OH + 4) * IW, (OH + 2) * MW
    NA = (OH + 1) * IW + MW
    MTA = -(-NA // 64)
    pin, pmid = NIN * 16, NMID * 16
    inp = _planes(_window(x, b, y0 - 2, x0 - 2, OH + 4, IW).reshape(NIN, cin),
                  (MTA * 64 + 2 * IW + 2) * 16)
    # conv_a over the input pitch: row p is mid (p // IW, p % IW)
    mid = torch.zeros(cm // 16 * pmid, dtype=torch.int8)
    slabs_a = ops.wap.reshape(9, -1)
    for mt in range(MTA):
        for n0 in range(0, cm, 64):
            acc = _tap_conv(inp, mt * 64 * 16, IW, pin, 128, cin, slabs_a,
                            n0, 64)
            p = mt * 64 + torch.arange(64)
            r, c = p // IW, p % IW
            keep = (p < NA) & (c < MW)
            v = cast_int8(affine(acc.float(), ops.ma[n0:n0 + 64],
                                 ops.ba[n0:n0 + 64], True))
            gy, gx = y0 - 1 + r, x0 - 1 + c
            v[(gy < 0) | (gy >= H) | (gx < 0) | (gx >= W)] = 0
            q = (r * MW + c)[keep][:, None]
            ch = n0 + torch.arange(64)[None, :]
            mid[(ch // 16) * pmid + q * 16 + ch % 16] = v[keep]
    mid = torch.cat([mid, torch.zeros(64, dtype=torch.int8)])
    # conv_b over 8 x 8 blocks: row m is output (8 by + m // 8, 8 bx + m % 8)
    slabs_b = ops.wbp.reshape(9, -1)
    m = torch.arange(64)
    for mt in range(OH * OW // 64):
        by, bx = mt // (OW // 8), mt % (OW // 8)
        start = ((by * 8) * MW + bx * 8) * 16
        for n0 in range(0, co, 64):
            acc = _tap_conv(mid, start, MW, pmid, MW * 16, cm, slabs_b, n0, 64)
            mb, bb = ops.mb[n0:n0 + 64], ops.bb[n0:n0 + 64]
            y, xx = y0 + 8 * by + m // 8, x0 + 8 * bx + m % 8
            if pool:
                # lane g's rows m and m + 8 (block rows 2 w, 2 w + 1), its
                # partner lane g ^ 1: the int32 sums' max where the
                # multiplier is >= 0, min below, then one affine
                top = m[(m % 16 < 8) & (m % 2 == 0)]
                quad = torch.stack([acc[top], acc[top + 8], acc[top ^ 1],
                                    acc[(top ^ 1) + 8]])
                pooled = torch.where(mb >= 0, quad.amax(0), quad.amin(0))
                oy, ox = y[top] // 2, xx[top] // 2
                keep = (oy < H // 2) & (ox < W // 2)
                out[b, oy[keep], ox[keep], n0:n0 + 64] = cast_int8(
                    affine(pooled.float(), mb, bb, relu))[keep]
            else:
                keep = (y < H) & (xx < W)
                out[b, y[keep], xx[keep], n0:n0 + 64] = cast_int8(
                    affine(acc.float(), mb, bb, relu))[keep]


@pytest.mark.parametrize("inst,shape,relu,neg", [
    ((64, 64, 64, True), (1, 34, 62), True, True),
    ((64, 128, 128, True), (1, 18, 34), False, True),
    ((128, 128, 128, False), (1, 7, 13), True, False),
    ((128, 128, 128, True), (2, 18, 20), False, True)])
def test_double_conv_tile_emulation_matches_plain(inst, shape, relu, neg):
    cin, cm, co, pool = inst
    rng = np.random.default_rng(30 + shape[1] + cm)
    raw = _dc_raw(rng, cin, cm, co, (-4e-4, 4e-4) if neg else (5e-5, 4e-4))
    ops = M.prepare_double_conv(*raw)
    x = _i8(rng, (*shape, cin), 0, 128)
    B, H, W = shape
    out = torch.zeros((B, H // 2, W // 2, co) if pool else (B, H, W, co),
                      dtype=torch.int8)
    for b in range(B):
        for y0 in range(0, H, OH):
            for x0 in range(0, W, OW):
                _dc_tile(x, ops, inst, b, y0, x0, relu, out)
    want = M.double_conv3x3_plain(x, *raw, relu=relu, pool=pool)
    assert torch.equal(out, want)
    assert (want > 0).any() and (relu or (want < 0).any())
    if neg:
        assert (ops.mb < 0).any() and (ops.mb > 0).any()


def _head_raw(rng, cout):
    return (_i8(rng, (3, 3, 128, 256)), _f32(rng, 256, 5e-5, 4e-4),
            _f32(rng, 256, -20, 20), _i8(rng, (256, cout)),
            _f32(rng, cout, 2e-5, 1e-4), _f32(rng, cout, -1, 1))


def _head_1x1(ops):
    """(256, coutp) 1x1 weights read from the head's slabs by the
    kernel's descriptors: N 80, one slab (stride byte offset 2,048); N 256,
    k-steps 0-3 in the first 128 x 256 K-half, 4-7 in the second (stride
    byte offset 1,024, a 64-channel chunk 8,192 bytes)."""
    k = torch.arange(256)[:, None]
    n = torch.arange(ops.coutp)[None, :]
    if ops.coutp == 80:
        off = _core_addr(n, k, 2048, 128)
    else:
        off = (k // 128) * 128 * 256 + (n // 64) * 8192 + _core_addr(
            n % 64, k % 128, 1024, 128)
    return ops.w1p.reshape(-1)[off]


def _head_tile(x, ops, b, y0, x0, softmax, out):
    """One 8 x 16 cell tile as ``head_s8_kernel`` computes it: warpgroup
    w the 8 x 8 block of columns 8 w .."""
    H, W = x.shape[1:3]
    hiw, npx = 18, 180
    inp = _planes(_window(x, b, y0 - 1, x0 - 1, 10, hiw).reshape(npx, 128), 0)
    slabs = ops.w3p.reshape(9, -1)
    w1 = _head_1x1(ops).long()
    m = torch.arange(64)
    k = torch.arange(256)[None, :]
    for wg in range(2):
        mid = torch.zeros(16 * 1024, dtype=torch.int8)
        for n0 in range(0, 256, 64):
            acc = _tap_conv(inp, 8 * wg * 16, hiw, npx * 16, hiw * 16, 128,
                            slabs, n0, 64)
            v = cast_int8(affine(acc.float(), ops.m3p[n0:n0 + 64],
                                 ops.b3p[n0:n0 + 64], True))
            ch = n0 + torch.arange(64)[None, :]
            mid[(ch // 16) * 1024 + m[:, None] * 16 + ch % 16] = v
        # the 1x1's A: the mid planes, stride byte offset 8 cells
        a = mid[_core_addr(m[:, None], k, 128, 1024)].long()
        z = affine((a @ w1).float(), ops.m1p, ops.b1p, False)
        n_real = ops.w1.shape[-1]
        if softmax:
            z = z[:, :n_real]
            e = torch.exp(z - z.amax(-1, keepdim=True))
            z = (e / e.sum(-1, keepdim=True))[:, :n_real - 1]
        else:
            z = z[:, :n_real]
        y, xx = y0 + m // 8, x0 + 8 * wg + m % 8
        keep = (y < H) & (xx < W)
        out[b, y[keep], xx[keep]] = z[keep].to(torch.bfloat16)


@pytest.mark.parametrize("cout,softmax", [(65, True), (65, False),
                                          (256, False)])
def test_head_tile_emulation_matches_plain(cout, softmax):
    rng = np.random.default_rng(40 + cout + softmax)
    raw = _head_raw(rng, cout)
    ops = T.prepare_head(*raw)
    B, H, W = 2, 7, 13 if softmax else 20
    x = _i8(rng, (B, H, W, 128), 0, 128)
    out = torch.zeros((B, H, W, cout - 1 if softmax else cout),
                      dtype=torch.bfloat16)
    for b in range(B):
        for y0 in range(0, H, 8):
            for x0 in range(0, W, 16):
                _head_tile(x, ops, b, y0, x0, softmax, out)
    kw = {"softmax_lanes": cout} if softmax else {}
    want = T.head_plain(x, *raw, **kw)
    assert bf16_ulp_diff(out, want) <= 1
    if not softmax:  # int32 sums and the float32 affine: the same bits
        assert torch.equal(out, want)


@pytest.mark.parametrize("dtype,pool", [(torch.int8, True),
                                        (torch.int8, False),
                                        (torch.bfloat16, True)])
def test_prepared_double_conv_equals_raw(dtype, pool):
    rng = np.random.default_rng(50)
    raw = list(_dc_raw(rng, 64, 128, 128))
    x = _i8(rng, (2, 8, 14, 64), 0, 128)
    if dtype == torch.bfloat16:
        raw[0], raw[3] = (w.float().div(256).to(dtype) for w in (raw[0],
                                                                 raw[3]))
        raw[1], raw[4] = torch.ones(128), torch.ones(128)
        x = x.float().div(128).to(dtype)
    ops = M.prepare_double_conv(*raw)
    assert ops.wap is not None and ops.wap.dtype == dtype
    got = M.double_conv3x3(x, ops, pool=pool)
    assert got.dtype == dtype and got.shape == (
        (2, 4, 7, 128) if pool else (2, 8, 14, 128))
    assert torch.equal(got, M.double_conv3x3(x, *raw, pool=pool))
    assert torch.equal(got, M.double_conv3x3_plain(x, ops, pool=pool))
    assert torch.equal(got, M.double_packed_conv3x3(x, ops, pool=pool))


def test_prepare_double_conv_keeps_raw_where_no_kernel_takes_them():
    rng = np.random.default_rng(51)
    raw = (_i8(rng, (3, 3, 8, 8)), torch.ones(8), torch.zeros(8),
           _i8(rng, (3, 3, 8, 8)), torch.ones(8), torch.zeros(8))
    ops = M.prepare_double_conv(*raw)
    assert ops.wap is None and ops.raw == raw
    x = _i8(rng, (1, 4, 6, 8), 0, 128)
    assert torch.equal(M.double_conv3x3(x, ops),
                       M.double_conv3x3_plain(x, *raw))
    with pytest.raises(ValueError, match="even"):
        M.double_conv3x3(_i8(rng, (1, 5, 6, 8)), ops, pool=True)


@pytest.fixture(scope="module")
def variables():
    return C.jax_variables()


@pytest.mark.parametrize("mode", ["int8", "mixed"])
def test_serving_prepares_double_convs_once_and_matches_jax(
        variables, mode, monkeypatch):
    """The int8 and mixed graphs prepare blocks 3-4, 5-6 and 7-8 when they
    are built and never on a call (a request calls neither a packer nor
    ``_wmb``); every request hands the kernels those operands; two calls
    give the same bits and the JAX package's outputs,
    keypoints and descriptors within the bounds of ``_serving_cases``
    (int8: the chain exact)."""
    from spnerf_tpu_torch.ops import fast_inference as tfi
    from spnerf_tpu_torch.ops import serving
    from spnerf_tpu_torch.tools.import_jax_weights import serving_from_folded

    ref = C.jax_case(variables, mode, True, True, 64)
    prepared, passed = [], []
    monkeypatch.setattr(serving, "prepare_double_conv", lambda *a: (
        prepared.append(a), M.prepare_double_conv(*a))[1])
    for name in ("double_packed_conv3x3", "double_conv3x3"):
        fn = getattr(serving, name)
        monkeypatch.setattr(serving, name, lambda x, ops, _f=fn, **kw: (
            passed.append(type(ops)), _f(x, ops, **kw))[1])
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             mode=mode)
    assert len(prepared) == 3
    assert all(a[0].dtype == torch.int8 for a in prepared)
    monkeypatch.setattr(sp, "_wmb", lambda *a: pytest.fail(
        "a request re-derived a conv's operands"))
    x = torch.from_numpy(ref["x"])
    out = sp(x, softmax=True)
    again = sp(x, softmax=True)
    assert len(prepared) == 3
    assert passed == [M.DoubleConvOperands] * 6
    for key in out:
        assert torch.equal(out[key], again[key])
    n_all = ref["n_all"]
    dets = tfi.detect_from_probs_padded(
        out["probs"], 8, min_prob=C.THRESH, size=4, num_candidates=n_all,
        top_k=n_all, compact=False)
    C.check_outputs(ref, out)
    C.check_keypoints(ref, dets)
    C.check_descriptors(ref, out)
