"""The tensor-core weight layout of the bf16 3x3 convs, on the CPU.

``kernels/_build.pack_slabs`` lays out each tap's C_in x C_out slab in
the order ``csrc/conv_tc.cuh`` reads it (K-major 8 x 8 core matrices, the
wgmma descriptor's offsets 128 and C_in * 16 bytes). These tests read the
packed slabs back by that address formula, run the kernel's implicit GEMM
(tap by tap, 64-row M-tiles of the output tile's 2 x 8 slices) in plain
PyTorch over them, and hold it against ``requant.conv3x3_float``: float64
sums in another order, rounded once to float32, so within one float32
rounding. They also check the output tile's M order (every pixel once,
the pool partner in lane ^ 4). No card needed.
"""

import numpy as np
import pytest
import torch

from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.requant import conv3x3_float

# (C_in, C_out) of every bf16 instance that conv3x3.cu and
# double_conv3x3.cu dispatch (double: conv_a and conv_b of each)
SLAB_SHAPES = [(64, 64), (64, 128), (128, 128), (128, 256)]
# output tiles of the instances: (rows, columns)
OUT_TILES = [(16, 16), (8, 16)]


def _weights(cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
    return torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)


def _slab(packed, tap, cin, cout):
    """(cin, cout) slab of ``tap`` read by the kernel's address formula."""
    n = torch.arange(cout)[None, :]
    k = torch.arange(cin)[:, None]
    off = ((n // 8) * (cin // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8
    return packed.reshape(9, -1)[tap][off]


@pytest.mark.parametrize("cin,cout", SLAB_SHAPES)
def test_pack_slabs_reads_back(cin, cout):
    w = _weights(cin, cout, 40 + cin + cout)
    packed = _build.pack_slabs(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() * 2 == 9 * cin * cout * 2  # 9 slabs of bytes
    for tap in range(9):
        assert torch.equal(_slab(packed, tap, cin, cout),
                           w[tap // 3, tap % 3])


def _out_pixel(row, tw):
    """Tile pixel (y, x) of output M-row ``row`` (conv_tc.cuh out_pixel)."""
    s, m = row // 16, row % 16
    return 2 * (s // (tw // 8)) + m // 8, 8 * (s % (tw // 8)) + m % 8


@pytest.mark.parametrize("th,tw", OUT_TILES)
def test_out_tile_m_order(th, tw):
    """Every pixel of the tile once; a lane's two accumulator rows one
    above the other; its pool partner (lane ^ 4) one column over."""
    rows = th * tw
    assert rows % 64 == 0
    pix = [_out_pixel(r, tw) for r in range(rows)]
    assert sorted(pix) == [(y, x) for y in range(th) for x in range(tw)]
    for r in range(0, rows, 16):  # one warp's 16 rows
        for lane in range(32):
            y0, x0 = pix[r + lane // 4]
            y1, x1 = pix[r + lane // 4 + 8]
            yp, xp = pix[r + (lane ^ 4) // 4]
            assert (y1, x1) == (y0 + 1, x0)
            assert yp == y0 and xp == x0 ^ 1


def _implicit_gemm(x, packed, cin, cout, th, tw):
    """The kernel's sum over the packed slabs, in float64: per output tile,
    per 64-row M-tile, per tap, A (64 x cin) rows of the zero-padded input
    shifted by the tap times the tap's slab (cin x cout)."""
    B, H, W, _ = x.shape
    ty, tx = -(-H // th), -(-W // tw)
    xp = torch.zeros(B, ty * th + 2, tx * tw + 2, cin, dtype=torch.float64)
    xp[:, 1:H + 1, 1:W + 1] = x.double()
    slabs = [_slab(packed, t, cin, cout).double() for t in range(9)]
    out = torch.zeros(B, ty * th, tx * tw, cout, dtype=torch.float64)
    ys, xs = zip(*[_out_pixel(r, tw) for r in range(th * tw)])
    ys, xs = torch.tensor(ys), torch.tensor(xs)
    for i in range(ty):
        for j in range(tx):
            for m0 in range(0, th * tw, 64):
                y = i * th + ys[m0:m0 + 64]
                xx = j * tw + xs[m0:m0 + 64]
                acc = torch.zeros(B, 64, cout, dtype=torch.float64)
                for t in range(9):
                    acc += xp[:, y + t // 3, xx + t % 3] @ slabs[t]
                out[:, y, xx] = acc
    return out[:, :H, :W].float()


@pytest.mark.parametrize("cin,cout", SLAB_SHAPES)
def test_implicit_gemm_over_slabs_matches_conv(cin, cout):
    th, tw = (16, 16) if cin == 64 else (8, 16)
    rng = np.random.default_rng(50 + cin + cout)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 13, 22, cin)).astype(
        np.float32)).to(torch.bfloat16)
    w = _weights(cin, cout, 60 + cin + cout)
    got = _implicit_gemm(x, _build.pack_slabs(w), cin, cout, th, tw)
    want = conv3x3_float(x, w)
    assert got.shape == want.shape == (2, 13, 22, cout)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2.0 ** -23, atol=2.0 ** -23 * scale)


def test_pack_slabs_raises_on_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="bf16"):
        _build.pack_slabs(torch.zeros(3, 3, 64, 64))
    with pytest.raises(ValueError, match="multiples of 8"):
        _build.pack_slabs(torch.zeros(3, 3, 60, 64, dtype=torch.bfloat16))
