"""The CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one (the kernels have no CPU
mode). Imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes are small, with edges that are not multiples of the kernels'
tiles. Tolerances: int8 results exactly equal, bf16 results of int8
sums within 1 ulp (the softmax's exp and sum order differ from
PyTorch's), bf16 operands as ``test_layer_kernel_matches_plain_on_card``
states, warps within 1e-6,
the descriptor-loss sums within 1e-5 relative and its gradients within
1e-4 of their largest entry (float32 sums in another order; the inputs
keep every dot away from both margins, and the warped cells sit on a
quarter-pixel grid, so no pair takes the other side of a step), the
fused descriptor sampler equal to its plain version before the
normalization and within 1e-6 after it.
"""

import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp_diff
from spnerf_tpu_torch.kernels.conv12_fused import (
    conv12_fused,
    conv12_fused_plain,
)
from spnerf_tpu_torch.kernels.mid_fused import (
    double_conv3x3,
    double_conv3x3_plain,
)
from spnerf_tpu_torch.kernels.tail_fused import head, head_plain


def _int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _mb(rng, C, lo, hi):
    """Per-channel multiplier and bias, float32."""
    return (rng.uniform(lo, hi, C).astype(np.float32),
            rng.uniform(-20, 20, C).astype(np.float32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(kind, rng):
    """(wrapper, plain, args, kwargs) at shapes whose edges are not
    multiples of the kernels' 16 x 16 (or 8 x 16) tiles."""
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    if kind.startswith("conv12"):
        s1 = np.float32(0.02)
        args = (rng.uniform(0, 1, (2, 40, 56, 1)).astype(np.float32),
                (rng.standard_normal((3, 3, 1, 64)) * 0.3).astype(np.float32),
                np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1)),
                (rng.standard_normal(64) * 0.1 / s1).astype(np.float32),
                _int8(rng, (3, 3, 64, 64)), *_mb(rng, 64, 1e-4, 6e-4))
        return (conv12_fused, conv12_fused_plain, [t(a) for a in args],
                {"pool": kind == "conv12_pool"})
    if kind.startswith("double"):
        cin, cm, pool = {"double_64_64": (64, 64, True),
                         "double_64_128": (64, 128, True),
                         "double_128_128": (128, 128, False)}[kind]
        args = (_int8(rng, (2, 20, 36, cin), 0, 128),
                _int8(rng, (3, 3, cin, cm)), *_mb(rng, cm, 5e-5, 4e-4),
                _int8(rng, (3, 3, cm, cm)), *_mb(rng, cm, 3e-5, 3e-4))
        return (double_conv3x3, double_conv3x3_plain, [t(a) for a in args],
                {"pool": pool})
    cout = 65 if kind.startswith("head_65") else 256
    args = (_int8(rng, (2, 12, 20, 128), 0, 128), _int8(rng, (3, 3, 128, 256)),
            *_mb(rng, 256, 5e-5, 4e-4), _int8(rng, (256, cout)),
            rng.uniform(2e-5, 1e-4, cout).astype(np.float32),
            rng.uniform(-1, 1, cout).astype(np.float32))
    kw = {"softmax_lanes": 65} if kind == "head_65_softmax" else {}
    return head, head_plain, [t(a) for a in args], kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [
    "conv12_pool", "conv12", "double_64_64", "double_64_128",
    "double_128_128", "head_65_softmax", "head_65", "head_256"])
def test_kernel_matches_plain_on_card(card, kind):
    from spnerf_tpu_torch.kernels import _build

    kernel, plain, args, kw = _card_case(kind, np.random.default_rng(16))
    before = sum(_build.launch_counts.values())
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 1
    want = plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert bf16_ulp_diff(got.cpu(), want.cpu()) <= 1


def _warp_case(kind, rng):
    """(image, homographies, compute dtype): ragged 37 x 53 images, three
    homographies per image (n % B tiling), one with a zero denominator
    on the column x = 16."""
    B, H, W = 2, 37, 53
    img = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    Hs = np.tile(np.eye(3, dtype=np.float32), (3 * B, 1, 1))
    Hs[:, :2] += rng.normal(0, 0.1, (3 * B, 2, 3)).astype(np.float32)
    Hs[:, :2, 2] *= 20
    Hs[:, 2, :2] = rng.normal(0, 1e-3, (3 * B, 2)).astype(np.float32)
    if kind == "zero_denominator":
        Hs[0] = [[1, 0, 0], [0, 1, 0], [1 / 16, 0, 1]]
    dtype = torch.int8 if kind == "int8" else torch.bfloat16
    return torch.from_numpy(img).cuda(), torch.from_numpy(Hs).cuda(), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "zero_denominator"])
def test_warp_matches_plain_on_card(card, kind):
    """The warp kernel against its plain version on the card: the same
    explicitly rounded float32 operations in the same order, so within
    1e-6 (equal in practice)."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.warp import (
        warp_image_fused,
        warp_image_fused_plain,
    )

    img, Hs, dtype = _warp_case(kind, np.random.default_rng(17))
    before = sum(_build.launch_counts.values())
    got = warp_image_fused(img, Hs, dtype)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 1
    want = warp_image_fused_plain(img, Hs, dtype)
    assert got.shape == want.shape == (Hs.shape[0],) + img.shape[1:]
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6
    assert float((want > 0).float().mean()) > 0.3


def _hinge_case(kind, rng):
    """(A, Bm, wcells, cells, mask) on the card: N not a multiple of the
    kernels' 64 and 32 tiles, C below and at the kernels' 256, warped
    cells exactly on the radius for some pairs."""
    from spnerf_tpu_torch.train.losses import cell_grid_coords

    B, Hc, Wc, C = {"small": (2, 6, 8, 32), "ragged": (3, 11, 15, 64),
                    "full_c": (2, 9, 13, 256), "no_mask": (1, 7, 9, 16)}[kind]
    N = Hc * Wc
    scale = (0.16 / C) ** 0.25  # dots of standard deviation 0.4
    while True:  # every dot at least 2e-6 from both margins
        A = (rng.standard_normal((B, N, C)) * scale).astype(np.float32)
        Bm = (rng.standard_normal((B, N, C)) * scale).astype(np.float32)
        dot = np.einsum("bnc,bmc->bnm", A.astype(np.float64), Bm.astype(np.float64))
        if min(np.abs(dot - 1.0).min(), np.abs(dot - 0.2).min()) > 2e-6:
            break
    cells = cell_grid_coords(Hc, Wc, 8)
    wcells = (rng.integers(0, 32 * max(Hc, Wc), (B, N, 2)) / 4.0).astype(np.float32)
    wcells[:, :N // 3] = cells[:N // 3].numpy() + np.float32([8, 0])
    mask = np.ones((B, N), np.float32)
    if kind != "no_mask":
        mask = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return t(A), t(Bm), t(wcells), cells.cuda(), t(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["small", "ragged", "full_c", "no_mask"])
def test_hinge_kernels_match_plain_on_card(card, kind):
    """Forward sums, dA and dB against the plain version, and two runs
    bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.descriptor_loss import (
        descriptor_hinge_sums,
        hinge_sums_plain,
    )

    A, Bm, wcells, cells, mask = _hinge_case(kind, np.random.default_rng(18))
    A.requires_grad_()
    Bm.requires_grad_()
    g = torch.linspace(0.5, 2.0, A.shape[0], device="cuda")

    def run(fn):
        sums = fn(A, Bm, wcells, cells, mask, 250.0, 1.0, 0.2, 8.0)
        assert not sums[1].requires_grad and not sums[2].requires_grad
        dA, dB = torch.autograd.grad((sums[0] * g).sum(), (A, Bm))
        return torch.stack([s.detach() for s in sums]), dA, dB

    before = _build.launch_counts.copy()
    got, again, want = (run(descriptor_hinge_sums),
                        run(descriptor_hinge_sums), run(hinge_sums_plain))
    torch.cuda.synchronize()
    assert _build.launch_counts - before == {
        "desc_loss[fwd]": 2, "desc_loss[dA]": 2, "desc_loss[dB]": 2}
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert float(want[0][1].min()) > 0 and float(want[0][2].min()) > 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for k, p in zip(got[1:], want[1:]):
        assert float(p.abs().max()) > 0
        assert float((k - p).abs().max()) <= 1e-4 * float(p.abs().max())


@pytest.mark.cuda
def test_hinge_wrapper_launches_only_the_gradient_asked_for(card):
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.descriptor_loss import descriptor_hinge_sums

    A, Bm, wcells, cells, mask = _hinge_case("small", np.random.default_rng(19))
    A.requires_grad_()
    before = _build.launch_counts.copy()
    s_pair = descriptor_hinge_sums(A, Bm, wcells, cells, mask, 250.0, 1.0,
                                   0.2, 8.0)[0]
    s_pair.sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts - before == {"desc_loss[fwd]": 1,
                                             "desc_loss[dA]": 1}
    assert torch.isfinite(A.grad).all() and float(A.grad.abs().max()) > 0
    with pytest.raises(ValueError, match="multiple of 4"):
        descriptor_hinge_sums(A[..., :30], Bm[..., :30], wcells, cells, mask,
                              250.0, 1.0, 0.2, 8.0)


def _planted_case(rng, C=64):
    """(A, Bm, wcells, cells, mask, planted pairs) on the card with dots
    planted in float64 at pos_margin +- 5e-7 (pairs within the radius) and
    neg_margin +- 5e-7 (pairs outside it): one component of Bm's row is
    set so that the float32 rows' float64 dot lands there (within 1e-7 and
    on the planted side: checked), the pair's warped cell on or far from
    the cell centre."""
    from spnerf_tpu_torch.train.losses import cell_grid_coords

    B, Hc, Wc = 2, 9, 13
    N = Hc * Wc
    scale = (0.16 / C) ** 0.25
    A = (rng.standard_normal((B, N, C)) * scale).astype(np.float32)
    Bm = (rng.standard_normal((B, N, C)) * scale).astype(np.float32)
    cells = cell_grid_coords(Hc, Wc, 8).numpy()
    wcells = (rng.integers(0, 32 * max(Hc, Wc), (B, N, 2)) / 4.0).astype(np.float32)
    planted = []
    rows = rng.permutation(N)[:40]
    cols = rng.permutation(N)[:40]
    for k, (i, j) in enumerate(zip(rows, cols)):
        b = k % B
        margin = 1.0 if k % 2 == 0 else 0.2
        target = margin + (5e-7 if k % 4 < 2 else -5e-7)
        # pos margin: the warped cell on the centre; neg: 100 px away
        wcells[b, i] = cells[j] + (0.0 if margin == 1.0 else 100.0)
        c = int(np.abs(A[b, i]).argmax())
        for _ in range(3):
            dot = float(A[b, i].astype(np.float64) @ Bm[b, j].astype(np.float64))
            Bm[b, j, c] = np.float32(Bm[b, j, c] + (target - dot) / float(A[b, i, c]))
        dot = float(A[b, i].astype(np.float64) @ Bm[b, j].astype(np.float64))
        # within float32 rounding of the changed component, on its side
        assert abs(dot - target) < 1e-7 and (dot > margin) == (target > margin)
        planted.append((b, i, j))
    mask = (rng.uniform(size=(B, N)) > 0.1).astype(np.float32)
    for b, _, j in planted:
        mask[b, j] = 1.0
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return t(A), t(Bm), t(wcells), torch.from_numpy(cells).cuda(), t(mask), planted


def _hinge_against_float64(A, Bm, wcells, cells, mask):
    """The kernels' sums and gradients, and those of the plain version on
    float64 copies of the inputs (the exact dots' steps)."""
    from spnerf_tpu_torch.kernels.descriptor_loss import (
        descriptor_hinge_sums,
        hinge_sums_plain,
    )

    g = torch.linspace(0.5, 2.0, A.shape[0], device="cuda")
    out = []
    for fn, dtype in ((descriptor_hinge_sums, torch.float32),
                      (hinge_sums_plain, torch.float64)):
        a = A.to(dtype).requires_grad_()
        b = Bm.to(dtype).requires_grad_()
        sums = fn(a, b, wcells.to(dtype), cells.to(dtype), mask.to(dtype),
                  250.0, 1.0, 0.2, 8.0)
        dA, dB = torch.autograd.grad((sums[0] * g.to(dtype)).sum(), (a, b))
        out.append((torch.stack([s.detach() for s in sums]).double(),
                    dA.double(), dB.double()))
    return out


def _assert_rows_within(got, want):
    for k, p in zip(got[1:], want[1:]):
        assert float(p.abs().max()) > 0
        row_err = (k - p).abs().amax(-1)
        assert float(row_err.max()) <= 1e-4 * float(p.abs().max())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_hinge_planted_margins_on_card(card):
    """Dots planted within 5e-7 of both margins: the band catches every
    planted pair (the repair counter grows by at least their number in
    each gradient), and dA, dB equal, row for row within 1e-4 of the
    largest entry, the gradient of the plain version on float64 copies."""
    from spnerf_tpu_torch.kernels.descriptor_loss import repaired_pairs

    A, Bm, wcells, cells, mask, planted = _planted_case(
        np.random.default_rng(20))
    before = repaired_pairs("cuda")
    got, want = _hinge_against_float64(A, Bm, wcells, cells, mask)
    after = repaired_pairs("cuda")
    assert all(a - b >= len(planted) for a, b in zip(after, before))
    _assert_rows_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 64, 256])
def test_hinge_fractional_mask_on_card(card, C):
    """A mask of 0.3 and 0.5 on some cells: 0.3 is no TF32 value (a pair
    beyond the negative margin has ddot = mask), so the kernels split ddot
    too; against the float64 plain version."""
    A, Bm, wcells, cells, mask = _hinge_case("ragged", np.random.default_rng(21))
    rng = np.random.default_rng(22)
    A = torch.from_numpy((rng.standard_normal((3, A.shape[1], C))
                          * (0.16 / C) ** 0.25).astype(np.float32)).cuda()
    Bm = torch.from_numpy((rng.standard_normal((3, Bm.shape[1], C))
                           * (0.16 / C) ** 0.25).astype(np.float32)).cuda()
    frac = torch.from_numpy(rng.choice(np.float32([0.3, 0.5, 1.0, 0.0]),
                                       mask.shape)).cuda()
    got, want = _hinge_against_float64(A, Bm, wcells, cells, mask * frac)
    _assert_rows_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C,scale", [(16, None), (64, None), (256, None),
                                     (256, 0.08)])
def test_tensor_core_dots_within_delta_on_card(card, C, scale):
    """The forward kernel's dots against float64 dots: within delta =
    kappa(C) ||a|| ||b|| (csrc/descriptor_loss.cu's bound) at the test
    operands' scale and at the training operands' (0.08)."""
    from spnerf_tpu_torch.kernels.descriptor_loss import kappa, tensor_core_dots

    rng = np.random.default_rng(23)
    s = (0.16 / C) ** 0.25 if scale is None else scale
    A = (rng.standard_normal((2, 333, C)) * s).astype(np.float32)
    Bm = (rng.standard_normal((2, 301, C)) * s).astype(np.float32)
    got = tensor_core_dots(torch.from_numpy(A).cuda(),
                           torch.from_numpy(Bm).cuda()).double().cpu().numpy()
    A64, B64 = A.astype(np.float64), Bm.astype(np.float64)
    exact = np.einsum("bnc,bmc->bnm", A64, B64)
    norms = (np.linalg.norm(A64, axis=-1)[:, :, None]
             * np.linalg.norm(B64, axis=-1)[:, None, :])
    ratio = np.abs(got - exact) / (kappa(C) * norms)
    assert ratio.max() <= 1.0, ratio.max()
    assert np.abs(got - exact).max() > 0  # the tensor cores' own sums


def _render_case(kind, rng):
    """(width, weights' dtype, operands, keywords) of a small render: N not
    a multiple of the kernels' tile, ``block`` not a multiple of it either
    (so a tile spans flags of two blocks), flags with zeros, and for
    ``hot`` a dense field, denser still for every other run of 50 rays, so
    that the early stop fires and tiles stop at different chunks."""
    width = 64 if "w64" in kind else 32 if "w32" in kind else 128
    dtype = torch.bfloat16 if "bf16" in kind else torch.float32
    hot = kind.startswith("hot")
    N, n_samples, chunk = 333, 16, 4
    block, s_chunk = (48, 4) if width == 128 else (80, chunk * width // 128)
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
    flags = (rng.uniform(size=(-(-N // block), n_samples // chunk)) > 0.3)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    kw = dict(jitter=0.37, n_samples=n_samples, near=2.0, far=6.0, block=block,
              s_chunk=s_chunk, flags=t(flags.astype(np.int32)),
              early_stop_eps=1e-3 if hot else 0.0)
    if hot or kind == "no_flags":
        kw["flags"] = None
    ws = [t(p[k]).to(dtype) for k in ("w1", "w2", "w3")]
    return width, ws, (t(oe), t(de), t(df)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "no_flags", "hot", "hot_bf16",
                                  "w64", "w64_bf16", "hot_w64", "w32",
                                  "w32_bf16", "hot_w32"])
def test_render_matches_plain_on_card(card, kind):
    """The float render kernels against their plain versions: the same
    roundings and skips, the dots' float32 sums in another order. With
    float32 operands within 2e-5 (rgb) and 1e-4 (depth); with bf16 a sum
    that lands on the other side of a rounding moves a hidden activation by
    one bf16 ulp: within 1e-4 and 1e-3 (measured on an H100: 6.4e-6 and
    1.4e-6 at most). Two runs give the same bits."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R

    width, (w1, w2, w3), (oe, de, df), kw = _render_case(
        kind, np.random.default_rng(20))
    if width == 128:
        run = lambda fn: fn(oe, de, w1, w2, w3, df, **kw)  # noqa: E731
        kernel, plain = R.render_fused, R.render_fused_plain
    else:
        run = lambda fn: fn(oe, de, w1, w2, w3, df, width=width, **kw)  # noqa: E731
        kernel, plain = R.render_fused_packed, R.render_fused_packed_plain
    before = sum(_build.launch_counts.values())
    got, again = run(kernel), run(kernel)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 2
    want = run(plain)
    assert got[0].shape == (oe.shape[0], 3) and got[1].shape == (oe.shape[0],)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    assert float(want[0].max()) > 0.05  # the render is not empty
    rgb_tol, depth_tol = (1e-4, 1e-3) if "bf16" in kind else (2e-5, 1e-4)
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render {kind}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= rgb_tol and depth_err <= depth_tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "hot"])
def test_render_int8_matches_plain_on_card(card, kind):
    """The int8 render kernel against its plain version: the int32 dots are
    exact on both sides, so only a sine or a requantization within float32
    rounding of a half-integer can differ (one int8 step): rgb within 5e-4,
    depth within 2e-3 (measured on an H100: equal)."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R

    rng = np.random.default_rng(21)
    _, ws, (oe, de, df), kw = _render_case(kind, rng)
    params = {k: w.cpu().numpy() for k, w in zip(("w1", "w2", "w3"), ws)}
    qf = R.quantize_field(params, oe.cpu().numpy(), de.cpu().numpy(),
                          df.cpu().numpy(), n_samples=kw["n_samples"],
                          near=kw["near"], far=kw["far"], jitter=kw["jitter"])
    before = _build.launch_counts["render[int8]"]
    got = R.render_fused_int8(oe, de, qf, df, **kw)
    again = R.render_fused_int8(oe, de, R.qfield_to(qf, "cuda"), df, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["render[int8]"] == before + 2
    want = R.render_fused_int8_plain(oe, de, qf, df, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert float(want[0].max()) > 0.05
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render int8 {kind}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 5e-4 and depth_err <= 2e-3


@pytest.mark.cuda
def test_render_wrappers_raise_on_what_the_kernel_does_not_take(card):
    from spnerf_tpu_torch.kernels import render as R

    _, (w1, w2, w3), (oe, de, df), kw = _render_case(
        "f32", np.random.default_rng(22))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        R.render_fused(oe, de, w1.half(), w2.half(), w3.half(), df, **kw)
    with pytest.raises(ValueError, match="flags must be int32"):
        R.render_fused(oe, de, w1, w2, w3, df, **{**kw, "flags": kw["flags"][:1]})
    with pytest.raises(ValueError, match="CUDA"):
        R.render_fused(oe, de, w1.cpu(), w2.cpu(), w3.cpu(), df, **kw)
    with pytest.raises(ValueError, match="pack width"):
        R.render_fused_packed(oe, de, w1, w2, w3, df, width=128)


# The bf16 render on the tensor cores (csrc/render.cu render_tc_kernel):
# a block of warpgroups shares a tile of tile_rays(width) rays, each
# warpgroup owning groups of 32 rays (64-row M-tiles of two samples).
# Cases: N below one group and one past a multiple of it; a tile that
# spans two flag blocks and a group whose flags are all 0; the early stop
# closing one group of a tile (which must go on for the others) and all
# of another; weights resident in shared memory giving the same bits on
# a launch after another field's.
RENDER_TC_CASES = ["n_below_group", "n_group_plus_one", "flag_blocks",
                   "one_group_stops", "second_launch"]


def _render_tc_case(kind, width, rng):
    """(bf16 weights, (oe, de, df), keywords) on the card."""
    from spnerf_tpu_torch.kernels import render as R

    tile = R.tile_rays(width)
    n_samples, chunk = 16, 4
    N = {"n_below_group": 20, "n_group_plus_one": 3 * 32 + 1,
         "flag_blocks": 2 * tile + 45, "one_group_stops": 3 * tile + 7,
         "second_launch": tile + 33}[kind]
    p = {k: (rng.standard_normal((width, width)) * 0.1).astype(np.float32)
         for k in ("w1", "w2", "w3")}
    oe = rng.uniform(-3, 3, (N, width)).astype(np.float32)
    de = rng.uniform(-2, 2, (N, width)).astype(np.float32)
    oe[:, 0], de[:, 0] = np.pi / 2, 0.0  # the constant-one lane
    df = (rng.standard_normal((N, width)) * 0.1).astype(np.float32)
    block, flags, eps = 48, None, 0.0
    if kind == "flag_blocks":
        # 32-ray blocks, so that a tile spans several: group 1 of tile 0
        # and group 2 of tile 1 never flagged, the others at random
        block = 32
        flags = rng.uniform(size=(-(-N // block), n_samples // chunk)) > 0.3
        flags[1] = False
        flags[(tile // 32) + 2] = False
    if kind == "one_group_stops":
        # sigma read from lane 1 alone; group 0 of every tile dense there,
        # and the whole of tile 1: the early stop closes those rays in the
        # first chunk, tile 1 stops, the others go on
        p["w3"][:, 0] = 1e-3
        p["w3"][1, 0] = 5.0
        r = np.arange(N)
        hot = ((r % tile) < 32) | (r // tile == 1)
        df[:, 1] += np.where(hot, 6.0, -6.0).astype(np.float32)
        eps = 1e-3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    kw = dict(jitter=0.37, n_samples=n_samples, near=2.0, far=6.0,
              block=block, early_stop_eps=eps,
              s_chunk=chunk if width == 128 else chunk * width // 128,
              flags=None if flags is None else t(flags.astype(np.int32)))
    ws = [t(p[k]).to(torch.bfloat16) for k in ("w1", "w2", "w3")]
    return ws, (t(oe), t(de), t(df)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 64, 32])
@pytest.mark.parametrize("kind", RENDER_TC_CASES)
def test_render_tc_tiling_on_card(card, kind, width):
    """The tensor-core render against its plain version at the edges of
    its tiling, at the bf16 tolerances (rgb 1e-4, depth 1e-3), two runs
    bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R

    rng = np.random.default_rng(23)
    ws, (oe, de, df), kw = _render_tc_case(kind, width, rng)
    if width == 128:
        run = lambda fn, w: fn(oe, de, *w, df, **kw)  # noqa: E731
        kernel, plain = R.render_fused, R.render_fused_plain
        key = "render[bf16]"
    else:
        run = lambda fn, w: fn(oe, de, *w, df, width=width, **kw)  # noqa: E731
        kernel, plain = R.render_fused_packed, R.render_fused_packed_plain
        key = f"render[w{width}]"
    before = _build.launch_counts[key]
    got = run(kernel, ws)
    if kind == "second_launch":  # another field in between
        other = [(w.float() * -0.7).to(torch.bfloat16) for w in ws]
        run(kernel, other)
    again = run(kernel, ws)
    torch.cuda.synchronize()
    assert _build.launch_counts[key] == before + (3 if kind == "second_launch"
                                                  else 2)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = run(plain, ws)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    assert float(want[0].max()) > 0.05
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render tc {kind} w{width}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 1e-4 and depth_err <= 1e-3
    if kind == "flag_blocks":  # a ray never flagged stays black
        never = ~kw["flags"].bool().any(1)
        rays = never.repeat_interleave(kw["block"])[:oe.shape[0]]
        assert float(got[0][rays].abs().max()) == 0.0
    if kind == "one_group_stops":
        # tile 1 and the 7 rays of tile 3 (all of group 0) skipped their
        # last 3 chunks; every other tile went on
        _, _, done = R.render_plain_counted(
            oe, de, df, R.float_mlp_head(*ws, width != 128), width=width,
            n_samples=16, chunk=4, near=2.0, far=6.0, jitter=0.37,
            block=kw["block"], flags=None, early_stop_eps=1e-3,
            packed=width != 128)
        assert done == 16 * oe.shape[0] - 12 * (R.tile_rays(width) + 7)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 64, 32])
def test_render_tc_on_the_sphere_fields_on_card(card, width):
    """The tensor-core render against its plain version (cuBLAS's order of
    sums) on a committed sphere field at the render drive's 131,072 orbit
    rays x 32 samples, early stop on: where wgmma's own sums would put 13
    to 46 rays beyond 1e-4 in rgb, the repair keeps every ray within 1e-4
    (rgb) and 1e-3 (depth)."""
    from spnerf_tpu_torch.kernels import render as R
    from spnerf_tpu_torch.tools.kernel_times import render_drive

    f = render_drive()[2][width]
    if width == 128:
        run = lambda fn: fn(f.oe, f.de, *f.ws, f.df, **f.kw)  # noqa: E731
        kernel, plain = R.render_fused, R.render_fused_plain
    else:
        run = lambda fn: fn(f.oe, f.de, *f.ws, f.df, width=width, **f.kw)  # noqa: E731
        kernel, plain = R.render_fused_packed, R.render_fused_packed_plain
    got, want = run(kernel), run(plain)
    assert float(want[0].max()) > 0.05
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render tc sphere w{width}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 1e-4 and depth_err <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scale_c", [0, 1])
def test_tc_step_equals_the_tensor_cores_on_card(card, scale_c):
    """``_render_tc.tc_step``, the tests' model of a wgmma k-step, against
    the instruction itself (m64n8k16, bf16, float32 sums; the probe in
    ``csrc/render_probe.cu``) on 512 problems of products spread over
    2^-24 .. 2^8, both signs, with and without a running sum over
    2^-10 .. 2^10: equal to the bit."""
    from _render_tc import tc_step

    from spnerf_tpu_torch.kernels import _build

    rng = np.random.default_rng(30 + scale_c)
    n = 512

    def spread(shape):
        m = rng.integers(128, 256, shape) / 128.0
        return (rng.choice([-1.0, 1.0], shape) * m
                * 2.0 ** rng.integers(-12, 5, shape)).astype(np.float32)

    a = torch.from_numpy(spread((n, 64, 16))).to(torch.bfloat16).cuda()
    b = torch.from_numpy(spread((n, 16, 8))).to(torch.bfloat16).cuda()
    c = torch.from_numpy((rng.standard_normal((n, 64, 8))
                          * 2.0 ** rng.integers(-10, 11, (n, 64, 8)))
                         .astype(np.float32)).cuda()
    d = torch.empty_like(c)
    _build.launch("render_probe", "render_wgmma_probe", a, b, c, d, n,
                  scale_c)
    torch.cuda.synchronize()
    a, b, c = a.cpu(), b.cpu(), c.cpu()
    want = torch.stack([tc_step(a[i], b[i], c[i] if scale_c else None)
                        for i in range(n)])
    assert torch.equal(d.cpu(), want)


@pytest.mark.cuda
def test_render_sine_equals_sinf_on_card(card):
    """The kernels' register-only sine (``csrc/render_common.cuh``)
    against CUDA's sinf on every float32 bit pattern, through the probe in
    ``csrc/render_probe.cu``: equal to the bit (any NaN for any NaN)."""
    from spnerf_tpu_torch.kernels import _build

    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    _build.launch("render_probe", "render_sine_mismatches", count)
    torch.cuda.synchronize()
    assert int(count) == 0


@pytest.mark.cuda
def test_tf32_wgmma_reads_the_top_19_bits_on_card(card):
    """The float32 render hands the tensor cores raw float32 words as TF32
    operands (csrc/tf32_tc.cuh): one wgmma m64n8k8 .tf32 (the probe in
    csrc/render_probe.cu) on 256 problems of full float32 mantissas over
    2^-12 .. 2^4 gives the bits it gives on the words cut toward zero to
    TF32, and not those of the words rounded to nearest TF32."""
    from spnerf_tpu_torch.kernels import _build

    rng = np.random.default_rng(32)
    n = 256

    def spread(shape):
        return (rng.choice([-1.0, 1.0], shape) * rng.uniform(1, 2, shape)
                * 2.0 ** rng.integers(-12, 5, shape)).astype(np.float32)

    a = torch.from_numpy(spread((n, 64, 8))).cuda()
    b = torch.from_numpy(spread((n, 8, 8))).cuda()
    c = torch.from_numpy(spread((n, 64, 8))).cuda()

    def probe(x, y):
        d = torch.empty_like(c)
        _build.launch("render_probe", "render_tf32_probe", x, y, c, d, n)
        return d

    def cut(x):
        return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)

    def rounded(x):
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    raw, trunc, near = probe(a, b), probe(cut(a), cut(b)), probe(rounded(a), rounded(b))
    torch.cuda.synchronize()
    assert torch.equal(raw, trunc)
    assert not torch.equal(raw, near)


def _f32_case(width, N, rng):
    """A random float32 field hot enough for the early stop, flags with
    zeros over 48-ray blocks, on the card: (weights, (oe, de, df), keywords
    of render_fused or render_fused_packed)."""
    p = {k: (rng.standard_normal((width, width)) * 0.1).astype(np.float32)
         for k in ("w1", "w2", "w3")}
    p["w3"][:, 0] = np.abs(p["w3"][:, 0]) * {128: 1.0, 64: 6.0, 32: 25.0}[width] + 0.05
    oe = rng.uniform(-3, 3, (N, width)).astype(np.float32)
    de = rng.uniform(-2, 2, (N, width)).astype(np.float32)
    oe[:, 0], de[:, 0] = np.pi / 2, 0.0  # the constant-one lane
    df = (rng.standard_normal((N, width)) * 0.1).astype(np.float32)
    df[(np.arange(N) // 50) % 2 == 0] += 0.5
    flags = rng.uniform(size=(-(-N // 48), 4)) > 0.3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    kw = dict(jitter=0.37, n_samples=16, near=2.0, far=6.0, block=48,
              s_chunk=4 if width == 128 else 4 * width // 128,
              flags=t(flags.astype(np.int32)), early_stop_eps=1e-3)
    if width != 128:
        kw["width"] = width
    return [t(p[k]) for k in ("w1", "w2", "w3")], (t(oe), t(de), t(df)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 64, 32])
@pytest.mark.parametrize("N", [1, 63, 65, 333, 1000])
def test_render_f32_ragged_n_on_card(card, width, N):
    """The float32 render (render_f32_kernel) at N around and off its
    tiles (64, 128 and 256 rays) and the M-tiles' groups, against its
    plain version at the float32 tolerances (rgb 2e-5, depth 1e-4), two
    launches bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R

    ws, (oe, de, df), kw = _f32_case(width, N, np.random.default_rng(140 + N))
    kernel, plain = ((R.render_fused, R.render_fused_plain) if width == 128 else
                     (R.render_fused_packed, R.render_fused_packed_plain))
    key = "render[f32]" if width == 128 else f"render[f32-w{width}]"
    before = _build.launch_counts[key]
    got, again = kernel(oe, de, *ws, df, **kw), kernel(oe, de, *ws, df, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[key] == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = plain(oe, de, *ws, df, **kw)
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render f32 w{width} N {N}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 2e-5 and depth_err <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 64, 32])
def test_render_f32_at_the_drive_operands_on_card(card, width):
    """The float32 render on a committed sphere field (its bf16 weights as
    float32) at the render drive's 131,072 orbit rays x 32 samples, early
    stop on, against its plain version on the card (cuBLAS's float32
    products, TF32 off) at the float32 tolerances."""
    from spnerf_tpu_torch.kernels import render as R
    from spnerf_tpu_torch.tools.kernel_times import render_drive

    f = render_drive()[2][width]
    ws = [w.float() for w in f.ws]
    kw = dict(f.kw) if width == 128 else dict(f.kw, width=width)
    kernel, plain = ((R.render_fused, R.render_fused_plain) if width == 128 else
                     (R.render_fused_packed, R.render_fused_packed_plain))
    got = kernel(f.oe, f.de, *ws, f.df, **kw)
    want = plain(f.oe, f.de, *ws, f.df, **kw)
    assert float(want[0].max()) > 0.05
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render f32 drive w{width}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 2e-5 and depth_err <= 1e-4


def _bf16_scaled_ulps(got, want, floor):
    from _torch_port import bf16_scaled_ulps
    return bf16_scaled_ulps(got.cpu(), want.cpu(), floor)


def _layer_case(kind, rng):
    """(wrapper, plain, args, kwargs, chain?) for the per-layer kernels and
    the bf16 instances of the fused ones, at ragged shapes (edges that are
    not multiples of the 16 x 16 or 128-row tiles). ``kind`` is
    "<op>_<dtype>_<shape>"."""
    from spnerf_tpu_torch.kernels import conv_stack as S

    op, dtype, *shape = kind.split("_")
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731

    def act(shape):  # activations as the stack holds them (after ReLU)
        if dtype == "int8":
            return t(_int8(rng, shape, 0, 128))
        return t(rng.uniform(0, 1, shape).astype(np.float32)).to(torch.bfloat16)

    def weights(shape):
        if dtype == "int8":
            return t(_int8(rng, shape))
        fan_in = int(np.prod(shape[:-1]))
        return t((rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)).to(torch.bfloat16)

    def mb(c, lo=5e-5, hi=4e-4):
        if dtype == "int8":
            return [t(a) for a in _mb(rng, c, lo, hi)]
        return [torch.ones(c, device="cuda"),
                t((rng.standard_normal(c) * 0.1).astype(np.float32))]

    out = torch.int8 if dtype == "int8" else torch.bfloat16
    if op in ("conv", "packed"):
        cin, cout, pool = {"64-64-pool": (64, 64, True), "64-64": (64, 64, False),
                           "64-128": (64, 128, False),
                           "128-128-pool": (128, 128, True),
                           "128-128": (128, 128, False),
                           "128-256": (128, 256, False)}[shape[0]]
        fn = S.packed_conv3x3 if op == "packed" else S.conv3x3
        args = [act((2, 20, 36, cin)), weights((3, 3, cin, cout)), *mb(cout)]
        return fn, S.conv3x3_plain, args, {"out_dtype": out, "pool": pool}, False
    if op == "dot":
        cout = int(shape[0])
        x = act((2, 7, 13, 256))
        if dtype == "int8":  # heads see signed int8 mids
            x = t(_int8(rng, (2, 7, 13, 256)))
        m, b = mb(cout, 2e-5, 1e-4)
        return (S.dot_bias_act, S.dot_bias_act_plain,
                [x, weights((256, cout)), m, b], {"relu": False}, False)
    if op == "conv1":
        image = t(rng.uniform(0, 1, (3, 37, 53, 1)).astype(np.float32))
        w1 = t((rng.standard_normal((3, 3, 1, 64)) / 3).astype(np.float32))
        b = t((rng.standard_normal(64) * 0.1).astype(np.float32))
        return (S.conv1_packed, S.conv1_packed_plain,
                [image, w1, torch.ones(64, device="cuda"), b],
                {"out_dtype": torch.bfloat16}, False)
    if op == "double":
        cin, cm, pool = {"64-64": (64, 64, True), "64-128": (64, 128, True),
                         "128-128": (128, 128, False)}[shape[0]]
        args = [act((2, 20, 36, cin)), weights((3, 3, cin, cm)), *mb(cm),
                weights((3, 3, cm, cm)), *mb(cm)]
        return double_conv3x3, double_conv3x3_plain, args, {"pool": pool}, True
    cout = 65 if shape[0].startswith("65") else 256
    m1, b1 = mb(cout, 2e-5, 1e-4)
    args = [act((2, 12, 20, 128)), weights((3, 3, 128, 256)), *mb(256),
            weights((256, cout)), m1, b1 * 10]
    kw = {"softmax_lanes": 65} if shape[0] == "65-softmax" else {}
    return head, head_plain, args, kw, True


LAYER_CASES = (
    [f"{op}_{dt}_{s}" for op, s in (("packed", "64-64-pool"), ("packed", "64-64"),
                                   ("packed", "64-128"), ("conv", "128-128-pool"),
                                   ("conv", "128-128"), ("conv", "128-256"))
     for dt in ("int8", "bf16")]
    + [f"dot_{dt}_{c}" for dt in ("int8", "bf16") for c in (65, 256)]
    + ["conv1_f32_9-64"]
    + [f"double_bf16_{s}" for s in ("64-64", "64-128", "128-128")]
    + [f"head_bf16_{s}" for s in ("65-softmax", "65", "256")])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LAYER_CASES)
def test_layer_kernel_matches_plain_on_card(card, kind):
    """int8 results exactly equal; bf16 results within 2 ulps with at most
    0.1% beyond 1 (float32 FMAs in a fixed order against float64 sums
    rounded once), ulps counted by ``bf16_scaled_ulps`` at no less than
    1/256 of the tensor's largest magnitude, and at no less than 1/4 for
    the chains through a bf16 mid (a mid value rounded apart moves every
    output it feeds by the weight times its ulp)."""
    from spnerf_tpu_torch.kernels import _build

    kernel, plain, args, kw, chain = _layer_case(kind,
                                                 np.random.default_rng(23))
    before = sum(_build.launch_counts.values())
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 2
    assert torch.equal(got.view(torch.int8), again.view(torch.int8))
    want = plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.int8:
        assert torch.equal(got, want)
        return
    d = _bf16_scaled_ulps(got, want, 2.0 ** -2 if chain else 2.0 ** -8)
    share = float((d > 1).float().mean())
    print(f"{kind}: max {float(d.max())} ulps, {share:.3e} beyond 1")
    assert float(d.max()) <= 2 and share <= 1e-3


# the bf16 tensor-core instances of conv3x3.cu and double_conv3x3.cu:
# (op, C_in, C_out, pool) -> wrapper; shapes (B, H, W): several whole
# tiles, ragged edges at batch 1, W % 16 == 8, a single tile at batch 1
TC_INSTANCES = {
    "packed_64-64-pool": ("packed", 64, 64, True),
    "packed_64-64": ("packed", 64, 64, False),
    "packed_64-128": ("packed", 64, 128, False),
    "conv_128-128-pool": ("conv", 128, 128, True),
    "conv_128-128": ("conv", 128, 128, False),
    "conv_128-256": ("conv", 128, 256, False),
    "double_64-64-pool": ("double", 64, 64, True),
    "double_64-128-pool": ("double", 64, 128, True),
    "double_128-128": ("double", 128, 128, False),
    "double_128-128-pool": ("double", 128, 128, True),
}
TC_SHAPES = {"aligned": (2, 48, 64), "ragged": (1, 30, 44),
             "w8": (2, 24, 40), "batch1": (1, 16, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(TC_SHAPES))
@pytest.mark.parametrize("instance", list(TC_INSTANCES))
def test_tc_conv_matches_plain_on_card(card, instance, shape):
    """Each bf16 instance of the tensor-core convs against its plain
    version at whole-tile, ragged, W % 16 == 8 and batch-1 shapes, with
    the bounds of ``test_layer_kernel_matches_plain_on_card`` (a chain
    through the bf16 mid at the 1/4 floor); two runs bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import conv_stack as S

    op, cin, cout, pool = TC_INSTANCES[instance]
    B, H, W = TC_SHAPES[shape]
    rng = np.random.default_rng(24)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).cuda().to(torch.bfloat16)

    def weights(ci, co):
        return bf16(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))

    def mb(c):
        return [torch.ones(c, device="cuda"),
                torch.from_numpy((rng.standard_normal(c) * 0.1).astype(
                    np.float32)).cuda()]

    x = bf16(rng.uniform(0, 1, (B, H, W, cin)))
    if op == "double":
        args = [x, weights(cin, cout), *mb(cout), weights(cout, cout),
                *mb(cout)]
        kernel, plain, kw = double_conv3x3, double_conv3x3_plain, {"pool": pool}
    else:
        args = [x, weights(cin, cout), *mb(cout)]
        kernel = S.packed_conv3x3 if op == "packed" else S.conv3x3
        plain = S.conv3x3_plain
        kw = {"out_dtype": torch.bfloat16, "pool": pool}
    before = sum(_build.launch_counts.values())
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 2
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    want = plain(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(want.float().abs().max()) > 0
    d = _bf16_scaled_ulps(got, want, 2.0 ** -2 if op == "double" else 2.0 ** -8)
    share = float((d > 1).float().mean())
    print(f"{instance} {shape}: max {float(d.max())} ulps, {share:.3e} beyond 1")
    assert float(d.max()) <= 2 and share <= 1e-3


@pytest.mark.cuda
def test_layer_wrappers_raise_on_what_the_kernels_do_not_take(card):
    from spnerf_tpu_torch.kernels import conv_stack as S

    x = torch.zeros(1, 8, 8, 32, dtype=torch.int8, device="cuda")
    w = torch.zeros(3, 3, 32, 32, dtype=torch.int8, device="cuda")
    ones, zeros = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    with pytest.raises(RuntimeError, match="conv3x3_launch"):
        S.conv3x3(x, w, ones, zeros)  # no C_in 32 instance
    with pytest.raises(ValueError, match="same type"):
        S.conv3x3(x, w, ones, zeros, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        S.dot_bias_act(torch.zeros(4, 32, device="cuda"),
                       torch.zeros(32, 16, device="cuda"), ones[:16],
                       zeros[:16])


# (B, Hc, Wc, C, K, map dtype, normalize, points, instance): C 256 on the
# path (60 x 80 at B 1, 2 and 64); C 20 and 300 take the element-by-element
# loads (C % 8 != 0), C 300 and 512 two chunks; Hc 3 has fewer rows than
# the ring's five slots; Wc 120 x C 256 is too wide for five slots. Points
# "spread" cover every border and lie up to 5 px beyond it, "one row" all
# share one base row, "corner" all lie beyond the bottom-right corner.
RING_KEY, GATHER_KEY, F32_KEY = ("desc_sample[bf16]",
                                 "desc_sample[bf16-gather]",
                                 "desc_sample[f32]")
DESC_SAMPLE_CASES = {
    "bf16_256": (2, 15, 20, 256, 1000, torch.bfloat16, True, "spread",
                 RING_KEY),
    "bf16_256_raw": (2, 15, 20, 256, 77, torch.bfloat16, False, "spread",
                     RING_KEY),
    "path_b1": (1, 60, 80, 256, 1024, torch.bfloat16, True, "spread",
                RING_KEY),
    "path_b2_raw": (2, 60, 80, 256, 1024, torch.bfloat16, False, "spread",
                    RING_KEY),
    "path_b64": (64, 60, 80, 256, 1024, torch.bfloat16, True, "spread",
                 RING_KEY),
    "path_b64_raw": (64, 60, 80, 256, 1024, torch.bfloat16, False, "spread",
                     RING_KEY),
    "one_row_raw": (3, 60, 80, 256, 500, torch.bfloat16, False, "one row",
                    RING_KEY),
    "corner_raw": (2, 60, 80, 256, 300, torch.bfloat16, False, "corner",
                   RING_KEY),
    "k1": (4, 60, 80, 256, 1, torch.bfloat16, True, "spread", RING_KEY),
    "hc3_raw": (2, 3, 9, 64, 200, torch.bfloat16, False, "spread", RING_KEY),
    "wide_gather_raw": (2, 10, 120, 256, 300, torch.bfloat16, False,
                        "spread", GATHER_KEY),
    "wide_gather": (2, 10, 120, 256, 300, torch.bfloat16, True, "spread",
                    GATHER_KEY),
    "f32_64": (3, 7, 9, 64, 33, torch.float32, True, "spread", F32_KEY),
    "f32_path_raw": (2, 60, 80, 256, 1024, torch.float32, False, "spread",
                     F32_KEY),
    "bf16_20": (1, 6, 5, 20, 50, torch.bfloat16, True, "spread", GATHER_KEY),
    "bf16_20_raw": (2, 6, 5, 20, 50, torch.bfloat16, False, "spread",
                    GATHER_KEY),
    "f32_300": (2, 4, 6, 300, 40, torch.float32, True, "spread", F32_KEY),
    "bf16_512_raw": (1, 5, 7, 512, 20, torch.bfloat16, False, "spread",
                     RING_KEY),
    "bf16_512": (2, 5, 7, 512, 20, torch.bfloat16, True, "spread", RING_KEY),
}


def _desc_sample_operands(B, Hc, Wc, C, K, dtype, points, seed=31):
    rng = np.random.default_rng(seed)
    desc = torch.from_numpy(rng.standard_normal((B, Hc, Wc, C)).astype(
        np.float32)).to(dtype).cuda()
    h, w = Hc * 8 - 1, Wc * 8 - 1
    if points == "spread":
        pts = np.stack([rng.uniform(-5, h + 5, (B, K)),
                        rng.uniform(-5, w + 5, (B, K))], -1)
        pts[:, :4] = [[0, 0], [h, w], [0, w], [h, 0]][:K]
    elif points == "one row":
        pts = np.stack([np.full((B, K), 8.0 * (Hc // 2) + 2.75),
                        rng.uniform(-5, w + 5, (B, K))], -1)
    else:  # beyond the bottom-right corner
        pts = np.stack([rng.uniform(h, h + 40, (B, K)),
                        rng.uniform(w, w + 40, (B, K))], -1)
    return desc, torch.from_numpy(pts.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(DESC_SAMPLE_CASES))
def test_desc_sample_matches_plain_on_card(card, kind):
    """The instance the shape takes launches (once per call); unnormalized
    rows equal to the plain version (same weights, same bf16 roundings,
    the same float32 sum order); unit vectors within 1e-6 (the sum of
    squares runs in another order); two runs bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.desc_sample import (
        instance,
        sample_descriptors_fused,
        sample_descriptors_fused_plain,
    )

    B, Hc, Wc, C, K, dtype, normalize, points, key = DESC_SAMPLE_CASES[kind]
    assert instance(dtype, Hc, Wc, C, K)[0] == key
    desc, pts = _desc_sample_operands(B, Hc, Wc, C, K, dtype, points)
    before = _build.launch_counts.copy()
    got = sample_descriptors_fused(desc, pts, 8, normalize)
    again = sample_descriptors_fused(desc, pts, 8, normalize)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts - before) == {key: 2}
    assert torch.equal(got, again)
    want = sample_descriptors_fused_plain(desc, pts, 8, normalize)
    assert got.shape == (B, K, C) and got.dtype == torch.float32
    if normalize:
        err = float((got - want).abs().max())
        print(f"{kind}: max |kernel - plain| {err:.3e}")
        assert err <= 1e-6
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_desc_sample_ring_bands_give_the_same_bits(card, normalize):
    """The ring at every forced band count (one band, the default's two
    at B 64 on 132 SMs, uneven bands, one base row a band), on an image
    whose points crowd into its top quarter among two spread ones, gives
    the bits of the default launch, and unnormalized the plain version's;
    the gather instance on the same operands (the float32 map of the same
    bf16 values) gives them too."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.desc_sample import (
        sample_descriptors_fused,
        sample_descriptors_fused_plain,
    )

    desc, pts = _desc_sample_operands(3, 60, 80, 256, 1024, torch.bfloat16,
                                      "spread", seed=5)
    pts[1, :700, 0] = pts[1, :700, 0] * 0.25  # crowd a third into a band
    want = sample_descriptors_fused(desc, pts, 8, normalize)
    if not normalize:
        assert torch.equal(want, sample_descriptors_fused_plain(desc, pts, 8,
                                                                False))
    before = _build.launch_counts.copy()
    for bands in (1, 2, 7, 13, 30, 59, 60):
        got = sample_descriptors_fused(desc, pts, 8, normalize, bands=bands)
        assert torch.equal(got, want), bands
    assert torch.equal(sample_descriptors_fused(desc.float(), pts, 8,
                                                normalize), want)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts - before) == {RING_KEY: 7, F32_KEY: 1}


@pytest.mark.cuda
def test_desc_sample_ring_layout_matches_the_kernel(card):
    """The wrapper's statement of the ring block's shared memory equals
    the kernel's, and the shapes the wrapper sends to the gather are the
    ones the kernel's ring refuses."""
    import ctypes

    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.desc_sample import ring_bytes

    fn = _build.load("desc_sample").desc_sample_ring_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for Hc, Wc, C, K in ((60, 80, 256, 1024), (60, 80, 256, 1), (3, 9, 64, 200),
                         (5, 7, 512, 20), (15, 20, 256, 1000), (60, 80, 256, 6000)):
        assert fn(Hc, Wc, C, K) == ring_bytes(Hc, Wc, C, K)
    for Hc, Wc, C, K in ((10, 120, 256, 300), (6, 5, 20, 50),
                         (60, 80, 256, 9000)):
        assert fn(Hc, Wc, C, K) == -1


@pytest.mark.cuda
def test_desc_sample_raises_on_what_the_kernel_does_not_take(card):
    from spnerf_tpu_torch.kernels.desc_sample import sample_descriptors_fused

    pts = torch.zeros(1, 4, 2, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        sample_descriptors_fused(torch.zeros(1, 4, 4, 8, dtype=torch.float16,
                                             device="cuda"), pts)
    with pytest.raises(ValueError, match="needs \\(B, K, 2\\)"):
        sample_descriptors_fused(torch.zeros(2, 4, 4, 8, device="cuda"), pts)
    with pytest.raises(ValueError, match="aligned"):
        sample_descriptors_fused(
            torch.zeros(1 * 4 * 4 * 8 + 1, device="cuda")[1:].reshape(
                1, 4, 4, 8), pts)
    bf16 = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="needs 1 to Hc"):
        sample_descriptors_fused(bf16, pts, bands=5)
    with pytest.raises(ValueError, match="takes no bands"):
        sample_descriptors_fused(bf16.float(), pts, bands=2)


# the tensor-core instances of head.cu (bf16) and dot_bias_act.cu (int8,
# bf16) and its float32 conv1 instance: shapes of the serving path and
# ragged ones (H not a multiple of the 8 x 16 tile, M not a multiple of
# the 64- or 256-row tile)
HEAD_TC_SHAPES = {"2x60x80": (2, 60, 80), "1x30x40": (1, 30, 40),
                  "3x12x20": (3, 12, 20), "1x7x13": (1, 7, 13)}
HEAD_TC_KINDS = {"65-softmax": (65, True), "65": (65, False),
                 "256": (256, False)}
DOT_TC_ROWS = (1, 63, 65, 129, 37920, 38400)
CONV1_SHAPES = {"M1": (1, 1, 1), "M63": (1, 7, 9), "M65": (1, 5, 13),
                "M129": (1, 3, 43), "M37920": (8, 60, 79)}


def _bf16_card(a):
    return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(torch.bfloat16)


def _head_tc_operands(rng, cout):
    w3 = _bf16_card(rng.standard_normal((3, 3, 128, 256)) / np.sqrt(9 * 128))
    w1 = _bf16_card(rng.standard_normal((256, cout)) / 16)
    b3 = torch.from_numpy((rng.standard_normal(256) * 0.1).astype(np.float32))
    b1 = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32) * 10)
    return (w3, torch.ones(256, device="cuda"), b3.cuda(), w1,
            torch.ones(cout, device="cuda"), b1.cuda())


def _same_bits(a, b):
    return torch.equal(a.view(torch.int8), b.view(torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(HEAD_TC_SHAPES))
@pytest.mark.parametrize("kind", list(HEAD_TC_KINDS))
def test_head_tc_matches_plain_on_card(card, kind, shape):
    """The bf16 head on the tensor cores against its plain version: within
    2 ulps, at most 0.1% beyond 1, at the chains' floor of 1/4 of the
    largest magnitude (the bf16 mid); prepared and raw calls, and two
    launches, give the same bits."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.tail_fused import prepare_head

    cout, softmax = HEAD_TC_KINDS[kind]
    rng = np.random.default_rng(30 + cout)
    x = _bf16_card(rng.uniform(0, 1, (*HEAD_TC_SHAPES[shape], 128)))
    raw = _head_tc_operands(rng, cout)
    kw = {"softmax_lanes": 65} if softmax else {}
    ops = prepare_head(*raw)
    before = sum(_build.launch_counts.values())
    got = head(x, ops, **kw)
    again = head(x, ops, **kw)
    from_raw = head(x, *raw, **kw)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 3
    assert _same_bits(got, again) and _same_bits(got, from_raw)
    want = head_plain(x, *raw, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _bf16_scaled_ulps(got, want, 2.0 ** -2)
    share = float((d > 1).float().mean())
    print(f"head {kind} {shape}: max {float(d.max())} ulps, {share:.3e} "
          "beyond 1")
    assert float(d.max()) <= 2 and share <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("M", DOT_TC_ROWS)
@pytest.mark.parametrize("cout", [65, 256])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_dot_tc_matches_plain_on_card(card, dtype, cout, M):
    """``dot_bias_act`` on the tensor cores against its plain version: int8
    equal, bf16 within 2 ulps with at most 0.1% beyond 1 (floor 1/256);
    prepared and raw calls, and two launches, give the same bits."""
    from spnerf_tpu_torch.kernels import conv_stack as S

    rng = np.random.default_rng(M + cout)
    if dtype == "int8":
        x = torch.from_numpy(_int8(rng, (M, 256))).cuda()
        w = torch.from_numpy(_int8(rng, (256, cout))).cuda()
        m, b = (torch.from_numpy(a).cuda() for a in _mb(rng, cout, 2e-5, 1e-4))
    else:
        x = _bf16_card(rng.uniform(0, 1, (M, 256)))
        w = _bf16_card(rng.standard_normal((256, cout)) / 16)
        m = torch.ones(cout, device="cuda")
        b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(
            np.float32)).cuda()
    ops = S.prepare_dot(w, m, b)
    got = S.dot_bias_act(x, ops)
    again = S.dot_bias_act(x, ops)
    from_raw = S.dot_bias_act(x, w, m, b)
    torch.cuda.synchronize()
    assert _same_bits(got, again) and _same_bits(got, from_raw)
    want = S.dot_bias_act_plain(x, w, m, b)
    assert got.shape == want.shape == (M, cout)
    if dtype == "int8":
        assert torch.equal(got, want)
        return
    d = _bf16_scaled_ulps(got, want, 2.0 ** -8)
    share = float((d > 1).float().mean())
    assert float(d.max()) <= 2 and share <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["bf16", "int8"])
@pytest.mark.parametrize("shape", list(CONV1_SHAPES))
def test_conv1_f32_matches_plain_on_card(card, shape, out):
    """conv1's float32 patch product: bf16 out within 2 ulps (floor
    1/256), at most 0.1% beyond 1; int8 out within 1 (float32 FMAs in tap
    order against float64 sums rounded once: a value a rounding away from
    a half rounds the other way); prepared and raw calls, and two
    launches, give the same bits."""
    from spnerf_tpu_torch.kernels import conv_stack as S

    rng = np.random.default_rng(50)
    B, H, W = CONV1_SHAPES[shape]
    image = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 1)).astype(
        np.float32)).cuda()
    w1 = torch.from_numpy((rng.standard_normal((3, 3, 1, 64)) / 3).astype(
        np.float32)).cuda()
    if out == "bf16":
        dt, m = torch.bfloat16, torch.ones(64, device="cuda")
        b = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(
            np.float32)).cuda()
    else:
        dt = torch.int8
        m = torch.full((64,), 40.0, device="cuda")
        b = torch.from_numpy((rng.standard_normal(64) * 5).astype(
            np.float32)).cuda()
    ops = S.prepare_conv1(w1, m, b)
    got = S.conv1_packed(image, ops, out_dtype=dt)
    again = S.conv1_packed(image, ops, out_dtype=dt)
    from_raw = S.conv1_packed(image, w1, m, b, out_dtype=dt)
    torch.cuda.synchronize()
    assert _same_bits(got, again) and _same_bits(got, from_raw)
    want = S.conv1_packed_plain(image, w1, m, b, out_dtype=dt)
    assert got.shape == want.shape == (B, H, W, 64)
    if out == "int8":
        assert int((got.int() - want.int()).abs().max()) <= 1
        return
    d = _bf16_scaled_ulps(got, want, 2.0 ** -8)
    assert float(d.max()) <= 2 and float((d > 1).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_tc_head_and_dot_raise_on_what_they_do_not_take(card):
    from spnerf_tpu_torch.kernels import conv_stack as S
    from spnerf_tpu_torch.kernels.tail_fused import prepare_head

    rng = np.random.default_rng(60)
    x = torch.zeros(1, 8, 16, 128, dtype=torch.bfloat16, device="cuda")
    raw = _head_tc_operands(rng, 256)
    with pytest.raises(ValueError, match="no kernel"):
        head(x, *raw, softmax_lanes=256)  # the softmax takes 65 lanes
    w3, m3, b3 = _bf16_card(np.zeros((3, 3, 128, 128))), *raw[1:3]
    with pytest.raises(ValueError, match="no kernel"):
        head(x, w3, m3[:128], b3[:128], raw[3][:128], *raw[4:])  # CM 128
    with pytest.raises(ValueError, match="CUDA tensor"):
        head(x, prepare_head(*(t.cpu() for t in raw)))
    ones, zeros = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    xb = torch.zeros(5, 256, dtype=torch.bfloat16, device="cuda")
    for cin, cout in ((256, 100), (128, 64)):  # no N 100; no K 128
        with pytest.raises(ValueError, match="no kernel"):
            S.dot_bias_act(xb[:, :cin],
                           torch.zeros(cin, cout, dtype=torch.bfloat16,
                                       device="cuda"), ones[:cout],
                           zeros[:cout])
    with pytest.raises(ValueError, match="no kernel"):  # no int8 out
        S.dot_bias_act(xb, torch.zeros(256, 64, dtype=torch.bfloat16,
                                       device="cuda"), ones[:64], zeros[:64],
                       out_dtype=torch.int8)
    with pytest.raises(ValueError, match="no kernel"):  # float32 takes K 9
        S.dot_bias_act(torch.zeros(5, 12, device="cuda"),
                       torch.zeros(12, 64, device="cuda"), ones[:64],
                       zeros[:64])


# row 1 on the int8 tensor cores: ragged shapes against the 16 x 32 output
# tile (H, W not multiples of it, W 632 of the narrow serving route, odd
# H and W without the pool), whole tiles, and more tiles than the
# persistent grid holds at once
CONV12_SHAPES = {"1x7x13": (1, 7, 13), "2x40x56": (2, 40, 56),
                 "3x34x632": (3, 34, 632), "1x16x32": (1, 16, 32),
                 "2x18x66": (2, 18, 66), "40x48x96": (40, 48, 96)}


def _conv12_raw(rng, k1_scale=0.3, w2=None, mult2=(1e-4, 6e-4)):
    """Raw conv12 operands on the card: conv1 kernel, its requant at an
    activation scale of 0.02, int8 conv2 weights with per-channel
    multipliers in ``mult2`` and biases in +-20."""
    t = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    s1 = np.float32(0.02)
    return (t((rng.standard_normal((3, 3, 1, 64)) * k1_scale).astype(
                np.float32)),
            t(np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1))),
            t((rng.standard_normal(64) * 0.1 / s1).astype(np.float32)),
            t(_int8(rng, (3, 3, 64, 64)) if w2 is None else w2),
            *(t(a) for a in _mb(rng, 64, *mult2)))


def _conv12_held(image, raw, pool, relu=True):
    """Prepared call, a second launch and a raw call: the same bits, and
    equal to the plain version; returns the output."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.conv12_fused import prepare_conv12

    ops = prepare_conv12(*raw)
    before = sum(_build.launch_counts.values())
    got = conv12_fused(image, ops, pool=pool, relu=relu)
    again = conv12_fused(image, ops, pool=pool, relu=relu)
    from_raw = conv12_fused(image, *raw, pool=pool, relu=relu)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 3
    assert torch.equal(got, again) and torch.equal(got, from_raw)
    want = conv12_fused_plain(image, *raw, pool=pool, relu=relu)
    assert got.shape == want.shape and got.dtype == torch.int8
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("shape", list(CONV12_SHAPES))
def test_conv12_tc_matches_plain_on_card(card, shape, pool):
    """``conv12_fused`` on the int8 tensor cores equal to its plain
    version, prepared = raw = a second launch, at ragged and whole-tile
    shapes; pooling an odd H or W raises."""
    B, H, W = CONV12_SHAPES[shape]
    rng = np.random.default_rng(70 + H + W)
    image = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 1)).astype(
        np.float32)).cuda()
    raw = _conv12_raw(rng)
    if pool and (H % 2 or W % 2):
        with pytest.raises(ValueError, match="even"):
            conv12_fused(image, *raw, pool=True)
        return
    got = _conv12_held(image, raw, pool)
    assert (got > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero_and_one", "half_boundary",
                                  "saturating", "zero_channels"])
def test_conv12_tc_edge_values_on_card(card, kind):
    """Images at 0 and 1; images whose x * 127 is a .5 tie in float32
    (rintf to even); conv1 and conv2 saturating at +-127 (large weights
    and multipliers, with and without the ReLU); conv1 channels whose
    weights are all 0 (the 1e-12 scale floor)."""
    rng = np.random.default_rng(90)
    B, H, W = 2, 20, 36
    if kind == "zero_and_one":
        img = rng.integers(0, 2, (B, H, W, 1)).astype(np.float32)
    else:
        # float32 x with x * 127 == k + 0.5 exactly, k in 0..126
        ks = np.arange(127, dtype=np.float32)
        x = ((ks + np.float32(0.5)) / np.float32(127)).astype(np.float32)
        x = x[(x * np.float32(127)) == ks + np.float32(0.5)]
        assert len(x) > 10
        img = rng.choice(x, (B, H, W, 1)).astype(np.float32)
        if kind != "half_boundary":
            img = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    image = torch.from_numpy(img).cuda()
    if kind == "saturating":
        w2 = np.where(rng.uniform(size=(3, 3, 64, 64)) < 0.5, -127,
                      127).astype(np.int8)
        raw = _conv12_raw(rng, 3.0, w2, (1e-2, 5e-2))
        for relu in (True, False):
            got = _conv12_held(image, raw, True, relu)
            assert (got == 127).any() and (relu or (got == -127).any())
        return
    raw = list(_conv12_raw(rng))
    if kind == "zero_channels":
        raw[0][..., ::7] = 0
    for pool in (True, False):
        _conv12_held(image, raw, pool)


# row 9: widths with W % 4 in {0, 1, 2, 3} around the 128-column tile,
# three homographies per image (N = 3 B), one with a zero denominator
WARP_WIDTHS = [52, 53, 54, 55, 128, 131]


@pytest.mark.cuda
@pytest.mark.parametrize("width", WARP_WIDTHS)
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_warp_tile_edges_on_card(card, mode, width):
    """The warp kernel's 16-byte stores and their scalar tails: within
    1e-6 of the plain version at W % 4 in {0, 1, 2, 3}, H not a multiple
    of the 8-row tile, N = 3 B with a zero denominator in the first
    homography."""
    from spnerf_tpu_torch.kernels.warp import (
        warp_image_fused,
        warp_image_fused_plain,
    )

    rng = np.random.default_rng(18 + width)
    B, H = 2, 19
    img = rng.uniform(0, 1, (B, H, width, 1)).astype(np.float32)
    Hs = np.tile(np.eye(3, dtype=np.float32), (3 * B, 1, 1))
    Hs[:, :2] += rng.normal(0, 0.1, (3 * B, 2, 3)).astype(np.float32)
    Hs[:, :2, 2] *= 10
    Hs[:, 2, :2] = rng.normal(0, 1e-3, (3 * B, 2)).astype(np.float32)
    Hs[0] = [[1, 0, 0], [0, 1, 0], [1 / 16, 0, 1]]  # d = 0 on x = 16
    dtype = torch.int8 if mode == "int8" else torch.bfloat16
    img, Hs = torch.from_numpy(img).cuda(), torch.from_numpy(Hs).cuda()
    got = warp_image_fused(img, Hs, dtype)
    torch.cuda.synchronize()
    want = warp_image_fused_plain(img, Hs, dtype)
    assert got.shape == want.shape == (3 * B, H, width, 1)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6
    assert float((want > 0).float().mean()) > 0.3


# the int8 instances of double_conv3x3 and head on the int8 tensor cores:
# ragged and odd shapes against the 16 x 16 output tile (8 x 16 cell tile
# for the head), whole tiles, HA's 80 x 30 x 40 logits; prepared = raw = a
# second launch, int8 outputs and the head's logits equal to the plain
# version, its softmax within 1 bf16 ulp
S8_DC_INSTANCES = {"64-64-64-pool": (64, 64, True), "64-128-128-pool": (64, 128, True),
                   "128-128-128": (128, 128, False), "128-128-128-pool": (128, 128, True)}
S8_SHAPES = {"1x7x13": (1, 7, 13), "2x30x40": (2, 30, 40), "3x34x62": (3, 34, 62)}
S8_HEAD_SHAPES = {**S8_SHAPES, "80x30x40": (80, 30, 40)}
S8_HEAD_KINDS = {"65-softmax": (65, True), "65": (65, False), "256": (256, False)}


def _s8_held(wrapper, plain, prepare, x, raw, kw, exact=True):
    """Prepared call, a second launch and a raw call: the same bits, and
    equal to the plain version (within 1 bf16 ulp unless ``exact``);
    returns the output."""
    from spnerf_tpu_torch.kernels import _build

    ops = prepare(*raw)
    before = sum(_build.launch_counts.values())
    got, again = wrapper(x, ops, **kw), wrapper(x, ops, **kw)
    from_raw = wrapper(x, *raw, **kw)
    torch.cuda.synchronize()
    assert sum(_build.launch_counts.values()) == before + 3
    assert torch.equal(got, again) and torch.equal(got, from_raw)
    want = plain(x, *raw, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        assert torch.equal(got, want)
    else:
        assert bf16_ulp_diff(got.cpu(), want.cpu()) <= 1
    return got


def _s8_dc_raw(rng, cin, cm, mult_b=(-4e-4, 4e-4)):
    """int8 weights, conv_a's multipliers positive, conv_b's of both
    signs by default; biases in +-20."""
    t = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    return (t(_int8(rng, (3, 3, cin, cm))), *(t(a) for a in _mb(rng, cm, 5e-5, 4e-4)),
            t(_int8(rng, (3, 3, cm, cm))), *(t(a) for a in _mb(rng, cm, *mult_b)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(S8_SHAPES))
@pytest.mark.parametrize("instance", list(S8_DC_INSTANCES))
def test_s8_double_conv_matches_plain_on_card(card, instance, shape):
    """Each int8 instance, ReLU on and off, negative multipliers: equal to
    the plain version; pooling an odd H or W raises."""
    from spnerf_tpu_torch.kernels.mid_fused import prepare_double_conv

    cin, cm, pool = S8_DC_INSTANCES[instance]
    B, H, W = S8_SHAPES[shape]
    rng = np.random.default_rng(110 + H + cm)
    x = torch.from_numpy(_int8(rng, (B, H, W, cin), 0, 128)).cuda()
    raw = _s8_dc_raw(rng, cin, cm)
    if pool and (H % 2 or W % 2):
        with pytest.raises(ValueError, match="even"):
            double_conv3x3(x, *raw, pool=True)
        return
    for relu in (True, False):
        got = _s8_held(double_conv3x3, double_conv3x3_plain, prepare_double_conv, x, raw,
                       {"pool": pool, "relu": relu})
        assert (got > 0).any() and (relu or (got < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["saturating", "half_tie", "zero_channels"])
def test_s8_double_conv_edge_values_on_card(card, kind):
    """Inputs and weights at +-127 with large multipliers (every cast
    saturating, with and without the ReLU); sums on a .5 tie of both
    affines (multipliers 0.5, integer biases: rintf to even); channels of
    the input and of both convs' weights all zero."""
    from spnerf_tpu_torch.kernels.mid_fused import prepare_double_conv

    rng = np.random.default_rng(120)
    t = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    for cin, cm, pool in S8_DC_INSTANCES.values():
        B, H, W = 2, 18, 34
        if kind == "saturating":
            x = np.where(rng.uniform(size=(B, H, W, cin)) < 0.5, -127, 127).astype(np.int8)
            w = [np.where(rng.uniform(size=s) < 0.5, -127, 127).astype(np.int8)
                 for s in ((3, 3, cin, cm), (3, 3, cm, cm))]
            raw = (t(w[0]), *(t(a) for a in _mb(rng, cm, 1e-3, 1e-2)), t(w[1]),
                   *(t(a) for a in _mb(rng, cm, -1e-2, 1e-2)))
        elif kind == "half_tie":
            x = _int8(rng, (B, H, W, cin), 0, 2)
            raw = (t(_int8(rng, (3, 3, cin, cm), -1, 2)), t(np.full(cm, 0.5, np.float32)),
                   t(rng.integers(-3, 4, cm).astype(np.float32)),
                   t(_int8(rng, (3, 3, cm, cm), -1, 2)),
                   t(np.where(rng.uniform(size=cm) < 0.5, -0.5, 0.5).astype(np.float32)),
                   t(rng.integers(-3, 4, cm).astype(np.float32)))
        else:
            x = _int8(rng, (B, H, W, cin), 0, 128)
            x[..., ::5] = 0
            raw = list(_s8_dc_raw(rng, cin, cm))
            raw[0][..., ::3] = 0
            raw[0][:, :, ::7] = 0
            raw[3][..., ::4] = 0
        for relu in (True, False):
            got = _s8_held(double_conv3x3, double_conv3x3_plain, prepare_double_conv,
                           t(x) if isinstance(x, np.ndarray) else x, tuple(raw),
                           {"pool": pool, "relu": relu})
            if kind == "saturating":
                assert (got == 127).any() and (relu or (got == -127).any())


def _s8_head_raw(rng, cout, mult3=(5e-5, 4e-4), mult1=(2e-5, 1e-4)):
    t = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    return (t(_int8(rng, (3, 3, 128, 256))), *(t(a) for a in _mb(rng, 256, *mult3)),
            t(_int8(rng, (256, cout))), t(rng.uniform(*mult1, cout).astype(np.float32)),
            t(rng.uniform(-1, 1, cout).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(S8_HEAD_SHAPES))
@pytest.mark.parametrize("kind", list(S8_HEAD_KINDS))
def test_s8_head_matches_plain_on_card(card, kind, shape):
    """The int8 head at ragged shapes and HA's 80 x 30 x 40: logits and
    descriptors equal to the plain version (int32 sums, the same float32
    affine), the softmax within 1 bf16 ulp."""
    from spnerf_tpu_torch.kernels.tail_fused import prepare_head

    cout, soft = S8_HEAD_KINDS[kind]
    B, H, W = S8_HEAD_SHAPES[shape]
    rng = np.random.default_rng(130 + H + cout)
    x = torch.from_numpy(_int8(rng, (B, H, W, 128), 0, 128)).cuda()
    raw = _s8_head_raw(rng, cout)
    kw = {"softmax_lanes": cout} if soft else {}
    got = _s8_held(head, head_plain, prepare_head, x, raw, kw, exact=not soft)
    assert got.shape == (B, H, W, 64 if soft else cout)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["saturating", "zero_channels"])
def test_s8_head_edge_values_on_card(card, kind):
    """The mid saturating at 127 (large multipliers) with negative 1x1
    multipliers; input and weight channels all zero."""
    from spnerf_tpu_torch.kernels.tail_fused import prepare_head

    rng = np.random.default_rng(140)
    for cout, soft in S8_HEAD_KINDS.values():
        x = torch.from_numpy(_int8(rng, (2, 12, 20, 128), 0, 128)).cuda()
        if kind == "saturating":
            raw = _s8_head_raw(rng, cout, (1e-2, 5e-2), (-1e-4, 1e-4))
        else:
            raw = _s8_head_raw(rng, cout)
            x[..., ::6] = 0
            raw[0][..., ::5] = 0
            raw[3][::3] = 0
        kw = {"softmax_lanes": cout} if soft else {}
        _s8_held(head, head_plain, prepare_head, x, raw, kw, exact=not soft)


# row 13 on the int8 tensor cores (render_s8_kernel): the committed
# width-128 sphere field quantized as the render drive quantizes it, at
# the drive's 131,072 orbit rays x 32 samples, dense, early stop, and
# cached occupancy flags with the early stop; and small random fields at N
# around the 64-ray tile. rgb within 1e-4, depth within 1e-3 of the plain
# version; two runs, and the prepared and dict routes, bit-equal.
@pytest.fixture(scope="module")
def render_s8_drive():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from spnerf_tpu_torch.kernels import render as R
    from spnerf_tpu_torch.ops.occupancy import chunk_flags, field_integral_volume
    from spnerf_tpu_torch.tools.kernel_times import render_drive

    o, d, fields = render_drive()
    f = fields[128]
    n = 4096  # chip_smoke.INT8_CALIB_RAYS
    qf = R.quantize_field({k: v.float().cpu().numpy() for k, v in f.params.items()},
                          f.oe[:n].cpu().numpy(), f.de[:n].cpu().numpy(),
                          f.df[:n].cpu().numpy(), n_samples=f.kw["n_samples"],
                          near=f.cfg.near, far=f.cfg.far)
    ivol = field_integral_volume({k: v.float() for k, v in f.params.items()}, f.cfg)
    flags = chunk_flags(o, d, ivol, block=f.kw["block"], n_samples=f.kw["n_samples"],
                        s_chunk=f.kw["s_chunk"], near=f.cfg.near, far=f.cfg.far,
                        extent=float(f.cfg.far))
    return f, qf, R.prepare_render_int8(qf), flags


def _render_s8_held(oe, de, df, qf, ops, kw):
    """Prepared call, a second launch and the dict route: the same bits;
    returns (kernel, plain) outputs."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R

    before = _build.launch_counts["render[int8]"]
    got = R.render_fused_int8(oe, de, ops, df, **kw)
    again = R.render_fused_int8(oe, de, ops, df, **kw)
    by_dict = R.render_fused_int8(oe, de, qf, df, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["render[int8]"] == before + 3
    for other in (again, by_dict):
        assert torch.equal(got[0], other[0]) and torch.equal(got[1], other[1])
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    return got, R.render_fused_int8_plain(oe, de, qf, df, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "early_stop", "cached_flags"])
def test_render_s8_at_the_drive_operands_on_card(render_s8_drive, kind):
    f, qf, ops, flags = render_s8_drive
    kw = dict(f.kw, early_stop_eps=0.0 if kind == "dense" else f.kw["early_stop_eps"],
              flags=flags if kind == "cached_flags" else None)
    got, want = _render_s8_held(f.oe, f.de, f.df, qf, ops, kw)
    assert float(want[0].max()) > 0.05
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    share = float((got[0] != want[0]).float().mean())
    print(f"render s8 {kind}: rgb {rgb_err:.3e} depth {depth_err:.3e}, {share:.3e} differ")
    assert rgb_err <= 1e-4 and depth_err <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 65, 333, 1000])
def test_render_s8_ragged_n_on_card(card, N):
    """A random field hot enough for the early stop, flags with zeros over
    48-ray blocks, N around and off the 64-ray tile."""
    from spnerf_tpu_torch.kernels import render as R

    rng = np.random.default_rng(120 + N)
    p = {k: (rng.standard_normal((128, 128)) * 0.1).astype(np.float32)
         for k in ("w1", "w2", "w3")}
    p["w3"][:, 0] = np.abs(p["w3"][:, 0]) + 0.05
    oe = rng.uniform(-3, 3, (N, 128)).astype(np.float32)
    de = rng.uniform(-2, 2, (N, 128)).astype(np.float32)
    oe[:, 0], de[:, 0] = np.pi / 2, 0.0  # the constant-one lane
    df = (rng.standard_normal((N, 128)) * 0.1).astype(np.float32)
    df[(np.arange(N) // 50) % 2 == 0] += 0.5
    qf = R.quantize_field(p, oe, de, df, n_samples=16, near=2.0, far=6.0, jitter=0.37)
    flags = rng.uniform(size=(-(-N // 48), 4)) > 0.3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    kw = dict(jitter=0.37, n_samples=16, near=2.0, far=6.0, block=48, s_chunk=4,
              flags=t(flags.astype(np.int32)), early_stop_eps=1e-3)
    got, want = _render_s8_held(t(oe), t(de), t(df), qf, R.prepare_render_int8(qf), kw)
    rgb_err = float((got[0] - want[0]).abs().max())
    depth_err = float((got[1] - want[1]).abs().max())
    print(f"render s8 N {N}: rgb {rgb_err:.3e} depth {depth_err:.3e}")
    assert rgb_err <= 1e-4 and depth_err <= 1e-3


# conv3x3's int8 instance on the int8 tensor cores at the per-layer
# route's shapes, batch 8, at 480 x 640 and 480 x 632 (W % 16 == 8 there,
# 79 at 60 rows): (wrapper, C_in, C_out, pool, layer shape at W 640, at
# W 632); multipliers of both signs, prepared = raw = a second launch,
# equal to the plain version
S8_CONV_ROUTE = {
    "packed_64-64": ("packed", 64, 64, False, (240, 320), (240, 316)),
    "packed_64-64-pool": ("packed", 64, 64, True, (240, 320), (240, 316)),
    "packed_64-128": ("packed", 64, 128, False, (120, 160), (120, 158)),
    "conv_128-128-pool": ("conv", 128, 128, True, (120, 160), (120, 158)),
    "conv_128-128": ("conv", 128, 128, False, (60, 80), (60, 79)),
    "conv_128-256": ("conv", 128, 256, False, (60, 80), (60, 79)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [640, 632])
@pytest.mark.parametrize("instance", list(S8_CONV_ROUTE))
def test_s8_conv3x3_at_the_route_shapes_on_card(card, instance, width):
    from spnerf_tpu_torch.kernels import conv_stack as S

    op, cin, cout, pool, at640, at632 = S8_CONV_ROUTE[instance]
    H, W = at640 if width == 640 else at632
    rng = np.random.default_rng(130 + cin + cout + pool + width)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    x = t(_int8(rng, (8, H, W, cin), 0, 128))
    raw = (t(_int8(rng, (3, 3, cin, cout))),
           t(rng.uniform(-4e-4, 4e-4, cout).astype(np.float32)),
           t(rng.uniform(-20, 20, cout).astype(np.float32)))
    fn = S.packed_conv3x3 if op == "packed" else S.conv3x3
    got = _s8_held(fn, S.conv3x3_plain, S.prepare_conv3x3, x, raw, {"pool": pool})
    assert (got > 0).any() and (got == 0).any()


# ------------------------------------------------------- the NeRF pair path


@pytest.mark.cuda
@pytest.mark.parametrize("n_bad", [0, 64], ids=["reprojected", "planted"])
def test_hinge_kernels_on_nerf_cells_on_card(card, n_bad):
    """Rows 10-11 at a NeRF step's shape (B 2, N 4,800, C 256) on cells
    reprojected through depth, and with 64 non-finite and 64 far-off
    cells a sample: no such cell is near any cell centre (NaN compares
    false, as in the plain version), sums and gradients finite and held to
    the plain version on float64 copies (the exact dots' steps), the
    launches one each, two runs bit-equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.tools.kernel_times import nerf_hinge_operands

    A, Bm, wcells, cells, mask, *params = nerf_hinge_operands(
        2, 60, 80, 256, 31, "cuda", n_bad=n_bad)
    assert int((~torch.isfinite(wcells)).any(-1).sum()) == (2 * n_bad
                                                            if n_bad else 0)
    before = _build.launch_counts.copy()
    got, want = _hinge_against_float64(A, Bm, wcells, cells, mask)
    again, _ = _hinge_against_float64(A, Bm, wcells, cells, mask)
    torch.cuda.synchronize()
    assert _build.launch_counts - before == {
        "desc_loss[fwd]": 2, "desc_loss[dA]": 2, "desc_loss[dB]": 2}
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for t in got:
        assert torch.isfinite(t).all()
    assert float(want[0][1].min()) > 0  # positives among the good cells
    _assert_rows_within(got, want)


@pytest.mark.cuda
def test_warp_points_nerf_on_card_against_cpu(card):
    """The reprojection on the card within 2e-3 px of the CPU (the two
    devices' float32 LU inverses), at 480 x 640."""
    from spnerf_tpu_torch.geometry.reprojection import warp_points_nerf

    from spnerf_tpu_torch.tools.kernel_times import nerf_geometry

    rng = np.random.default_rng(32)
    depths, Ks, Rs, ts = nerf_geometry(4, 480, 640, 32, "cpu")
    pts = torch.from_numpy(rng.uniform(0, [480, 640], (3000, 2))).float()
    args = [pts, depths[:2], Ks[:2], Rs[:2], ts[:2], Rs[2:], ts[2:]]
    cpu = warp_points_nerf(*args)
    got = warp_points_nerf(*(a.cuda() for a in args))
    assert float((got.cpu() - cpu).abs().max()) <= 2e-3
    assert float((cpu - pts).abs().max()) > 5


@pytest.mark.cuda
def test_fuse_nerf_labels_on_card_against_cpu(card):
    """One fused frame of 16 at 480 x 640 on the card against the CPU:
    within 1e-6 (the same splats; sums in another order)."""
    from spnerf_tpu_torch.ops.nerf_label_fusion import fuse_nerf_labels
    from spnerf_tpu_torch.tools.kernel_times import nerf_geometry

    rng = np.random.default_rng(33)
    F, H, W, K = 16, 480, 640, 1024
    t = torch.from_numpy
    probs = t(rng.uniform(0, 0.05, (F, H, W)).astype(np.float32))
    pts = t(rng.integers(0, [H, W], (F, K, 2)).astype(np.int32))
    mask = t(rng.uniform(size=(F, K)) < 0.7)
    selected = t(rng.uniform(size=F) < 0.75)
    args = [probs, pts, mask, *nerf_geometry(F, H, W, 33, "cpu"), 5,
            selected]
    cpu = fuse_nerf_labels(*args)
    got = fuse_nerf_labels(*(a.cuda() if torch.is_tensor(a) else a
                             for a in args))
    assert float((got.cpu() - cpu).abs().max()) <= 1e-6
    n_views = 1 + int(selected.sum()) - int(selected[5])
    assert float((cpu - probs[5] / n_views).abs().max()) > 1e-3  # splats


# the NeRF scene pipeline (no kernel): the full-width field and the hash
# field on the card against the CPU, one seeded init, the same draws.
# Render tolerances (rgb, acc, depth) are tests/test_torch_nerf_model.py's
# RENDER_TOL at full width; a full-width step as
# tests/test_torch_nerf_scene.py's FULL_STEP_TOL holds one (float32); the
# hash render as tests/test_torch_hash_nerf.py holds it
NERF_FULL_TOL = {"float32": (1e-3, 2e-3, 5e-3), "bfloat16": (1e-2, 1e-2, 3e-2)}


def _nerf_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((n, 3)).astype(np.float32)), dim=-1)
    return o, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_render_rays_on_card_against_cpu(card, dtype):
    from spnerf_tpu_torch.models.nerf import (
        NeRF, NeRFConfig, draw_ray_uniforms, init_nerf, render_rays)

    cfg = NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
    cpu = init_nerf(34, cfg, device="cpu")
    gpu = NeRF(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    o, d = _nerf_rays(256, 34)
    draws = draw_ray_uniforms(256, cfg, torch.Generator().manual_seed(1),
                              "cpu")
    with torch.no_grad():
        want = render_rays(cpu, o, d, cfg, draws=draws)
        got = render_rays(gpu, o.cuda(), d.cuda(), cfg,
                          draws=tuple(u.cuda() for u in draws))
    for k, v in want.items():
        tol = NERF_FULL_TOL[dtype][("rgb", "acc", "depth").index(
            k.split("_")[0])]
        assert float((got[k].cpu() - v).abs().max()) <= tol, k


@pytest.mark.cuda
def test_nerf_train_step_on_card_against_cpu(card):
    """One full-width float32 step of 128 rays: losses within 1e-4
    relative; on the tensors whose gradient does not pass through
    sample_pdf, Adam's first moment within 0.1 of its norm and the
    parameters within 1e-6 where it is above 0.1 of its largest."""
    from spnerf_tpu_torch.models.nerf import (
        NeRF, NeRFConfig, draw_ray_uniforms, init_nerf)
    from spnerf_tpu_torch.tasks.nerf_task import (
        create_nerf_optimizer, nerf_train_step)

    cfg = NeRFConfig(near=0.5, far=4.5)
    models = {"cpu": init_nerf(35, cfg, device="cpu"), "cuda": NeRF(cfg)}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    models["cuda"].cuda()
    o, d = _nerf_rays(128, 35)
    target = torch.rand(128, 3, generator=torch.Generator().manual_seed(2))
    draws = draw_ray_uniforms(128, cfg, torch.Generator().manual_seed(3),
                              "cpu")
    opts, out = {}, {}
    for dev, model in models.items():
        opts[dev] = create_nerf_optimizer(model, 5e-4)
        out[dev] = nerf_train_step(model, opts[dev], o.to(dev), d.to(dev),
                                   target.to(dev), cfg,
                                   draws=tuple(u.to(dev) for u in draws))
    for k in out["cpu"]:
        np.testing.assert_allclose(float(out["cuda"][k]),
                                   float(out["cpu"][k]), rtol=1e-4)
    for (name, p), q in zip(models["cpu"].named_parameters(),
                            models["cuda"].parameters()):
        if not (name.startswith("fine.")
                or name.split(".")[1] in ("feature", "view1", "rgb")):
            continue
        mu = opts["cpu"].state[p]["exp_avg"]
        got = opts["cuda"].state[q]["exp_avg"].cpu()
        assert float((got - mu).norm()) <= 0.1 * float(mu.norm()), name
        clear = mu.abs() > 0.1 * mu.abs().max()
        assert float((q.detach().cpu() - p.detach())[clear].abs().max()) \
            <= 1e-6, name


@pytest.mark.cuda
def test_render_image_runs_on_the_card_by_default(card):
    from spnerf_tpu_torch.models.nerf import NeRFConfig, init_nerf, render_image
    from spnerf_tpu_torch.tasks.nerf_task import pose_orbit

    cfg = NeRFConfig(depth=2, width=32, skip_layer=1, n_coarse=8, n_fine=8,
                     near=0.5, far=3.0)
    model = init_nerf(36, cfg)
    assert next(model.parameters()).is_cuda
    K = np.array([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
    pose = pose_orbit(4, radius=1.0)[1]
    out = render_image(model, (12, 16), K, pose, cfg, chunk=50)
    assert out["depth"].is_cuda and out["rgb"].shape == (12, 16, 3)
    assert torch.isfinite(out["depth"]).all()


@pytest.mark.cuda
def test_hash_render_on_card_against_cpu(card):
    from spnerf_tpu_torch.models.hash_nerf import (
        HashNeRF, HashNeRFConfig, init_hash_nerf, render_rays_hash)

    cfg = HashNeRFConfig()
    cpu = init_hash_nerf(37, cfg, device="cpu")
    gpu = HashNeRF(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    o, d = _nerf_rays(512, 37)
    u = torch.rand((512, cfg.n_samples),
                   generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = render_rays_hash(cpu, o, d, cfg, u=u)
        got = render_rays_hash(gpu, o.cuda(), d.cuda(), cfg, u=u.cuda())
    for k, tol in (("rgb", 1e-6), ("acc", 1e-6), ("depth", 2e-5)):
        assert float((got[k].cpu() - want[k]).abs().max()) <= tol, k


# ------------------------------------------------------------------- CLI

_CLI_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
_CLI_SHAPE = (64, 80)


@pytest.fixture
def cli_roots(tmp_path, monkeypatch):
    """The port's data, checkpoint and export roots under ``tmp_path``;
    two small box rooms "A" and "B" with random labels of every frame
    under EXPER_PATH/outputs/lab/<scene>/<split>."""
    import importlib.util

    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.tasks.nerf_task import write_scene

    for name in ("DATA_PATH", "EXPER_PATH", "CKPT_PATH"):
        monkeypatch.setattr(settings, name, tmp_path / name.lower())
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _CLI_ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for seed, name in enumerate("AB"):
        scene = smoke.box_room(seed + 40, shape=_CLI_SHAPE)
        write_scene(name, scene["rgb"], scene["depth"], scene["poses"],
                    scene["splits"])
        rng = np.random.default_rng(seed)
        for split, frames in scene["splits"].items():
            out = tmp_path / "exper_path" / "outputs" / "lab" / name / split
            out.mkdir(parents=True)
            for j in range(len(frames)):
                np.save(out / f"{j}.npy", rng.integers(
                    0, _CLI_SHAPE, (40, 2)).astype(np.int64))
    return tmp_path


def _cli_nerf_args(steps, **cuts):
    """``cli.main`` arguments for NeRF-pair training on the scenes of
    ``cli_roots``: superpoint_NeRF_train.yaml, narrow, ``steps`` steps."""
    import json

    cuts = {"data.all_data_dirs": ["A", "B"],
            "data.all_label_dirs": ["outputs/lab/A", "outputs/lab/B"],
            "data.augmentation.photometric.params.additive_shade"
            ".kernel_size_range": [9, 15],
            "model.vgg_cn": [8, 8, 16, 16, 32, 32, 32, 32],
            "model.detector_head.detector_dim": [32, 32],
            "model.descriptor_head.descriptor_dim": [32, 32],
            "train.num_iters": steps, "save_or_validation_interval": steps,
            "train.val_batches": 1, "log_every": 1, "pretrained": None,
            **cuts}
    args = ["--config-path",
            str(_CLI_ROOT / "spnerf_tpu_torch/configs/superpoint_NeRF_train"
                ".yaml"), "--task", "train", "--train-nerf", "--nerf-loss"]
    for key, value in cuts.items():
        args += ["--set", f"{key}={json.dumps(value)}"]
    return args


@pytest.mark.cuda
def test_cli_trains_nerf_pairs_through_the_loss_kernels_on_card(card,
                                                                cli_roots):
    """3 steps and a validation batch through ``cli.main``: rows 10-11
    launch once per step (the forward once more for validation)."""
    from spnerf_tpu_torch import cli
    from spnerf_tpu_torch.kernels import _build

    _build.launch_counts.clear()
    state = cli.main(_cli_nerf_args(3, ckpt_name="cli")
                     + ["--validate-training"])
    counts = {k: v for k, v in _build.launch_counts.items()
              if k.startswith("desc_loss")}
    assert state.iteration == 3
    assert counts == {"desc_loss[fwd]": 4, "desc_loss[dA]": 3,
                      "desc_loss[dB]": 3}
    assert all(p.is_cuda and torch.isfinite(p).all()
               for p in state.model.parameters())


@pytest.mark.cuda
def test_profile_window_writes_a_trace_on_card(card, cli_roots):
    """A ``profile:`` window of one step writes one Chrome trace that
    holds the card's kernels, rows 10-11 among them."""
    import json

    from spnerf_tpu_torch import cli

    logdir = cli_roots / "trace"
    cli.main(_cli_nerf_args(3, ckpt_name="prof", profile={
        "enable": True, "start": 1, "num_steps": 1, "logdir": str(logdir)}))
    traces = list(logdir.glob("*.json"))
    assert len(traces) == 1
    kernels = [e["name"] for e in json.loads(traces[0].read_text())
               ["traceEvents"] if e.get("cat") == "kernel"]
    assert any("hinge" in k for k in kernels), sorted(set(kernels))[:20]


@pytest.mark.cuda
def test_on_the_fly_repeatability_on_card_against_cpu(card, tmp_path,
                                                      monkeypatch):
    """2 synthetic pairs through ``eval.on_the_fly`` (the demo
    MagicPoint, 64 x 80): NMS'd heatmaps within 1e-5 where both keep a
    point, and the pair's repeatability equal where the keypoint sets
    are."""
    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.data import pnm
    from spnerf_tpu_torch.eval import on_the_fly
    from spnerf_tpu_torch.eval.detector import repeatability_pair
    from spnerf_tpu_torch.utils.config import load_config

    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    monkeypatch.setattr(settings, "CKPT_PATH", _CLI_ROOT / "demo")
    seq = tmp_path / "HPatches" / "v_synthetic"
    seq.mkdir(parents=True)
    rng = np.random.default_rng(3)
    coarse = rng.uniform(0, 255, (8, 10))
    image = np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.uint8)
    image[20:44, 24:60] = 255
    for i, (dy, dx) in enumerate([(0, 0), (3, 5), (-2, 4)], start=1):
        pnm.write(seq / f"{i}.ppm", np.roll(image, (dy, dx), (0, 1)))
        if i > 1:
            np.savetxt(seq / f"H_1_{i}", [[1, 0, dx], [0, 1, dy], [0, 0, 1]])
    config = load_config(
        _CLI_ROOT / "spnerf_tpu_torch/configs/magicpoint_repeatability.yaml")
    config["data"].update(alteration="all",
                          preprocessing={"resize": list(_CLI_SHAPE)})
    config["pretrained"] = "pretrained/demo_mp_5000.ckpt"
    cpu = list(on_the_fly.pair_outputs(config, "cpu"))
    gpu = list(on_the_fly.pair_outputs(config, "cuda"))
    assert len(cpu) == len(gpu) == 2
    same_sets = 0
    for (H, *want), (_, *got) in zip(cpu, gpu):
        probs = [(g["prob_heatmap_nms"], w["prob_heatmap_nms"])
                 for g, w in zip(got, want)]
        for g, w in probs:
            both = (g > 0) & (w > 0)
            assert both.any()
            np.testing.assert_allclose(g[both], w[both], atol=1e-5, rtol=0)
        if all(np.array_equal(g > 0, w > 0) for g, w in probs):
            same_sets += 1
            assert repeatability_pair(probs[0][0], probs[1][0], H) \
                == repeatability_pair(probs[0][1], probs[1][1], H)
    assert same_sets >= 1
    results = [on_the_fly.run_repeatability(config, device=d)
               for d in ("cpu", "cuda")]
    assert results[0]["pairs"] == results[1]["pairs"] == 2
    if same_sets == 2:
        assert results[0] == results[1]


# ------------------------------------------------------- pose evaluation

@pytest.mark.cuda
def test_pose_inference_on_card_against_cpu(card, tmp_path, monkeypatch):
    """``eval.pose.build_infer_fn`` on a small box room's frames (the demo
    MagicPoint, seed-0 descriptor head, 96 x 128) on the card and on the
    CPU: heatmaps within 1e-5 where both keep a point, descriptors at the
    CPU's keypoints within 1e-5; then ``estimate_pose_errors`` on the
    card's outputs runs through every pair."""
    import importlib.util

    from spnerf_tpu_torch import settings
    from spnerf_tpu_torch.eval import pose
    from spnerf_tpu_torch.utils.config import apply_overrides, load_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _CLI_ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene = smoke.box_room(5, shape=(96, 128),
                           frames={"training": 4, "validation": 0})
    smoke.write_pose_pairs(scene, tmp_path / "Room")
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    monkeypatch.setattr(settings, "CKPT_PATH", _CLI_ROOT / "demo")
    config = apply_overrides(load_config(
        _CLI_ROOT / "spnerf_tpu_torch/configs/pose_estimation_indoor.yaml"),
        ["data.resize=[128, 96]", "data.images_path=Room",
         "data.gt_pairs=Room/pairs.txt", "model.detector_head.top_k=300",
         "pretrained=pretrained/demo_mp_5000.ckpt"])
    infer = {d: pose.build_infer_fn(config, d) for d in ("cpu", "cuda")}
    for f in range(4):
        image, _ = pose.load_gray(tmp_path / "Room" / f"{f}.png",
                                  config["data"]["resize"])
        want, got = infer["cpu"](image), infer["cuda"](image)
        both = (got["prob"] > 0) & (want["prob"] > 0)
        assert both.any()
        np.testing.assert_allclose(got["prob"][both], want["prob"][both],
                                   atol=1e-5, rtol=0)
        kpts = pose.top_keypoints_with_border(want["prob"], 300)
        np.testing.assert_allclose(got["desc"](kpts), want["desc"](kpts),
                                   atol=1e-5, rtol=0)
    pairs = pose.read_pairs(config)
    res = pose.estimate_pose_errors(config, infer["cuda"], pairs)
    assert res["num_pairs"] == len(pairs) == 6


# ----------------------------------------------------------- int8 PTQ

@pytest.mark.cuda
def test_quantized_superpoint_on_card_against_cpu(card):
    """``QuantizedSuperPoint`` (narrow, seeded) on the card and on the CPU
    with the card's scales: every int32 sum equal (``torch._int_mm`` on
    the card, the CPU's own product), the heads within 1 bf16 ulp."""
    from spnerf_tpu_torch.models.superpoint import (
        SuperPointConfig,
        init_superpoint,
    )
    from spnerf_tpu_torch.ops import quantization

    cfg = SuperPointConfig(vgg_cn=(8, 8, 16, 16, 32, 32, 32, 32),
                           detector_dim=(32, 64), descriptor_dim=(32, 64))
    model = init_superpoint(7, cfg, device="cuda")
    x = torch.rand((2, 48, 72, 1), generator=torch.Generator().manual_seed(1))
    q = quantization.QuantizedSuperPoint.build(cfg, model, x.cuda())
    cpu_q = quantization.QuantizedSuperPoint.build(
        cfg, init_superpoint(7, cfg, device="cpu"), None,
        act_scales={k: float(v) for k, v in q.act_scales.items()},
        device="cpu")
    sums = {}
    real = quantization.conv_int32
    outs = {}
    for dev, qm in (("cuda", q), ("cpu", cpu_q)):
        sums[dev] = []

        def record(*args, out=sums[dev]):
            acc = real(*args)
            out.append(acc.cpu())
            return acc

        quantization.conv_int32 = record
        try:
            outs[dev] = qm(x.to(dev))
        finally:
            quantization.conv_int32 = real
    assert len(sums["cuda"]) == len(sums["cpu"]) == 10
    for a, b in zip(sums["cuda"], sums["cpu"]):
        assert torch.equal(a, b)
    for key, head in (("logits", "detector/convPb"),
                      ("desc_raw", "descriptor/convDb")):
        got, want = outs["cuda"][key].cpu(), outs["cpu"][key]
        s = (want - cpu_q.params[head]["bias"]).abs().clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(s)) - 7)
        assert float(((got - want).abs() / ulp).max()) <= 1.0 + 1e-3, key


@pytest.mark.cuda
def test_conv_int32_on_card_at_block_shapes(card):
    """The im2col + ``torch._int_mm`` product at block 1's K = 9 (padded),
    a cout not of 8 and fewer than 17 rows, equal to the CPU's."""
    from spnerf_tpu_torch.ops.quantization import conv_int32

    rng = np.random.default_rng(3)
    for shape, kernel in (((2, 9, 13, 1), (3, 3, 1, 64)),
                          ((1, 5, 7, 64), (3, 3, 64, 65)),
                          ((1, 1, 3, 8), (3, 3, 8, 8))):
        x = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        k = torch.from_numpy(rng.integers(-127, 128, kernel).astype(np.int8))
        assert torch.equal(conv_int32(x.cuda(), k.cuda()).cpu(),
                           conv_int32(x, k))


PROBE_CONV_CASES = [(dt, order, C) for dt in ("int8", "bf16")
                    for order in ("acc9", "concat") for C in (64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,order,C", PROBE_CONV_CASES)
def test_probe_conv_on_card(card, dtype, order, C):
    """The conv probe (P1, P2) against its plain version at a ragged W
    (70: two M-tiles a row, the second of 6 pixels) and 2 x 3 rows:
    int8 equal (the wrap modulo 256 included), bf16 within 1 ulp at the
    2^-8 floor (``tools/smoke_probes.py``); a second launch equal."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.probe_conv import (
        launch_key,
        probe_conv,
        probe_conv_plain,
    )
    from spnerf_tpu_torch.probes.micro_conv2 import conv_operands
    from spnerf_tpu_torch.tools.smoke_probes import bf16_ulps

    x, w = conv_operands(C, dtype, Hb=3, W=70, n=2, device="cuda", seed=C)
    if order == "concat":
        w = w.reshape(9 * C, C)
    before = _build.launch_counts[launch_key(x, order)]
    got = probe_conv(x, w, order)
    assert _build.launch_counts[launch_key(x, order)] == before + 1
    assert torch.equal(probe_conv(x, w, order).view(torch.uint8),
                       got.view(torch.uint8))
    want = probe_conv_plain(x, w, order)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        assert bf16_ulps(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,order,C", [("int8", "acc9", 128), ("bf16", "acc9", 256),
                                           ("int8", "concat", 256), ("bf16", "concat", 64),
                                           ("bf16", "concat", 256)])
def test_probe_conv_grids_on_card(card, dtype, order, C):
    """The persistent schedule at the grids the launch picks for small and
    narrow work against the plain version, a second launch bit-equal: 3
    rows of W 70 (6 M-tiles: fewer items than SMs, an idle cluster rank),
    40 rows of W 200 (160 M-tiles), 2 rows of W 16 (a row narrower than
    the input tile: the tensor map's box past the row) and 300 rows of W
    320 (1,500 M-tiles: more items than clusters, each block walking
    several)."""
    from spnerf_tpu_torch.kernels.probe_conv import launch_grid, probe_conv, probe_conv_plain
    from spnerf_tpu_torch.probes.micro_conv2 import conv_operands
    from spnerf_tpu_torch.tools.smoke_probes import bf16_ulps

    for Hb, W in ((3, 70), (40, 200), (2, 16), (300, 320)):
        x, w = conv_operands(C, dtype, Hb=Hb, W=W, n=1, device="cuda", seed=C + 1)
        assert launch_grid(x, order) >= 1
        got = probe_conv(x, w, order)
        assert torch.equal(probe_conv(x, w, order).view(torch.uint8), got.view(torch.uint8))
        want = probe_conv_plain(x, w, order)
        if dtype == "int8":
            assert torch.equal(got, want), (Hb, W)
        else:
            assert bf16_ulps(got, want) <= 1.0, (Hb, W)


@pytest.mark.cuda
def test_probe_conv_config_on_card(card):
    """The buffers, cluster and ring each of the 12 instances was compiled
    with equal ``probe_conv.kernel_config``'s mirror, which the CPU model
    of the kernel and the schedule's tests read."""
    from spnerf_tpu_torch.kernels.probe_conv import compiled_config, kernel_config

    for dtype in (torch.int8, torch.bfloat16):
        for order in ("acc9", "concat"):
            for C in (64, 128, 256):
                want = kernel_config(2 if dtype == torch.bfloat16 else 1, C, order == "concat")
                assert compiled_config(dtype, C, order) == want, (dtype, order, C)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_probe_chain_on_card(card, dtype):
    """The chain probe (P3): all ones at depth 32 and R 200 (a partial last
    block) equal to the plain version bit for bit (bf16: inf from layer
    19); seeded inputs at R 64 (one block), 200 and 8,256 (129 blocks, one
    past the probe's 128), depths 1, 2, 3 (both register-set parities, the last layer
    after a first or a second) and 32: int8 equal throughout, bf16 within
    1 ulp at depth 1 and depth x 2^-9 in norm deeper; a second launch
    equal."""
    from spnerf_tpu_torch.kernels.probe_chain import probe_chain, probe_chain_plain
    from spnerf_tpu_torch.tools.smoke_probes import (
        CHAIN_CHECKS,
        CHAIN_ULP,
        bf16_ulps,
        chain_operands,
        chain_rel_error,
    )

    dt = {"bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    ones = torch.ones((200, 128), dtype=dt, device="cuda")
    w1 = torch.ones((128, 128), dtype=dt, device="cuda")
    got = probe_chain(ones, w1, 32)
    assert torch.equal(got.view(torch.uint8),
                       probe_chain_plain(ones, w1, 32).view(torch.uint8))
    assert torch.equal(probe_chain(ones, w1, 32).view(torch.uint8),
                       got.view(torch.uint8))
    rows, depths = CHAIN_CHECKS
    for R in rows:
        x, w = chain_operands(dtype, R=R, seed=11 + R)
        for depth in depths:
            got, want = probe_chain(x, w, depth), probe_chain_plain(x, w, depth)
            assert torch.equal(probe_chain(x, w, depth).view(torch.uint8),
                               got.view(torch.uint8)), (R, depth)
            if dtype == "int8":
                assert torch.equal(got, want), (R, depth)
            elif depth == 1:
                assert bf16_ulps(got, want) <= 1.0, R
            else:
                assert chain_rel_error(got, want) <= depth * CHAIN_ULP, (R, depth)


@pytest.mark.cuda
def test_probe_gathers_on_card(card):
    """The three gathers (P4) at odd sizes, indices outside the axis
    among them (NaN), equal to the plain versions bit for bit; the column
    form also at F 100 (a ragged last slab) and 7 (one partial slab), N
    != T, ragged last chunks of rows; a second launch equal."""
    from spnerf_tpu_torch.kernels import probe_gather as g
    from spnerf_tpu_torch.tools.smoke_probes import GATHER_CHECKS, column_operands

    gen = torch.Generator(device="cuda").manual_seed(3)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    table = torch.randn((37, 12), generator=gen, device="cuda")
    cases = [(g.gather_rows, g.gather_rows_plain, table, ints(-2, 40, (53,))),
             (g.gather_columns, g.gather_columns_plain, table, ints(-2, 40, (29, 12))),
             (g.gather_in_rows, g.gather_in_rows_plain, table, ints(-2, 14, (37, 7)))]
    for T, F, N in GATHER_CHECKS:
        cases.append((g.gather_columns, g.gather_columns_plain,
                      *column_operands(T, F, N, seed=T + F + N)))
    for kernel, plain, src, idx in cases:
        got = kernel(src, idx)
        assert torch.equal(got.view(torch.int32), plain(src, idx).view(torch.int32))
        assert torch.equal(kernel(src, idx).view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
def test_probe_wrappers_refuse_on_card(card):
    """A CUDA tensor the kernels do not take raises; it never falls back."""
    from spnerf_tpu_torch.kernels.probe_conv import probe_conv
    from spnerf_tpu_torch.kernels.probe_gather import gather_rows

    x = torch.zeros((1, 1, 10, 256), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):  # no float32 instance
        probe_conv(x.float(), torch.zeros((9, 256, 256), device="cuda"), "concat")
    with pytest.raises(ValueError):
        probe_conv(x[..., :96], torch.zeros((9, 96, 96), dtype=torch.bfloat16,
                                            device="cuda"))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 6), device="cuda"),
                    torch.zeros(3, dtype=torch.int32, device="cuda"))
