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


# (B, Hc, Wc, C, K, map dtype, normalize): C 256 on the path; C 20 and 300
# take the element-by-element loads (C % 8 != 0), C 300 and 512 two chunks
DESC_SAMPLE_CASES = {
    "bf16_256": (2, 15, 20, 256, 1000, torch.bfloat16, True),
    "bf16_256_raw": (2, 15, 20, 256, 77, torch.bfloat16, False),
    "f32_64": (3, 7, 9, 64, 33, torch.float32, True),
    "bf16_20": (1, 6, 5, 20, 50, torch.bfloat16, True),
    "f32_300": (2, 4, 6, 300, 40, torch.float32, True),
    "bf16_512_raw": (1, 5, 7, 512, 20, torch.bfloat16, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(DESC_SAMPLE_CASES))
def test_desc_sample_matches_plain_on_card(card, kind):
    """Unnormalized rows equal to the plain version (same weights, same
    bf16 roundings, the same float32 sum order); unit vectors within 1e-6
    (the sum of squares runs in another order). Points cover every
    border and lie beyond it; two runs bit-equal; one launch per call."""
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels.desc_sample import (
        sample_descriptors_fused,
        sample_descriptors_fused_plain,
    )

    B, Hc, Wc, C, K, dtype, normalize = DESC_SAMPLE_CASES[kind]
    rng = np.random.default_rng(31)
    desc = torch.from_numpy(rng.standard_normal((B, Hc, Wc, C)).astype(
        np.float32)).to(dtype).cuda()
    pts = np.stack([rng.uniform(-5, Hc * 8 + 4, (B, K)),
                    rng.uniform(-5, Wc * 8 + 4, (B, K))], -1)
    pts[:, :4] = [[0, 0], [Hc * 8 - 1, Wc * 8 - 1], [0, Wc * 8 - 1],
                  [Hc * 8 - 1, 0]]
    pts = torch.from_numpy(pts.astype(np.float32)).cuda()
    before = _build.launch_counts["desc_sample[" + (
        "bf16]" if dtype == torch.bfloat16 else "f32]")]
    got = sample_descriptors_fused(desc, pts, 8, normalize)
    again = sample_descriptors_fused(desc, pts, 8, normalize)
    torch.cuda.synchronize()
    after = _build.launch_counts["desc_sample[" + (
        "bf16]" if dtype == torch.bfloat16 else "f32]")]
    assert after == before + 2
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
