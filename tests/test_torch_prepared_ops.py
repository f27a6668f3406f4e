"""Operands prepared once for ``head``, ``dot_bias_act`` and
``conv1_packed``, on the CPU.

* The tensor-core layouts of the new packers, read back by the address
  formulas of ``csrc/head.cu`` (``pack_head_1x1``: the 1x1's ring slabs)
  and ``csrc/dot_bias_act.cu`` (``pack_rows`` at N 72, ``pack_slabs`` of
  int8 or bf16 at N 256), and the head's 1x1 run
  over its packed slabs in plain PyTorch with the kernel's two-level
  sums, against ``requant.dot_acc`` (float64 sums rounded once: within
  one float32 rounding of each 64-channel partial).
* The head's mid handed from the 3x3's accumulator to the 1x1's A
  fragments (the index map of ``HeadTail`` in ``csrc/head.cu``).
* Prepared operands run the plain versions and give the raw calls' bits.
* ``ServingSuperPoint`` prepares its heads' and conv1's operands once,
  when it is built, and with them equals the JAX package on the small
  cases of ``_serving_cases`` in int8, bf16 (per-layer route) and mixed.
"""

import numpy as np
import pytest
import torch

import _serving_cases as C
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels import conv_stack as S
from spnerf_tpu_torch.kernels import tail_fused as T
from spnerf_tpu_torch.kernels.requant import dot_acc


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(torch.bfloat16)


def _slab_1x1(packed, coutp):
    """(256, coutp) 1x1 weights read from ``pack_head_1x1``'s slabs by
    the kernel's formula: slab k // K, element (k % K, n) at ((n // 8) *
    (K // 8) + (k % K) // 8) * 64 + (n % 8) * 8 + k % 8, K = 256 / kc."""
    kc = 1 if coutp == 72 else 2
    K = 256 // kc
    k = torch.arange(256)[:, None]
    n = torch.arange(coutp)[None, :]
    off = (k // K) * (K * coutp) + ((n // 8) * (K // 8) + (k % K) // 8) * 64 \
        + (n % 8) * 8 + k % 8
    return packed.reshape(-1)[off]


@pytest.mark.parametrize("cout,coutp", [(65, 72), (256, 256)])
def test_pack_head_1x1_reads_back(cout, coutp):
    w = _bf16(np.random.default_rng(cout), (256, cout))
    packed = _build.pack_head_1x1(w, coutp)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 256 * coutp
    got = _slab_1x1(packed, coutp)
    assert torch.equal(got[:, :cout], w)
    assert not got[:, cout:].float().any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_pack_rows_layout(dtype):
    """The N 72 instances' B: one row of 256 K-contiguous values per
    output channel, rows past the 65 real ones zero."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(-127, 128, (256, 65)).astype(
        np.int8)).to(dtype)
    packed = _build.pack_rows(w, 72)
    assert packed.shape == (72, 256) and packed.is_contiguous()
    assert torch.equal(packed[:65], w.t())
    assert not packed[65:].float().any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_pack_slabs_of_the_n256_product_reads_back(dtype):
    """The N 256 instances' B for wgmma: K-major core matrices of 8 rows
    x 16 bytes (e = 16 int8 or 8 bf16 values of K), element (k, n) at
    ((n // 8) * (256 // e) + k // e) * 8 e + (n % 8) * e + k % e."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.integers(-127, 128, (256, 256)).astype(
        np.int8)).to(dtype)
    packed = _build.pack_slabs(w)
    assert packed.is_contiguous() and packed.numel() == 256 * 256
    e = 16 // w.element_size()
    k = torch.arange(256)[:, None]
    n = torch.arange(256)[None, :]
    off = ((n // 8) * (256 // e) + k // e) * 8 * e + (n % 8) * e + k % e
    assert torch.equal(packed.reshape(-1)[off], w)


def test_mid_accumulator_is_the_1x1_a_fragment():
    """For every lane, HeadTail's map from the 3x3's m64n256 accumulator
    (d[4 j + 2 hh + e]: row g + 8 hh, column 8 j + 2 t + e) to the 1x1's
    m64k16 A fragments (a[ks][h] element e: row g + 8 (h % 2), channel
    16 ks + 8 (h // 2) + 2 t + e) keeps every (row, channel) in place."""
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc_pos = {4 * j + 2 * hh + e: (g + 8 * hh, 8 * j + 2 * t + e)
                   for j in range(32) for hh in range(2) for e in range(2)}
        for ks in range(16):
            for h in range(4):
                for e in range(2):
                    # head.cu: c = 16 ks + 8 (h / 2) + 2 t4, d[8 ks + 2 h + e]
                    c = 16 * ks + 8 * (h // 2) + 2 * t
                    assert acc_pos[8 * ks + 2 * h + e] == (g + 8 * (h % 2),
                                                           c + e)


@pytest.mark.parametrize("cout,coutp", [(65, 72), (256, 256)])
def test_head_1x1_over_packed_slabs(cout, coutp):
    """The 1x1 as the kernel runs it: bf16 mid times the packed slabs,
    64-channel partials in float32 added in order, against float64 sums
    rounded once."""
    rng = np.random.default_rng(3 + cout)
    mid = torch.from_numpy(rng.uniform(0, 2, (64, 256)).astype(
        np.float32)).to(torch.bfloat16)
    w = _bf16(rng, (256, cout), 1 / 16)
    wk = _slab_1x1(_build.pack_head_1x1(w, coutp), coutp).float()
    acc = torch.zeros(64, coutp)
    for k0 in range(0, 256, 64):
        acc = acc + mid[:, k0:k0 + 64].float() @ wk[k0:k0 + 64]
    want = dot_acc(mid, w)
    torch.testing.assert_close(acc[:, :cout], want, rtol=4 * 2.0 ** -24,
                               atol=1e-6)
    assert not acc[:, cout:].any()


def _head_raw(rng, dtype, cout):
    if dtype == torch.int8:
        def w(shape):
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(
                np.int8))
        return (w((3, 3, 128, 256)), torch.full((256,), 2e-4),
                torch.zeros(256), w((256, cout)), torch.full((cout,), 5e-5),
                torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32)))
    return (_bf16(rng, (3, 3, 128, 256), 1 / 34), torch.ones(256),
            torch.from_numpy((rng.standard_normal(256) * 0.1).astype(
                np.float32)),
            _bf16(rng, (256, cout), 1 / 16), torch.ones(cout),
            torch.from_numpy(rng.uniform(-10, 10, cout).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("cout,softmax", [(65, True), (256, False)])
def test_prepared_head_equals_raw(dtype, cout, softmax):
    rng = np.random.default_rng(11)
    raw = _head_raw(rng, dtype, cout)
    x = (torch.from_numpy(rng.integers(0, 128, (2, 7, 13, 128)).astype(
        np.int8)) if dtype == torch.int8 else
         torch.from_numpy(rng.uniform(0, 1, (2, 7, 13, 128)).astype(
             np.float32)).to(torch.bfloat16))
    ops = T.prepare_head(*raw)
    assert ops.coutp == ((72 if cout == 65 else 256) if dtype == torch.bfloat16
                         else (80 if cout == 65 else 256))
    assert ops.m1p.shape == (ops.coutp,) and ops.m1p.dtype == torch.float32
    kw = {"softmax_lanes": cout} if softmax else {}
    got = T.head(x, ops, **kw)
    assert torch.equal(got, T.head(x, *raw, **kw))
    assert torch.equal(got, T.head_plain(x, ops, **kw))


@pytest.mark.parametrize("dtype,cin,cout", [
    (torch.int8, 256, 65), (torch.int8, 256, 256), (torch.bfloat16, 256, 65),
    (torch.bfloat16, 256, 256), (torch.float32, 9, 64),
    (torch.bfloat16, 32, 16)])  # the last: no kernel instance, raw only
def test_prepared_dot_equals_raw(dtype, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.integers(-5, 6, (3, 5, cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-5, 6, (cin, cout)).astype(
        np.float32)).to(dtype)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32))
    ops = S.prepare_dot(w, m, b)
    if cin == 32:
        assert ops.packed is None and ops.coutp == 0
    else:
        assert ops.coutp in (64, 72, 256) and ops.mult_p.shape == (ops.coutp,)
    relu = dtype == torch.float32
    got = S.dot_bias_act(x, ops, relu=relu)
    assert torch.equal(got, S.dot_bias_act(x, w, m, b, relu=relu))
    assert torch.equal(got, S.dot_bias_act_plain(x, ops, relu=relu))


@pytest.mark.parametrize("out", [torch.bfloat16, torch.int8])
def test_prepared_conv1_equals_raw(out):
    rng = np.random.default_rng(4)
    image = torch.from_numpy(rng.uniform(0, 1, (2, 9, 11, 1)).astype(
        np.float32))
    w1 = torch.from_numpy((rng.standard_normal((3, 3, 1, 64)) / 3).astype(
        np.float32))
    m, b = torch.full((64,), 30.0), torch.from_numpy(
        rng.uniform(-3, 3, 64).astype(np.float32))
    ops = S.prepare_conv1(w1, m, b)
    assert ops.packed.shape == (9, 64) and ops.coutp == 64
    got = S.conv1_packed(image, ops, out_dtype=out)
    assert got.shape == (2, 9, 11, 64) and got.dtype == out
    assert torch.equal(got, S.conv1_packed(image, w1, m, b, out_dtype=out))
    assert torch.equal(got, S.conv1_packed_plain(image, ops, out_dtype=out))


# (mode, fused_mid, fused_tail, W): the fused int8 head, the bf16 per-layer
# route (prepared 1x1s and conv1), the bf16 heads behind int8
PREPARED_CASES = {
    "int8": ("int8", True, True, 64),
    "bf16_unfused": ("bf16", False, False, 64),
    "mixed": ("mixed", True, True, 64),
}


@pytest.fixture(scope="module")
def variables():
    return C.jax_variables()


@pytest.mark.parametrize("case", list(PREPARED_CASES))
def test_serving_prepares_once_and_matches_jax(variables, case, monkeypatch):
    """The graph packs its heads' (and in bf16 mode conv1's) operands
    when it is built and never on a call; two calls give the same bits,
    and the JAX package's outputs, keypoints and descriptors within the
    bounds of ``_serving_cases``."""
    from spnerf_tpu_torch.ops import serving
    from spnerf_tpu_torch.ops import fast_inference as tfi
    from spnerf_tpu_torch.tools.import_jax_weights import serving_from_folded

    mode, fused_mid, fused_tail, W = PREPARED_CASES[case]
    ref = C.jax_case(variables, mode, fused_mid, fused_tail, W)
    prepared = []
    for name in ("prepare_head", "prepare_dot", "prepare_conv1"):
        fn = getattr(serving, name)
        monkeypatch.setattr(serving, name, lambda *a, _n=name, _f=fn: (
            prepared.append(_n), _f(*a))[1])
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             mode=mode, fused_mid=fused_mid,
                             fused_tail=fused_tail)
    assert sorted(prepared) == sorted(
        ["prepare_head" if fused_tail else "prepare_dot"] * 2
        + (["prepare_conv1"] if mode == "bf16" else []))
    x = torch.from_numpy(ref["x"])
    out = sp(x, softmax=fused_tail)
    again = sp(x, softmax=fused_tail)
    assert len(prepared) == 2 + (mode == "bf16")
    for key in out:
        assert torch.equal(out[key], again[key])
    n_all = ref["n_all"]
    if fused_tail:
        dets = tfi.detect_from_probs_padded(
            out["probs"], 8, min_prob=C.THRESH, size=4, num_candidates=n_all,
            top_k=n_all, compact=False)
    else:
        dets = tfi.detect_from_logits(out["logits"], 8, min_prob=C.THRESH,
                                      size=4, num_candidates=n_all,
                                      top_k=n_all)
    C.check_outputs(ref, out)
    C.check_keypoints(ref, dets)
    C.check_descriptors(ref, out)
