"""The port's per-layer kernels and bf16 fused kernels (plain versions on
CPU) against the JAX Pallas kernels (interpret mode on CPU).

Tolerances: int8 operands are exact (integer sums, the same float32
affine and rounding) where the output is int8; a bf16 output of int8
sums within 1 ulp, since XLA on the CPU contracts the affine into an
FMA. bf16 and float32 operands: bf16 outputs within 1
ulp for one conv or product (float32 sums in another order). Ulps are
counted by ``bf16_scaled_ulps``: at the larger of the two values, and at
least at 1/256 of the tensor's largest magnitude, below which a bf16 ulp
is finer than the sums' own float32 rounding. The fused double conv and
head round their mid activation to bf16: where the two sides round a mid
value apart, every output it feeds moves by the weight times that
value's ulp, an error on the scale of the tensor's largest values
(measured here: 6.5 ulps of an output near zero at the 1/256 floor, in
0.015% of the values; on the card at batch 64, kernel against plain, 4
ulps at a 1/16 floor in 1.3e-5 of the values). They are held to at
least 99.9% of the values within 1 ulp and all within 2, ulps counted at
least at 1/4 of the largest magnitude. float32 outputs
within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_scaled_ulps, bf16_ulp_diff, jax_bf16_to_torch
from spnerf_tpu.kernels import conv_stack_pallas as J
from spnerf_tpu.kernels.mid_fused_pallas import double_packed_conv3x3_pallas
from spnerf_tpu.kernels.tail_fused_pallas import (
    double_conv3x3_pallas,
    head_pallas,
)
from spnerf_tpu_torch.kernels import conv_stack as T
from spnerf_tpu_torch.kernels.mid_fused import double_conv3x3
from spnerf_tpu_torch.kernels.tail_fused import head


def _int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _mb(rng, C, lo, hi):
    """Per-channel int8 multiplier and bias, float32."""
    return (rng.uniform(lo, hi, C).astype(np.float32),
            rng.uniform(-20, 20, C).astype(np.float32))


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, jax_bf16_to_torch(j)


def _bf16_operands(rng, x_shape, w_shape):
    """bf16 activations in [0, 1), bf16 weights at the 1/sqrt(fan-in)
    scale, unit multiplier and a float32 bias: ((jax x, w), (torch x, w),
    mult, bias)."""
    fan_in = int(np.prod(w_shape[:-1]))
    (jx, tx) = _bf16(rng.uniform(0, 1, x_shape).astype(np.float32))
    (jw, tw) = _bf16((rng.standard_normal(w_shape) / np.sqrt(fan_in))
                     .astype(np.float32))
    cout = w_shape[-1]
    return ((jx, jw), (tx, tw), np.ones(cout, np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_bf16(got, want, chain=False):
    """One conv or product: every value within 1 ulp (floor 1/256). A
    chain through a bf16 mid: 99.9% within 1 ulp, all within 2 (floor
    1/4)."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    if not chain:
        d = bf16_scaled_ulps(got, want)
        assert float(d.max()) <= 1, float(d.max())
        return
    d = bf16_scaled_ulps(got, want, floor=2.0 ** -2)
    assert float(d.max()) <= 2, float(d.max())
    assert float((d > 1).float().mean()) <= 1e-3


# ------------------------------------------------------------- conv3x3


@pytest.mark.parametrize("cout,pool", [(128, False), (128, True),
                                       (256, False), (256, True)])
def test_conv3x3_int8_matches_jax(cout, pool):
    rng = np.random.default_rng(40 + cout + pool)
    x = _int8(rng, (2, 8, 24, 128), 0, 128)
    w = _int8(rng, (3, 3, 128, cout))
    m, b = _mb(rng, cout, 5e-5, 4e-4)
    want = np.asarray(J.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), m, b,
                                       out_dtype=jnp.int8, pool=pool))
    got = T.conv3x3(_t(x), _t(w), _t(m), _t(b), out_dtype=torch.int8,
                    pool=pool)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < np.mean(want != 0) < 0.95


@pytest.mark.parametrize("cout,pool", [(128, True), (256, False)])
def test_conv3x3_bf16_matches_jax(cout, pool):
    rng = np.random.default_rng(50 + cout)
    (jx, jw), (tx, tw), m, b = _bf16_operands(rng, (2, 8, 24, 128),
                                              (3, 3, 128, cout))
    want = J.conv3x3_pallas(jx, jw, m, b, out_dtype=jnp.bfloat16, pool=pool)
    got = T.conv3x3(tx, tw, _t(m), _t(b), out_dtype=torch.bfloat16, pool=pool)
    _check_bf16(got, jax_bf16_to_torch(want))


# -------------------------------------------------------- packed conv3x3


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("cout,pool", [(64, True), (128, False)])
def test_packed_conv3x3_matches_jax(dtype, cout, pool):
    """Against ``unpack_pairs(packed_conv3x3_pallas(pack_pairs(x)))``."""
    rng = np.random.default_rng(60 + cout)
    shape, w_shape = (2, 8, 32, 64), (3, 3, 64, cout)
    if dtype == "int8":
        x, w = _int8(rng, shape, 0, 128), _int8(rng, w_shape)
        m, b = _mb(rng, cout, 5e-5, 4e-4)
        jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), _t(x), _t(w)
        out = jnp.int8
    else:
        (jx, jw), (tx, tw), m, b = _bf16_operands(rng, shape, w_shape)
        out = jnp.bfloat16
    want = J.unpack_pairs(J.packed_conv3x3_pallas(
        J.pack_pairs(jx), jw, m, b, out_dtype=out, pool=pool))
    got = T.packed_conv3x3(tx, tw, _t(m), _t(b), out_dtype=tx.dtype,
                           pool=pool)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _check_bf16(got, jax_bf16_to_torch(want))


# --------------------------------------------------------- dot_bias_act


@pytest.mark.parametrize("cout", [65, 256])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_dot_bias_act_matches_jax(dtype, cout):
    """The head 1x1 dot (bf16 out, no ReLU). The reference pads 65 output
    lanes to 128; the port computes the 65 real ones."""
    rng = np.random.default_rng(70 + cout)
    rows, cin = (2, 6, 10), 256
    coutp = 128 if cout == 65 else cout
    if dtype == "int8":
        x, w = _int8(rng, (*rows, cin), -127, 128), _int8(rng, (cin, cout))
        m = rng.uniform(2e-5, 1e-4, cout).astype(np.float32)
        b = rng.uniform(-1, 1, cout).astype(np.float32)
        jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), _t(x), _t(w)
    else:
        (jx, jw), (tx, tw), m, b = _bf16_operands(rng, (*rows, cin),
                                                  (cin, cout))
        if dtype == "f32":
            jx, jw = jx.astype(jnp.float32), jw.astype(jnp.float32)
            tx, tw = tx.float(), tw.float()
    pad = ((0, 0), (0, coutp - cout))
    want = J.dot_bias_act_pallas(jx, jnp.pad(jw, pad), np.pad(m, pad[1]),
                                 np.pad(b, pad[1]), relu=False,
                                 out_dtype=jnp.bfloat16)[..., :cout]
    got = T.dot_bias_act(tx, tw, _t(m), _t(b), relu=False,
                         out_dtype=torch.bfloat16)
    want = jax_bf16_to_torch(want)
    if dtype == "int8":
        # exact int32 sums; XLA on the CPU contracts acc * mult + bias into
        # an FMA, the port rounds twice as the card does: 1 ulp at most
        assert bf16_ulp_diff(got, want) <= 1
    else:
        _check_bf16(got, want)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_conv1_packed_matches_jax(out):
    """Against ``unpack_pairs(conv_stack_pallas.conv1_packed(...))``: the
    reference's 18-lane W-pair patches and the port's 9 taps hold the
    same nine products per output."""
    rng = np.random.default_rng(80)
    image = rng.uniform(0, 1, (2, 16, 24, 1)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 1, 64)) / 3).astype(np.float32)
    m = np.ones(64, np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dt = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    want = J.unpack_pairs(J.conv1_packed(jnp.asarray(image), jnp.asarray(w1),
                                         m, b, out_dtype=dt[0]))
    got = T.conv1_packed(_t(image), _t(w1), _t(m), _t(b), out_dtype=dt[1])
    assert got.shape == (2, 16, 24, 64) and got.dtype == dt[1]
    if out == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    else:
        _check_bf16(got, jax_bf16_to_torch(want))


def test_wrappers_reject_mismatched_weights():
    x = torch.zeros(1, 4, 4, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="weights"):
        T.conv3x3(x, torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16),
                  torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="pool"):
        T.packed_conv3x3(torch.zeros(1, 3, 4, 64, dtype=torch.int8),
                         torch.zeros(3, 3, 64, 64, dtype=torch.int8),
                         torch.ones(64), torch.zeros(64), pool=True)
    with pytest.raises(ValueError, match="weights"):
        T.dot_bias_act(x, torch.zeros(32, 8, dtype=torch.int8),
                       torch.ones(8), torch.zeros(8))


# ------------------------------------------- bf16 fused double conv, head


@pytest.mark.parametrize("case", ["blocks34", "blocks56", "blocks78"])
def test_double_conv3x3_bf16_matches_jax(case):
    """Blocks 3-4 and 5-6 against ``double_packed_conv3x3_pallas`` (pool
    on), blocks 7-8 against ``double_conv3x3_pallas`` (pool off)."""
    cin, cm, pool = {"blocks34": (64, 64, True), "blocks56": (64, 128, True),
                     "blocks78": (128, 128, False)}[case]
    rng = np.random.default_rng(90 + cm + pool)
    shape = (1, 16, 32, cin) if pool else (1, 8, 16, cin)
    (jx, jwa), (tx, twa), ma, ba = _bf16_operands(rng, shape, (3, 3, cin, cm))
    (_, jwb), (_, twb), mb, bb = _bf16_operands(rng, shape, (3, 3, cm, cm))
    if pool:
        want = J.unpack_pairs(double_packed_conv3x3_pallas(
            J.pack_pairs(jx), jwa, ma, ba, jwb, mb, bb, pool=True,
            out_dtype=jnp.bfloat16))
    else:
        want = double_conv3x3_pallas(jx, jwa, ma, ba, jwb, mb, bb,
                                     out_dtype=jnp.bfloat16)
    got = double_conv3x3(tx, twa, _t(ma), _t(ba), twb, _t(mb), _t(bb),
                         pool=pool)
    _check_bf16(got, jax_bf16_to_torch(want), chain=True)


@pytest.mark.parametrize("cout,softmax", [(65, True), (65, False),
                                          (256, False)])
def test_head_bf16_matches_jax(cout, softmax):
    """``head_pallas`` with bf16 operands (mult 1): the JAX head pads the
    detector's 65 lanes to 128 and zeroes lanes past the 64 cells."""
    rng = np.random.default_rng(100 + cout + softmax)
    (jx, jw3), (tx, tw3), m3, b3 = _bf16_operands(rng, (2, 8, 16, 128),
                                                  (3, 3, 128, 256))
    (_, jw1), (_, tw1), m1, b1 = _bf16_operands(rng, (1,), (256, cout))
    b1 = b1 * 10  # spread the logits as a trained detector's are spread
    coutp = 128 if cout == 65 else cout
    pad = ((0, 0), (0, coutp - cout))
    want = head_pallas(jx, jw3, m3, b3, jnp.pad(jw1, pad), np.pad(m1, pad[1]),
                       np.pad(b1, pad[1]),
                       softmax_lanes=cout if softmax else None,
                       out_dtype=jnp.bfloat16)
    n = cout - 1 if softmax else cout
    want = jax_bf16_to_torch(want)[..., :n]
    got = head(tx, tw3, _t(m3), _t(b3), tw1, _t(m1), _t(b1),
               softmax_lanes=cout if softmax else None)
    _check_bf16(got, want, chain=True)
