"""The port's kernels (plain versions on CPU) against the JAX Pallas
kernels (interpret mode on CPU) on identical int8 inputs and float32
multipliers.

Tolerances: int8 outputs exactly equal (both sides accumulate exactly
in integers and round the float32 affine the same way); bf16 outputs
within 1 bf16 ulp (the softmax's exp and sum order differ between XLA
and PyTorch, and one float32 ulp can flip the bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp_diff, jax_bf16_to_torch
from spnerf_tpu.kernels.conv12_fused_pallas import conv12_fused as jax_conv12
from spnerf_tpu.kernels.mid_fused_pallas import double_packed_conv3x3_pallas
from spnerf_tpu.kernels.tail_fused_pallas import (
    double_conv3x3_pallas,
    head_pallas,
)
from spnerf_tpu_torch.kernels.conv12_fused import (
    conv12_fused,
    quantize_conv1_weights,
)
from spnerf_tpu_torch.kernels.mid_fused import double_packed_conv3x3
from spnerf_tpu_torch.kernels.requant import cast_int8
from spnerf_tpu_torch.kernels.tail_fused import double_conv3x3, head


def _int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _mb(rng, C, lo, hi):
    """Per-channel multiplier and bias, float32."""
    return (rng.uniform(lo, hi, C).astype(np.float32),
            rng.uniform(-20, 20, C).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("pool", [True, False])
def test_conv12_fused_matches_jax(pool):
    rng = np.random.default_rng(10)
    B, H, W = 2, 32, 32
    image = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, 1, 64)) * 0.3).astype(np.float32)
    s1 = np.float32(0.02)
    mult1 = np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1))
    bias1 = (rng.standard_normal(64) * 0.1 / s1).astype(np.float32)
    w2 = _int8(rng, (3, 3, 64, 64))
    m2, b2 = _mb(rng, 64, 1e-4, 6e-4)
    ref = jax_conv12(jnp.asarray(image), jnp.asarray(k1), jnp.asarray(mult1),
                     jnp.asarray(bias1), jnp.asarray(w2), jnp.asarray(m2),
                     jnp.asarray(b2), pool=pool)
    ref = np.asarray(ref).reshape(B, H // (1 + pool), W // (1 + pool), 64)
    out = conv12_fused(_t(image), _t(k1), _t(mult1), _t(bias1), _t(w2),
                       _t(m2), _t(b2), pool=pool)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)
    # the chain is not trivially saturated or all zero
    assert 0.05 < np.mean(ref != 0) < 0.95 and np.mean(np.abs(ref) == 127) < 0.5


def test_quantize_conv1_weights_matches_jax():
    from spnerf_tpu.kernels.conv12_fused_pallas import (
        quantize_conv1_weights as jax_q,
    )
    k1 = np.random.default_rng(11).standard_normal((3, 3, 1, 64)).astype(np.float32)
    k1[..., 5] = 0.0  # the max(absmax, 1e-12) guard
    kq, s = quantize_conv1_weights(_t(k1))
    kq_ref, s_ref = jax_q(jnp.asarray(k1))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("cm", [64, 128])  # blocks 3-4 and blocks 5-6
def test_double_packed_conv3x3_matches_jax(cm):
    rng = np.random.default_rng(12 + cm)
    B, H, W, C = 2, 16, 32, 64
    x = _int8(rng, (B, H, W, C), 0, 128)  # post-ReLU activations
    wa, wb = _int8(rng, (3, 3, C, cm)), _int8(rng, (3, 3, cm, cm))
    ma, ba = _mb(rng, cm, 1e-4, 6e-4)
    mb, bb = _mb(rng, cm, 5e-5, 4e-4)
    # hb=4: four row bands, so the band borders and the zeroed mid rows
    # at the image border are both exercised
    ref = double_packed_conv3x3_pallas(
        jnp.asarray(x.reshape(B, H, W // 2, 2 * C)), jnp.asarray(wa),
        jnp.asarray(ma), jnp.asarray(ba), jnp.asarray(wb), jnp.asarray(mb),
        jnp.asarray(bb), pool=True, hb=4)
    ref = np.asarray(ref).reshape(B, H // 2, W // 2, cm)
    out = double_packed_conv3x3(_t(x), _t(wa), _t(ma), _t(ba), _t(wb),
                                _t(mb), _t(bb), pool=True)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.05 < np.mean(ref != 0) < 0.95


def test_double_conv3x3_matches_jax():
    rng = np.random.default_rng(13)
    B, H, W, C = 2, 12, 16, 128
    x = _int8(rng, (B, H, W, C), 0, 128)
    wa, wb = _int8(rng, (3, 3, C, C)), _int8(rng, (3, 3, C, C))
    ma, ba = _mb(rng, C, 5e-5, 4e-4)
    mb, bb = _mb(rng, C, 3e-5, 3e-4)
    ref = np.asarray(double_conv3x3_pallas(
        jnp.asarray(x), jnp.asarray(wa), jnp.asarray(ma), jnp.asarray(ba),
        jnp.asarray(wb), jnp.asarray(mb), jnp.asarray(bb)))
    out = double_conv3x3(_t(x), _t(wa), _t(ma), _t(ba), _t(wb), _t(mb),
                         _t(bb))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.05 < np.mean(ref != 0) < 0.95


@pytest.mark.parametrize("kind", ["detector_softmax", "detector_logits",
                                  "descriptor"])
def test_head_matches_jax(kind):
    rng = np.random.default_rng(14)
    B, H, W = 2, 8, 16
    cout = 256 if kind == "descriptor" else 65
    x = _int8(rng, (B, H, W, 128), 0, 128)
    w3 = _int8(rng, (3, 3, 128, 256))
    m3, b3 = _mb(rng, 256, 5e-5, 4e-4)
    w1 = _int8(rng, (256, cout))
    m1 = rng.uniform(2e-5, 1e-4, cout).astype(np.float32)
    b1 = rng.uniform(-1, 1, cout).astype(np.float32)
    pad = (-cout) % 128  # the reference's lane padding (serving._head_wmb)
    softmax = cout if kind == "detector_softmax" else None
    ref = head_pallas(
        jnp.asarray(x), jnp.asarray(w3), jnp.asarray(m3), jnp.asarray(b3),
        jnp.pad(jnp.asarray(w1), ((0, 0), (0, pad))),
        jnp.pad(jnp.asarray(m1), (0, pad)), jnp.pad(jnp.asarray(b1), (0, pad)),
        softmax_lanes=softmax, out_dtype=jnp.bfloat16)
    ref = jax_bf16_to_torch(ref)
    out = head(_t(x), _t(w3), _t(m3), _t(b3), _t(w1), _t(m1), _t(b1),
               softmax_lanes=softmax)
    assert out.dtype == torch.bfloat16
    if softmax:
        assert out.shape == (B, H, W, 64)
        assert not ref[..., 64:].float().any()  # dustbin and pad lanes zero
        ref = ref[..., :64]
        assert float(out.float().sum(-1).max()) <= 1.01
    else:
        assert out.shape == (B, H, W, cout)
        ref = ref[..., :cout]
    assert bf16_ulp_diff(out, ref) <= 1


def test_cast_int8_rounds_half_to_even():
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -200.0])
    np.testing.assert_array_equal(cast_int8(y).numpy(),
                                  [0, 2, 2, 0, -2, 126, 127, -127])


def test_nvcc_command_targets_hopper_without_fast_math(monkeypatch):
    from spnerf_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build._nvcc_cmd("head", _build.BUILD_DIR / "libhead.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert _build.BUILD_DIR.parts[-2:] == ("build", "spnerf_tpu_torch")

