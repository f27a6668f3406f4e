"""The port's int8 post-training quantization (``ops/quantization.py``)
against the JAX package's (``spnerf_tpu/ops/quantization.py``) on the
CPU, with the same carried weights and numpy inputs.

Tolerances: ``quantize_activations`` and the int32 sums of ``conv_int8``
exactly equal, its dequantized output exactly equal too. The calibration
scales within 1e-6 relative (the float32 convs sum in other orders;
1.2e-7 measured); the int8 weights equal, their scales within 1e-6 (the
BN fold's float32 rounding: 1.9e-7 measured). With the JAX package's
scales carried in, every int8 code of every layer equal but at most 0.1%
(none measured), and the logits and ``desc_raw`` within one bf16 ulp of
the head's sum (equal measured). Against the port's own BN-folded float
model the logits within the reference's bound, 10% of the logit range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import flax_superpoint
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.ops import quantization as jq
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    fold_batch_norm,
    folded_superpoint,
)
from spnerf_tpu_torch.ops import quantization as tq
from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

NARROW = dict(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16), detector_dim=(16, 32),
              descriptor_dim=(16, 32))
H, W = 32, 40


@pytest.fixture(scope="module")
def models():
    """(flax variables, the port's model with them, calibration and test
    images, the JAX package's quantized model)."""
    _, variables = flax_superpoint(JaxConfig(**NARROW), (1, H, W, 1), seed=5)
    port = load_flax_variables(SuperPoint(SuperPointConfig(**NARROW)),
                               variables).eval()
    rng = np.random.default_rng(0)
    calib = rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    x = rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    jmodel = jq.QuantizedSuperPoint.build(JaxConfig(**NARROW), variables,
                                          jnp.asarray(calib))
    return variables, port, calib, x, jmodel


@pytest.mark.parametrize("scale", [0.01, 0.0037, 1.0])
def test_quantize_activations_equals_jax(scale):
    x = np.random.default_rng(1).normal(0, 0.5, (3, 7, 9, 5)).astype(
        np.float32)
    x.flat[:4] = [0.5 * scale, 1.5 * scale, -2.5 * scale, 300.0]  # ties
    want = jq.quantize_activations(jnp.asarray(x), jnp.float32(scale))
    got = tq.quantize_activations(torch.from_numpy(x),
                                  torch.tensor(scale, dtype=torch.float32))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,kernel", [
    ((2, 7, 9, 1), (3, 3, 1, 8)),       # block 1: K = 9, padded to 16
    ((1, 5, 6, 16), (3, 3, 16, 24)),
    ((2, 4, 5, 32), (1, 1, 32, 65)),    # a 1x1 kernel, cout not of 8
    ((1, 1, 3, 8), (3, 3, 8, 8)),       # fewer than 17 rows
])
def test_conv_int8_equals_jax(shape, kernel):
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, shape).astype(np.int8)
    k = rng.integers(-127, 128, kernel).astype(np.int8)
    xs = np.float32(0.0123)
    ws = rng.uniform(1e-3, 1e-2, kernel[-1]).astype(np.float32)
    b = rng.normal(0, 0.1, kernel[-1]).astype(np.float32)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = tq.conv_int32(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    want = jq.conv_int8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(xs),
                        jnp.asarray(ws), jnp.asarray(b))
    got = tq.conv_int8(torch.from_numpy(x), torch.from_numpy(k),
                       torch.tensor(xs), torch.from_numpy(ws),
                       torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_calibration_scales_match_jax(models):
    _, port, calib, _, jmodel = models
    q = tq.QuantizedSuperPoint.build(port.config, port,
                                     torch.from_numpy(calib), device="cpu")
    assert sorted(q.act_scales) == sorted(jmodel.act_scales)
    for name, want in jmodel.act_scales.items():
        want = float(want)
        assert abs(float(q.act_scales[name]) - want) <= 1e-6 * want, name
    for name, (kq, ks) in jmodel.weights_q.items():
        got_q, got_s = q.weights_q[name]
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(kq))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ks), rtol=1e-6)


def _recorded_codes(monkeypatch, module):
    codes = []
    real = module.quantize_activations

    def record(x, scale):
        out = real(x, scale)
        codes.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "quantize_activations", record)
    return codes


def test_quantized_graph_matches_jax(models, monkeypatch):
    """The JAX package's scales carried in: the int8 codes of every layer
    and the outputs against the reference's."""
    _, port, _, x, jmodel = models
    scales = {k: np.asarray(v) for k, v in jmodel.act_scales.items()}
    q = tq.QuantizedSuperPoint.build(port.config, port, None,
                                     act_scales=scales, device="cpu")
    want_codes = _recorded_codes(monkeypatch, jq)
    want = jmodel(jnp.asarray(x))
    got_codes = _recorded_codes(monkeypatch, tq)
    got = q(torch.from_numpy(x))
    assert len(got_codes) == len(want_codes) == 10
    differ = sum(int((g != w).sum()) for g, w in zip(got_codes, want_codes))
    total = sum(w.size for w in want_codes)
    assert differ <= 1e-3 * total
    for g, w in zip(got_codes, want_codes):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    for key in ("logits", "desc_raw"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        head = g - q.params[{"logits": "detector/convPb",
                             "desc_raw": "descriptor/convDb"}[key]][
                                 "bias"].numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(head), 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp + 1e-7).all(), key


def test_quantized_graph_close_to_float(models):
    """The reference's bound against the BN-folded float model."""
    _, port, calib, x, _ = models
    q = tq.QuantizedSuperPoint.build(port.config, port,
                                     torch.from_numpy(calib), device="cpu")
    with torch.no_grad():
        ref = folded_superpoint(fold_batch_norm(port), port.config,
                                torch.float32)(torch.from_numpy(x))
    got = q(torch.from_numpy(x))
    scale = float(ref["logits"].abs().max()) + 1e-9
    assert float((got["logits"] - ref["logits"]).abs().max()) / scale < 0.1
    assert got["desc_raw"].shape == ref["desc_raw"].shape


def test_quantized_graph_needs_a_card_unless_asked():
    port = SuperPoint(SuperPointConfig(**NARROW)).eval()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.QuantizedSuperPoint.build(port.config, port,
                                     torch.zeros(1, 16, 16, 1))
