"""The port's SuperPoint model, BN folding and weight quantization
against the flax package on the CPU, with the same carried weights.

Tolerances: the fp32 forward within atol = rtol = 1e-4 (XLA and PyTorch
sum the conv products in different orders over ten layers); the fold
within 1e-6 relative (the same float32 formula and order, but XLA may
fuse ``scale / sqrt(var + eps)`` differently); int8 weights exactly
equal and their scales within 1 float32 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import flax_superpoint
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.models.superpoint import fold_batch_norm as jax_fold
from spnerf_tpu.ops.quantization import quantize_weights as jax_quantize
from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    fold_batch_norm,
    init_superpoint,
)
from spnerf_tpu_torch.ops.quantization import quantize_weights
from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

H, W = 16, 32


@pytest.fixture(scope="module")
def carried():
    """(jax config, flax model, numpy variables, port model on the CPU)."""
    jcfg = JaxConfig()
    model, variables = flax_superpoint(jcfg, (1, H, W, 1), seed=3)
    port = load_flax_variables(SuperPoint(SuperPointConfig()), variables)
    return jcfg, model, variables, port.eval()


@pytest.mark.parametrize("model_name", ["superpoint", "magicpoint"])
def test_fp32_forward_matches_flax(model_name):
    jcfg = JaxConfig(model_name=model_name)
    model, variables = flax_superpoint(jcfg, (1, H, W, 1), seed=4)
    port = load_flax_variables(
        SuperPoint(SuperPointConfig(model_name=model_name)), variables).eval()
    x = np.random.default_rng(5).uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_fold_batch_norm_matches_flax(carried):
    _, _, variables, port = carried
    ref = jax_fold(variables)["params"]
    folded = fold_batch_norm(port)
    assert len(folded) == 12
    for path, node in folded.items():
        r = ref
        for part in path.split("/"):
            r = r[part]
        for key in ("kernel", "bias"):
            a = node[key].numpy()
            b = np.asarray(r["Conv_0"][key])
            assert a.shape == b.shape, (path, key)
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert rel <= 1e-6, (path, key, rel)


def test_quantize_weights_matches_jax(carried):
    _, _, variables, port = carried
    for path, node in fold_batch_norm(port).items():
        q, s = quantize_weights(node["kernel"])
        q_ref, s_ref = jax_quantize(jnp.asarray(node["kernel"].numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref), err_msg=path)
        ulps = np.abs(s.numpy().view(np.int32) - np.asarray(s_ref).view(np.int32))
        assert ulps.max() <= 1, (path, ulps.max())


def test_init_superpoint_is_seeded():
    cfg = SuperPointConfig()
    a = init_superpoint(7, cfg, device="cpu")
    b = init_superpoint(7, cfg, device="cpu")
    c = init_superpoint(8, cfg, device="cpu")
    wa = a.backbone["block3"].Conv_0.weight
    assert torch.equal(wa, b.backbone["block3"].Conv_0.weight)
    assert not torch.equal(wa, c.backbone["block3"].Conv_0.weight)
    # flax path names survive as module paths
    names = dict(a.named_modules())
    assert "detector.convPb.BatchNorm_0" in names
    assert "descriptor.convDa.Conv_0" in names
    assert not a.training


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_superpoint(0, SuperPointConfig())
    assert resolve_device("cpu").type == "cpu"
