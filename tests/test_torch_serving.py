"""The port's int8 serving slice against the JAX package on the CPU.

JAX side: ``ServingSuperPoint`` (int8, fused mid and tail, Pallas in
interpret mode) -> ``detect_from_probs_padded(compact=False)`` ->
``sample_descriptors_onehot``, as ``bench.py`` chains them. Port side:
the same graph built from JAX's folded weights and JAX's activation
scales (``serving_from_folded``), so that only the kernels' arithmetic
is compared.

Tolerances: ``probs`` and ``desc_raw`` within 1 bf16 ulp (the int8 chain
is exact; the softmax's exp and sum order differ, and one float32 ulp
can flip a bf16 rounding); valid keypoint sets equal (every pixel is a
candidate, so exact top-k and strict-``>`` NMS make the set independent
of tie order); sampled descriptors at cosine >= 0.999 (bf16 operands,
float32 sums in another order); the port's own calibration scales within
rtol 1e-5 (float32 convs summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp_diff, flax_superpoint, jax_bf16_to_torch
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.models.superpoint import fold_batch_norm as jax_fold
from spnerf_tpu.ops import fast_inference as jfi
from spnerf_tpu.ops.serving import ServingSuperPoint as JaxServing
from spnerf_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from spnerf_tpu_torch.ops import fast_inference as tfi
from spnerf_tpu_torch.ops.serving import ServingSuperPoint
from spnerf_tpu_torch.tools.import_jax_weights import (
    load_flax_variables,
    serving_from_folded,
)

B, H, W = 2, 32, 64
THRESH = 0.015
ALL = (H // 8) * (W // 8) * 64  # every pixel is a candidate


@pytest.fixture(scope="module")
def ref():
    """JAX serving outputs and everything the port needs to rebuild them."""
    jcfg = JaxConfig()
    _, variables = flax_superpoint(jcfg, (1, H, W, 1), seed=11)
    x = np.random.default_rng(12).uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    sp = JaxServing.build(jcfg, variables, calib_images=jnp.asarray(x),
                          mode="int8")
    out = sp(jnp.asarray(x), softmax=True)
    probs = out["probs_padded"]
    dets = {}
    for compact in (False, True):
        dets[compact] = jax.tree.map(np.asarray, jfi.detect_from_probs_padded(
            probs, 8, min_prob=THRESH, size=4, num_candidates=ALL, top_k=ALL,
            compact=compact))
    pts = jnp.asarray(dets[False][0])
    desc = jax.vmap(lambda d, p: jfi.sample_descriptors_onehot(d, p, 8))(
        out["desc_raw"], pts)
    return dict(
        variables=variables, x=x,
        folded=jax.tree.map(np.asarray, jax_fold(variables)),
        scales={k: np.asarray(v) for k, v in sp.act_scales.items()},
        probs=jax_bf16_to_torch(probs),
        desc_raw=jax_bf16_to_torch(out["desc_raw"]),
        dets=dets, desc=np.asarray(desc))


@pytest.fixture(scope="module")
def port(ref):
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu")
    return sp, sp(torch.from_numpy(ref["x"]), softmax=True)


def _point_set(pts, valid):
    return {(float(y), float(x)) for (y, x), v in zip(pts, valid) if v}


def test_serving_outputs_match_jax(ref, port):
    _, out = port
    assert set(out) == {"probs", "desc_raw"}
    assert out["probs"].shape == (B, H // 8, W // 8, 64)
    assert out["probs"].dtype == torch.bfloat16
    assert not ref["probs"][..., 64:].float().any()  # JAX's pad lanes
    assert bf16_ulp_diff(out["probs"], ref["probs"][..., :64]) <= 1
    assert out["desc_raw"].shape == (B, H // 8, W // 8, 256)
    assert bf16_ulp_diff(out["desc_raw"], ref["desc_raw"]) <= 1


@pytest.mark.parametrize("compact", [False, True])
def test_detect_matches_jax(ref, port, compact):
    _, out = port
    pts, scores, valid = tfi.detect_from_probs_padded(
        out["probs"], 8, min_prob=THRESH, size=4, num_candidates=ALL,
        top_k=ALL, compact=compact)
    jpts, jscores, jvalid = ref["dets"][compact]
    assert pts.shape == jpts.shape and valid.shape == jvalid.shape
    for b in range(B):
        got = _point_set(pts[b].numpy(), valid[b].numpy())
        want = _point_set(jpts[b], jvalid[b])
        assert got == want
        assert 0 < len(got) < ALL  # NMS both kept and suppressed points
        np.testing.assert_allclose(
            np.sort(scores[b].numpy()[valid[b].numpy()]),
            np.sort(jscores[b][jvalid[b]]), rtol=1e-2)


def test_descriptors_match_jax(ref, port):
    _, out = port
    jpts, _, jvalid = ref["dets"][False]
    desc = tfi.sample_descriptors_onehot(out["desc_raw"],
                                         torch.from_numpy(np.array(jpts)), 8)
    assert desc.shape == (B, ALL, 256)
    d, r = desc.numpy()[jvalid], ref["desc"][jvalid]
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert (d * r).sum(-1).min() >= 0.999


def test_own_calibration_matches_jax(ref):
    model = load_flax_variables(SuperPoint(SuperPointConfig()),
                                ref["variables"]).eval()
    sp = ServingSuperPoint.build(SuperPointConfig(), model,
                                 calib_images=torch.from_numpy(ref["x"]),
                                 device="cpu")
    assert set(sp.act_scales) == set(ref["scales"])
    for name, s in sp.act_scales.items():
        np.testing.assert_allclose(s.numpy(), ref["scales"][name], rtol=1e-5,
                                   err_msg=name)


def test_build_inference_end_to_end(ref):
    """The path bench.py times, through the port's entry point."""
    model = load_flax_variables(SuperPoint(SuperPointConfig()),
                                ref["variables"]).eval()
    cfg = SuperPointConfig(det_thresh=THRESH)
    x = torch.from_numpy(ref["x"])
    infer = tfi.build_inference(cfg, model, x, device="cpu", top_k=256)
    pts, scores, valid, desc = infer(x)
    assert pts.shape == (B, 256, 2) and desc.shape == (B, 256, 256)
    assert valid.any(dim=1).all()
    assert torch.isfinite(desc).all() and torch.isfinite(scores).all()
    norms = desc[valid].norm(dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms), atol=1e-5, rtol=0)


def test_unported_modes_raise(ref):
    """As in the JAX package: a mode that is not int8, bf16 or mixed
    raises, and so does ``softmax=True`` without the fused tail."""
    with pytest.raises(ValueError, match="mode"):
        serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                            mode="int4")
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             fused_tail=False)
    with pytest.raises(ValueError, match="fused_tail"):
        sp(torch.from_numpy(ref["x"]), softmax=True)


def test_serving_rejects_unaligned_input(port):
    """Inputs need H % 16 == 0 and W % 8 == 0, as in the JAX package: W
    36 raises, W 40 (where the fused mid cannot run) serves."""
    sp, _ = port
    with pytest.raises(ValueError, match="W % 8"):
        sp(torch.zeros(1, 32, 36, 1))
    out = sp(torch.rand(1, 32, 40, 1), softmax=True)
    assert out["probs"].shape == (1, 4, 5, 64)
    assert out["desc_raw"].shape == (1, 4, 5, 256)


def test_detect_keypoints_matches_jax():
    """``detect_keypoints`` on a (B, H, W) heatmap with every pixel a
    candidate: the same valid points and scores as the JAX package."""
    rng = np.random.default_rng(13)
    prob = rng.uniform(0, 0.05, (2, 24, 40)).astype(np.float32)
    n_all = 24 * 40
    jpts, jscores, jvalid = jax.tree.map(np.asarray, jfi.detect_keypoints(
        jnp.asarray(prob), min_prob=THRESH, size=4, num_candidates=n_all,
        top_k=n_all))
    pts, scores, valid = tfi.detect_keypoints(
        torch.from_numpy(prob), min_prob=THRESH, size=4,
        num_candidates=n_all, top_k=n_all)
    for b in range(2):
        got = _point_set(pts[b].numpy(), valid[b].numpy())
        assert got == _point_set(jpts[b], jvalid[b])
        assert 0 < len(got) < n_all
        np.testing.assert_array_equal(np.sort(scores[b].numpy()[valid[b]]),
                                      np.sort(jscores[b][jvalid[b]]))
