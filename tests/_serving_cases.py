"""Shared cases of ``test_torch_serving_modes.py`` and
``test_torch_serving_unfused.py``: the JAX serving graph in one mode and
route (Pallas in interpret mode), the port's graph from the same folded
weights and activation scales, and the checks between them.

Tolerances. int8 mode: bf16 outputs within 1 ulp (the int8 chain is
exact; the softmax's exp and sum order differ). mixed mode (the int8
backbone is exact, one bf16 head follows): at least 99.9% of ``probs`` /
``logits`` and ``desc_raw`` within 1 bf16 ulp (counted by
``bf16_scaled_ulps``) and every value within 1e-2 of the tensor's
largest magnitude. bf16 mode: every value within 1 bf16 ulp of the
tensor's largest magnitude (so within 2**-7 of it). Ten layers each
round their bf16 activations after float32 sums taken in another order;
a value rounded apart moves what it feeds, and the differences compound:
at 2 x 32 x 64 and x 56, 20% and 41% of ``desc_raw`` differ, 3.5% and 7%
by more than 1 ulp of their own (counted at 1/16 of the largest), none
by more than 1 ulp of the largest. Keypoints with every pixel a
candidate (exact top-k, strict NMS): int8 sets equal; otherwise each
set holds at most 1% of the points, or one point, that the other lacks
(a probability a bf16 ulp from the threshold or from a neighbour it
competes with in NMS; an image here holds 70-85 points). Descriptors sampled at the
reference's points: cosine >= 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import (
    bf16_scaled_ulps,
    bf16_ulp_diff,
    flax_superpoint,
    jax_bf16_to_torch,
)
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.models.superpoint import fold_batch_norm as jax_fold
from spnerf_tpu.ops import fast_inference as jfi
from spnerf_tpu.ops.serving import ServingSuperPoint as JaxServing
from spnerf_tpu_torch.ops import fast_inference as tfi
from spnerf_tpu_torch.tools.import_jax_weights import serving_from_folded

B, H = 2, 32
THRESH = 0.015
SEED = 11


def jax_variables():
    """Seeded full-width flax SuperPoint weights (numpy tree)."""
    return flax_superpoint(JaxConfig(), (1, H, 64, 1), seed=SEED)[1]


def jax_case(variables, mode, fused_mid, fused_tail, W):
    """The JAX graph's outputs, detections and descriptors, and what the
    port needs to rebuild the graph."""
    n_all = (H // 8) * (W // 8) * 64  # every pixel a candidate
    x = np.random.default_rng(SEED + W).uniform(0, 1, (B, H, W, 1)).astype(
        np.float32)
    sp = JaxServing.build(JaxConfig(), variables, calib_images=jnp.asarray(x),
                          mode=mode, fused_mid=fused_mid,
                          fused_tail=fused_tail)
    out = sp(jnp.asarray(x), softmax=fused_tail)
    if fused_tail:
        det = out["probs_padded"]
        dets = jfi.detect_from_probs_padded(
            det, 8, min_prob=THRESH, size=4, num_candidates=n_all,
            top_k=n_all, compact=False)
        det = det[..., :64]
    else:
        det = out["logits"]
        dets = jfi.detect_from_logits(det, 8, min_prob=THRESH, size=4,
                                      num_candidates=n_all, top_k=n_all)
    dets = jax.tree.map(np.asarray, dets)
    desc = jax.vmap(lambda d, p: jfi.sample_descriptors_onehot(d, p, 8))(
        out["desc_raw"], jnp.asarray(dets[0]))
    scales = None if sp.act_scales is None else {
        k: np.asarray(v) for k, v in sp.act_scales.items()}
    return dict(
        mode=mode, fused_mid=fused_mid, fused_tail=fused_tail, x=x,
        n_all=n_all, folded=jax.tree.map(np.asarray, jax_fold(variables)),
        scales=scales, det=jax_bf16_to_torch(det),
        desc_raw=jax_bf16_to_torch(out["desc_raw"]), dets=dets,
        desc=np.asarray(desc))


def port_case(ref):
    """The port's graph on the same weights, scales and images:
    (outputs, (pts, scores, valid))."""
    sp = serving_from_folded(ref["folded"], ref["scales"], device="cpu",
                             mode=ref["mode"], fused_mid=ref["fused_mid"],
                             fused_tail=ref["fused_tail"])
    x = torch.from_numpy(ref["x"])
    n_all = ref["n_all"]
    if ref["fused_tail"]:
        out = sp(x, softmax=True)
        dets = tfi.detect_from_probs_padded(
            out["probs"], 8, min_prob=THRESH, size=4, num_candidates=n_all,
            top_k=n_all, compact=False)
    else:
        out = sp(x)
        dets = tfi.detect_from_logits(out["logits"], 8, min_prob=THRESH,
                                      size=4, num_candidates=n_all,
                                      top_k=n_all)
    return out, dets


def check_outputs(ref, out):
    det_key = "probs" if ref["fused_tail"] else "logits"
    assert set(out) == {det_key, "desc_raw"}
    lanes = 64 if ref["fused_tail"] else 65
    Hc, Wc = ref["x"].shape[1] // 8, ref["x"].shape[2] // 8
    for key, want in ((det_key, ref["det"]), ("desc_raw", ref["desc_raw"])):
        got = out[key]
        assert got.dtype == torch.bfloat16
        assert got.shape == want.shape == (B, Hc, Wc,
                                           lanes if key == det_key else 256)
        if ref["mode"] == "int8":
            assert bf16_ulp_diff(got, want) <= 1, key
            continue
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max()), (key, err)
        if ref["mode"] == "bf16":
            d = bf16_scaled_ulps(got, want, floor=1.0)
            assert float(d.max()) <= 1, (key, float(d.max()))
        else:
            share = float((bf16_scaled_ulps(got, want) > 1).float().mean())
            assert share <= 1e-3, (key, share)


def _point_set(pts, valid):
    return {(float(y), float(x)) for (y, x), v in zip(pts, valid) if v}


def check_keypoints(ref, dets):
    pts, _, valid = dets
    jpts, _, jvalid = ref["dets"]
    assert pts.shape == jpts.shape
    for b in range(B):
        got = _point_set(pts[b].numpy(), valid[b].numpy())
        want = _point_set(jpts[b], jvalid[b])
        assert 0 < len(want) < ref["n_all"]  # NMS kept and suppressed
        if ref["mode"] == "int8":
            assert got == want
        else:
            # each side holds at most 1% of its points, or one point, that
            # the other lacks
            bound = max(1, 0.01 * len(want))
            assert len(got - want) <= bound and len(want - got) <= bound


def check_descriptors(ref, out):
    jpts, _, jvalid = ref["dets"]
    desc = tfi.sample_descriptors_onehot(out["desc_raw"],
                                         torch.from_numpy(np.array(jpts)), 8)
    d, r = desc.numpy()[jvalid], ref["desc"][jvalid]
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert (d * r).sum(-1).min() >= 0.999


def check_build_inference(variables, mode, fused_mid, fused_tail, W=64):
    """``build_inference`` end to end on the CPU from the port's own
    model and calibration."""
    from spnerf_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
    from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

    model = load_flax_variables(SuperPoint(SuperPointConfig()),
                                variables).eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
        0, 1, (B, H, W, 1)).astype(np.float32))
    infer = tfi.build_inference(SuperPointConfig(det_thresh=THRESH), model, x,
                                mode=mode, fused_mid=fused_mid,
                                fused_tail=fused_tail, device="cpu", top_k=256)
    assert infer.serving.mode == mode
    pts, scores, valid, desc = infer(x)
    assert pts.shape == (B, 256, 2) and desc.shape == (B, 256, 256)
    assert valid.any(dim=1).all()
    assert torch.isfinite(desc).all() and torch.isfinite(scores).all()
    norms = desc[valid].norm(dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms), atol=1e-5,
                               rtol=0)
