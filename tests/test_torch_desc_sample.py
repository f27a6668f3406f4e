"""Descriptor sampling at keypoints and the tie order at the top-k cuts
(``spnerf_tpu_torch/kernels/desc_sample.py``, ``ops/fast_inference.py``)
against the JAX package on the CPU, on the same numpy inputs.

Tolerances: the fused sampler's plain version against the Pallas kernel
(interpret mode) and against the one-hot product within 1e-5: the same
bf16 weights and map, float32 sums of up to 16 exact products in
another order (measured 7.2e-7 unnormalized, 8.9e-8 on unit vectors).
The float32 samplers within 1e-6 of JAX's (float32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.kernels.desc_sample_pallas import _axis_weights as jax_axis_weights
from spnerf_tpu.kernels.desc_sample_pallas import (
    sample_descriptors_fused as jax_fused,
)
from spnerf_tpu.ops import fast_inference as jfi
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels.desc_sample import (
    axis_taps,
    sample_descriptors_fused,
    sample_descriptors_fused_plain,
)
from spnerf_tpu_torch.ops import fast_inference as tfi

G = 8


def _operands(rng, B, Hc, Wc, C, K, margin=0.0):
    """bf16-representable map (float32 numpy) and (y, x) points, some
    ``margin`` pixels beyond the borders."""
    desc = torch.from_numpy(rng.standard_normal((B, Hc, Wc, C)).astype(
        np.float32)).bfloat16().float().numpy()
    pts = np.stack([rng.uniform(-margin, Hc * G - 1 + margin, (B, K)),
                    rng.uniform(-margin, Wc * G - 1 + margin, (B, K))], -1)
    return desc, pts.astype(np.float32)


def _jax_onehot(desc, pts, normalize=True):
    return np.asarray(jax.vmap(lambda d, p: jfi.sample_descriptors_onehot(
        d, p, G, normalize=normalize))(jnp.asarray(desc, jnp.bfloat16),
                                       jnp.asarray(pts)))


@pytest.mark.parametrize("Hc,Wc,K", [(30, 40, 100), (16, 24, 64)])
@pytest.mark.parametrize("normalize", [True, False])
def test_fused_plain_matches_pallas_and_onehot(Hc, Wc, K, normalize):
    desc, pts = _operands(np.random.default_rng(Hc + K), 2, Hc, Wc, 64, K)
    got = sample_descriptors_fused_plain(
        torch.from_numpy(desc).bfloat16(), torch.from_numpy(pts), G,
        normalize).numpy()
    pallas = np.asarray(jax_fused(jnp.asarray(desc, jnp.bfloat16),
                                  jnp.asarray(pts), G, normalize=normalize,
                                  block_k=64))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _jax_onehot(desc, pts, normalize),
                               atol=1e-5, rtol=0)


def test_fused_plain_clamps_borders_at_a_ragged_k():
    """Points on every corner and up to 12 pixels beyond the borders;
    K = 300 is no multiple of the Pallas kernel's block of 256; a float32
    map is read as bf16."""
    desc, pts = _operands(np.random.default_rng(1), 1, 12, 16, 32, 300,
                          margin=12.0)
    pts[0, :4] = [[0, 0], [95, 127], [0, 127], [95, 0]]
    got = sample_descriptors_fused_plain(torch.from_numpy(desc),
                                         torch.from_numpy(pts), G).numpy()
    pallas = np.asarray(jax_fused(jnp.asarray(desc, jnp.bfloat16),
                                  jnp.asarray(pts), G))
    assert got.shape == pallas.shape == (1, 300, 32)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _jax_onehot(desc, pts), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_axis_taps_match_pallas_axis_weights():
    """The merged taps, scattered into a dense row, are the Pallas
    kernel's ``_axis_weights`` (clipped taps stacked in tap order)."""
    n = 17
    coord = np.array([0.0, 1.0, 3.5, 4.0, 63.9, 100.0, n * G - 1.0, 2.25,
                      57.125, -9.0, 150.0], np.float32)
    want = np.asarray(jax_axis_weights(jnp.asarray(coord)[:, None], n, G))
    idx, w, first = axis_taps(torch.from_numpy(coord), n, G)
    got = np.zeros_like(want)
    for i, wj, fj in zip(idx, w, first):
        for k in np.nonzero(fj.numpy())[0]:
            got[k, int(i[k])] += float(wj[k])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fused_wrapper_takes_the_plain_version_on_cpu():
    desc, pts = _operands(np.random.default_rng(2), 2, 6, 8, 24, 10)
    before = sum(_build.launch_counts.values())
    got = sample_descriptors_fused(torch.from_numpy(desc),
                                   torch.from_numpy(pts), G, normalize=False)
    want = sample_descriptors_fused_plain(torch.from_numpy(desc),
                                          torch.from_numpy(pts), G, False)
    assert torch.equal(got, want)
    assert sum(_build.launch_counts.values()) == before
    with pytest.raises(ValueError, match="needs \\(B, K, 2\\)"):
        sample_descriptors_fused(torch.from_numpy(desc),
                                 torch.from_numpy(pts[:1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_and_matmul_samplers_match_jax(dtype):
    """``sample_descriptors_onehot`` (bf16 product) within 1e-5 and
    ``sample_descriptors_matmul`` (weights in the map's dtype) within
    1e-6 of JAX's."""
    desc, pts = _operands(np.random.default_rng(3), 2, 10, 14, 48, 40,
                          margin=4.0)
    jd = jnp.asarray(desc, jnp.dtype(dtype))
    td = torch.from_numpy(desc).to(getattr(torch, dtype))
    tp = torch.from_numpy(pts)
    want = np.asarray(jax.vmap(lambda d, p: jfi.sample_descriptors_matmul(
        d, p, G))(jd, jnp.asarray(pts)))
    np.testing.assert_allclose(tfi.sample_descriptors_matmul(td, tp, G),
                               want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tfi.sample_descriptors_onehot(td, tp, G),
                               _jax_onehot(desc, pts), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- tie order

TIE_B, TIE_HC, TIE_WC = 2, 60, 80
TIE_VALUE, TIE_ABOVE, TIE_RUN = 0.25, 980, 60  # the run spans ranks 981-1040


def _tie_probs(seed):
    """(2, 60, 80, 64) bf16 cell probabilities: 980 pixels above 0.25
    (ties among them are harmless), 60 pixels at exactly 0.25 straddling
    both cuts (1,024 candidates, top_k 1,000), the rest below 0.1. The
    1,040 pixels lie on a 4-pixel lattice, so that NMS keeps them all
    and the second cut falls inside the run too."""
    rng = np.random.default_rng(seed)
    n = TIE_HC * TIE_WC * 64
    probs = rng.uniform(0.0, 0.1, (TIE_B, n))
    y, x = np.divmod(np.arange(n // 16), TIE_WC * G // 4)
    y, x = 4 * y, 4 * x
    lattice = (y // G * TIE_WC + x // G) * 64 + y % G * G + x % G
    for b in range(TIE_B):
        pick = rng.permutation(lattice)[:TIE_ABOVE + TIE_RUN]
        probs[b, pick[:TIE_ABOVE]] = rng.uniform(0.5, 1.0, TIE_ABOVE)
        probs[b, pick[TIE_ABOVE:]] = TIE_VALUE
    probs = torch.from_numpy(probs.astype(np.float32)).bfloat16()
    return probs.reshape(TIE_B, TIE_HC, TIE_WC, 64)


def _raster(Hc, Wc):
    pos = np.arange(Hc * Wc * 64)
    cell, within = pos // 64, pos % 64
    ys = cell // Wc * G + within // G
    xs = cell % Wc * G + within % G
    return ys, xs


def _stable_reference(probs, C, top_k, compact, min_prob=0.015, size=4,
                      iou=0.1):
    """Candidate NMS with a stable order in numpy: candidates by score,
    then lowest raster index; survivors by score, then candidate rank."""
    B, Hc, Wc, _ = probs.shape
    flat = probs.float().reshape(B, -1).numpy()
    ys_all, xs_all = _raster(Hc, Wc)
    raster = ys_all * Wc * G + xs_all
    pts_out, valid_out = [], []
    for b in range(B):
        order = np.lexsort((raster, -flat[b]))[:C]
        ys, xs = ys_all[order].astype(np.float32), xs_all[order].astype(
            np.float32)
        s = flat[b, order]
        inter = (np.maximum(0, size - np.abs(ys[:, None] - ys[None]))
                 * np.maximum(0, size - np.abs(xs[:, None] - xs[None])))
        overlap = inter / (2.0 * size * size - inter) > iou
        cand = s >= min_prob
        keep = cand & ~(overlap & (s[None, :] > s[:, None])
                        & cand[None, :]).any(-1)
        if not compact:
            pts_out.append(np.stack([ys, xs], -1))
            valid_out.append(keep)
            continue
        kept = np.where(keep, s, -np.inf)
        sel = np.lexsort((np.arange(C), -kept))[:top_k]
        pts_out.append(np.stack([ys[sel], xs[sel]], -1))
        valid_out.append(np.isfinite(kept[sel]) & (kept[sel] >= min_prob))
    return np.stack(pts_out), np.stack(valid_out)


def _point_sets(pts, valid):
    return [{tuple(p) for p in np.asarray(pts)[b][np.asarray(valid)[b]]}
            for b in range(len(pts))]


def _tie_points(probs):
    """Per image, the (y, x) pixels holding the tie value."""
    ys, xs = _raster(TIE_HC, TIE_WC)
    flat = probs.float().reshape(TIE_B, -1).numpy()
    return [{(float(ys[i]), float(xs[i]))
             for i in np.nonzero(flat[b] == TIE_VALUE)[0]}
            for b in range(TIE_B)]


@pytest.mark.parametrize("route", ["padded", "padded_all", "heatmap"])
def test_tie_order_at_the_cut(route):
    """The port takes the lowest raster indices of a tie run that
    straddles the cut, as the stable numpy reference does, run after
    run; the JAX package's sets differ from it only inside that run."""
    probs = _tie_probs(7)
    compact = route != "padded_all"
    kw = dict(min_prob=0.015, size=4, iou=0.1, num_candidates=1024,
              top_k=1000)
    if route == "heatmap":
        heat = probs.float().reshape(TIE_B, TIE_HC, TIE_WC, G, G).permute(
            0, 1, 3, 2, 4).reshape(TIE_B, TIE_HC * G, TIE_WC * G)
        run = lambda: tfi.detect_keypoints(heat.bfloat16(), **kw)  # noqa: E731
        jax_pts, _, jax_valid = jfi.detect_keypoints(
            jnp.asarray(heat.numpy(), jnp.bfloat16), **kw)
    else:
        run = lambda: tfi.detect_from_probs_padded(  # noqa: E731
            probs, G, compact=compact, **kw)
        jax_pts, _, jax_valid = jfi.detect_from_probs_padded(
            jnp.asarray(probs.float().numpy(), jnp.bfloat16), G,
            compact=compact, **kw)
    pts, scores, valid = run()
    pts2, _, valid2 = run()
    assert torch.equal(pts, pts2) and torch.equal(valid, valid2)
    want_pts, want_valid = _stable_reference(probs, 1024, 1000, compact)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(pts.numpy()[want_valid],
                                  want_pts[want_valid])
    ties = _tie_points(probs)
    got_sets = _point_sets(pts, valid)
    for b, (got, jax_set) in enumerate(zip(got_sets,
                                           _point_sets(jax_pts, jax_valid))):
        # the run straddles the cut: 1,000 - 980 or 1,024 - 980 of its 60
        assert len(got & ties[b]) == (44 if route == "padded_all" else 20)
        assert (got ^ jax_set) <= ties[b]
