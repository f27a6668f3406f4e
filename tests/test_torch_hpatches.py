"""The parity inference path and the HPatches export
(``ops/upsample.py``, ``ops/descriptor_sampling.py``,
``models/superpoint.superpoint_inference``, ``tasks/export.
export_hpatches``) against the JAX package on the CPU, with the same
carried weights and numpy inputs.

Tolerances: the upsample and the float32 samplers within 1e-6 (the same
float32 weights and sum order; the samplers' gathers are exact). The
narrow model's forward within 1e-4 as in ``test_torch_model.py`` (XLA and
PyTorch sum the conv products in other orders), the probabilities
within 1e-5 and the unit descriptors within 1e-5; NMS'd heatmaps equal
wherever both keep a point, and the kept sets equal away from a
near-tie (a point within 1e-5 of a neighbour's score).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import flax_superpoint
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.models.superpoint import superpoint_inference as jax_inference
from spnerf_tpu.ops.descriptor_sampling import (
    sample_descriptors as jax_sample_descriptors,
)
from spnerf_tpu.ops.upsample import upsample_bicubic as jax_upsample
from spnerf_tpu.tasks import export as jexport
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    superpoint_inference,
)
from spnerf_tpu_torch.ops.descriptor_sampling import sample_descriptors
from spnerf_tpu_torch.ops.upsample import upsample_bicubic
from spnerf_tpu_torch.tasks import export as texport
from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

NARROW = dict(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16), detector_dim=(16, 32),
              descriptor_dim=(16, 32), det_thresh=0.015, top_k=50)
H, W = 64, 80


@pytest.fixture(scope="module")
def narrow():
    """(flax model, numpy variables, the port's model with them)."""
    model, variables = flax_superpoint(JaxConfig(**NARROW), (1, H, W, 1),
                                       seed=40)
    port = load_flax_variables(SuperPoint(SuperPointConfig(**NARROW)),
                               variables).eval()
    return model, variables, port


def _pairs(n, seed=41):
    """n synthetic pairs: smooth noise with a bright rectangle, and its
    copy shifted by (3, 5) pixels, with that translation as homography."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (n, H // 8, W // 8))
    image = np.repeat(np.repeat(coarse, 8, 1), 8, 2) * 0.5
    image[:, 20:44, 24:60] += 0.5
    image = (image + rng.uniform(0, 0.05, image.shape)).astype(np.float32)
    warped = np.zeros_like(image)
    warped[:, 3:, 5:] = image[:, :-3, :-5]
    hom = np.tile(np.array([[1, 0, 5], [0, 1, 3], [0, 0, 1]], np.float32),
                  (n, 1, 1))
    return image[..., None], warped[..., None], hom


@pytest.mark.parametrize("factor", [8, 3])
def test_upsample_bicubic_matches_jax(factor):
    x = np.random.default_rng(factor).standard_normal((2, 5, 7, 6)).astype(
        np.float32)
    got = upsample_bicubic(torch.from_numpy(x), factor).numpy()
    want = np.asarray(jax_upsample(jnp.asarray(x), factor))
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("normalize", [True, False])
def test_sample_descriptors_matches_jax(method, normalize):
    rng = np.random.default_rng(5)
    desc = rng.standard_normal((9, 11, 32)).astype(np.float32)
    pts = np.stack([rng.uniform(-6, 9 * 8 + 5, 60),
                    rng.uniform(-6, 11 * 8 + 5, 60)], -1).astype(np.float32)
    pts[:2] = [[0, 0], [71, 87]]
    got = sample_descriptors(torch.from_numpy(desc), torch.from_numpy(pts),
                             8, method, normalize).numpy()
    want = np.asarray(jax_sample_descriptors(
        jnp.asarray(desc), jnp.asarray(pts), 8, method, normalize))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sample_descriptors_is_the_upsample_read_at_pixels():
    """Bicubic sampling at integer pixels equals the dense x8 upsample
    read there (the parity path's geometry), before normalization."""
    rng = np.random.default_rng(6)
    desc = rng.standard_normal((1, 6, 7, 16)).astype(np.float32)
    dense = upsample_bicubic(torch.from_numpy(desc), 8)[0]
    pts = np.stack([rng.integers(0, 48, 40), rng.integers(0, 56, 40)], -1)
    got = sample_descriptors(torch.from_numpy(desc[0]),
                             torch.from_numpy(pts.astype(np.float32)), 8,
                             normalize=False)
    np.testing.assert_allclose(got, dense[pts[:, 0], pts[:, 1]], atol=1e-5)


def _assert_nms_close(got, want, prob):
    """NMS'd heatmaps: equal scores where both keep a point; a point kept
    by one side only has a neighbour within 1e-5 of its score."""
    both = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[both], want[both], atol=1e-5, rtol=0)
    for b, y, x in zip(*np.nonzero((got > 0) != (want > 0))):
        win = prob[b, max(y - 3, 0):y + 4, max(x - 3, 0):x + 4]
        gaps = np.abs(win - prob[b, y, x])
        assert np.sort(gaps.ravel())[1] <= 1e-5, (b, y, x)


def test_superpoint_inference_matches_jax(narrow):
    model, variables, port = narrow
    image, _, _ = _pairs(2)
    got = superpoint_inference(port, torch.from_numpy(image))
    want = jax.jit(functools.partial(jax_inference, model))(
        variables, jnp.asarray(image))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["prob_heatmap"], want["prob_heatmap"],
                               atol=1e-5, rtol=0)
    prob = np.asarray(want["prob_heatmap"])
    _assert_nms_close(got["prob_heatmap_nms"].numpy(),
                      np.asarray(want["prob_heatmap_nms"]), prob)
    assert int(got["pred_pts"].sum()) > 0
    assert got["desc"].shape == (2, H, W, 32)
    np.testing.assert_allclose(got["desc"], want["desc"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["desc"].norm(dim=-1), 1.0, atol=1e-5)
    no_nms = superpoint_inference(port, torch.from_numpy(image),
                                  with_nms=False)
    assert "prob_heatmap_nms" not in no_nms
    assert torch.equal(no_nms["pred_pts"],
                       (no_nms["prob_heatmap"] >= 0.015).int())


def test_nms_threshold_points_matches_jax():
    prob = np.random.default_rng(7).uniform(0, 0.03, (24, 32)).astype(
        np.float32)
    got = texport._nms_threshold_points(prob, 0.015)
    np.testing.assert_array_equal(got, jexport._nms_threshold_points(
        prob, 0.015))
    assert got.dtype == np.int64 and got.shape[1] == 2


@pytest.mark.parametrize("with_descriptors", [False, True])
def test_export_hpatches_matches_jax(narrow, tmp_path, monkeypatch,
                                     with_descriptors):
    """Bundles of 2 synthetic pairs (batches of 1) by both packages: the
    same files, keys, shapes and dtypes; images and homographies equal,
    heatmaps and descriptors within the tolerances above."""
    model, variables, port = narrow
    image, warped, hom = _pairs(2, seed=42)
    batches = [{"image": image[i:i + 1], "warped_image": warped[i:i + 1],
                "homography": hom[i:i + 1], "name": [f"pair{i}"]}
               for i in range(2)]
    config = {"data": {"experiment_name": "narrow"}}
    monkeypatch.setattr(jexport, "EXPER_PATH", tmp_path / "jax")
    monkeypatch.setattr(texport, "EXPER_PATH", tmp_path / "port")
    jdir = jexport.export_hpatches(config, model, variables, batches,
                                   with_descriptors=with_descriptors)
    tdir = texport.export_hpatches(config, port, batches,
                                   with_descriptors=with_descriptors,
                                   device="cpu")
    kind = "descriptors" if with_descriptors else "repeatability"
    assert tdir == tmp_path / "port" / kind / "narrow"
    names = sorted(p.name for p in jdir.glob("*.npz"))
    assert names == sorted(p.name for p in tdir.glob("*.npz")) \
        == ["pair0.npz", "pair1.npz"]
    for name in names:
        want, got = np.load(jdir / name), np.load(tdir / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        for key in ("image", "warped_image", "homography"):
            np.testing.assert_array_equal(got[key], want[key])
        for key, img in (("prob", "image"), ("warped_prob", "warped_image")):
            prob = superpoint_inference(
                port, torch.from_numpy(want[img][None, ..., None]))
            _assert_nms_close(got[key][None], want[key][None],
                              prob["prob_heatmap"].numpy())
        if with_descriptors:
            assert got["desc"].shape == (H, W, 32)
            for key in ("desc", "warped_desc"):
                np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                           rtol=0)


@pytest.mark.parametrize("kind,config", [
    ("repeatability", "magicpoint_repeatability.yaml"),
    ("descriptors", "superpoint_descriptors.yaml")])
def test_chip_smoke_exports_the_config_files(kind, config):
    """The dicts ``chip_smoke.py`` exports with equal the YAML files; its
    one cut replaces ``pretrained`` by the demo checkpoint."""
    import importlib.util
    from pathlib import Path

    import yaml

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = yaml.safe_load((root / "spnerf_tpu/configs" / config).read_text())
    assert smoke.HP_CONFIGS[kind] == want
    assert smoke.HP_CUTS == {"pretrained": "pretrained/demo_mp_5000.ckpt"}
    assert (root / "demo" / smoke.HP_CUTS["pretrained"]).is_file()
