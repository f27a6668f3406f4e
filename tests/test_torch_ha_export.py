"""The port's homographic-adaptation export slice against the JAX package
on the CPU: NMS, decode, ``homography_adaptation`` and
``export_pseudo_labels``, at small widths.

The port cannot draw JAX's homographies, so the adaptation test rebuilds
the JAX program's own homographies from its keys
(``spnerf_tpu/ops/homography_adaptation.py:99-113``) and hands them to the
port. JAX's bf16 warps run the Pallas kernel in interpret mode.
Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import flax_superpoint
from spnerf_tpu.geometry.homography import sample_homography
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.ops import nms as jnms
from spnerf_tpu.ops.detector_decode import decode_detector_logits as jdecode
from spnerf_tpu.ops.homography_adaptation import HAConfig as JaxHAConfig
from spnerf_tpu.ops.homography_adaptation import (
    homography_adaptation as jax_ha,
)
from spnerf_tpu.tasks import export as jexport
from spnerf_tpu_torch.data.loader import DataLoader, collate
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    init_superpoint,
)
from spnerf_tpu_torch.ops import homography_adaptation as tha
from spnerf_tpu_torch.ops import nms as tnms
from spnerf_tpu_torch.ops.detector_decode import decode_detector_logits
from spnerf_tpu_torch.ops.homography_adaptation import (
    HAConfig,
    homography_adaptation,
    image_homographies,
)
from spnerf_tpu_torch.ops.serving import ServingSuperPoint
from spnerf_tpu_torch.ops.space_ops import depth_to_space
from spnerf_tpu_torch.tasks import export as texport
from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

SMALL = dict(model_name="magicpoint", vgg_cn=(4, 4, 8, 8, 8, 8, 8, 8),
             detector_dim=(8, 16))
HA_PARAMS = {"allow_artifacts": True, "patch_ratio": 0.85,
             "scaling_amplitude": 0.2, "perspective_amplitude_x": 0.2,
             "perspective_amplitude_y": 0.2}


@pytest.fixture(scope="module")
def small():
    """(flax model, numpy variables, the port's model with them)."""
    model, variables = flax_superpoint(JaxConfig(**SMALL), (1, 32, 32, 1),
                                       seed=30)
    port = load_flax_variables(SuperPoint(SuperPointConfig(**SMALL)),
                               variables).eval()
    return model, variables, port


def _images(n, h=32, w=32, seed=31):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 1)).astype(
        np.float32)


# ----------------------------------------------------------------- NMS


@pytest.mark.parametrize("keep_top_k", [0, 20])
def test_box_nms_matches_jax(keep_top_k):
    """Equal heatmaps, exact ties included (values on a coarse grid)."""
    prob = np.random.default_rng(32).integers(0, 40, (3, 24, 40))
    prob = (prob / 40.0).astype(np.float32)
    want = np.asarray(jnms.box_nms(jnp.asarray(prob), size=4, min_prob=0.3,
                                   keep_top_k=keep_top_k))
    got = tnms.box_nms(torch.from_numpy(prob), size=4, min_prob=0.3,
                       keep_top_k=keep_top_k).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < (prob >= 0.3).sum()


def test_box_nms_greedy_matches_jax():
    prob = np.random.default_rng(33).random((12, 16)).astype(np.float32)
    for kw in ({}, {"keep_top_k": 5}):
        want = np.asarray(jnms.box_nms_greedy(jnp.asarray(prob), size=3,
                                              min_prob=0.2, **kw))
        got = tnms.box_nms_greedy(torch.from_numpy(prob), size=3,
                                  min_prob=0.2, **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_suppression_offsets_match_jax():
    for size, iou in ((4, 0.1), (3, 0.3), (2, 0.0)):
        assert tnms.suppression_offsets(size, iou) == \
            jnms.suppression_offsets(size, iou)


# -------------------------------------------------------------- decode


def test_decode_and_space_ops_match_jax():
    """Softmax within 1e-6 (exp and sum order); depth-to-space in
    ``pixel_shuffle``'s order, exactly."""
    logits = np.random.default_rng(34).normal(0, 2, (2, 3, 5, 65)).astype(
        np.float32)
    want = np.asarray(jdecode(jnp.asarray(logits), 8))
    got = decode_detector_logits(torch.from_numpy(logits), 8).numpy()
    assert got.shape == (2, 24, 40)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    x = torch.from_numpy(logits[..., :64])
    d2s = torch.nn.functional.pixel_shuffle(x.permute(0, 3, 1, 2), 8)
    assert torch.equal(depth_to_space(x, 8), d2s.permute(0, 2, 3, 1))


# ------------------------------------------------ homography adaptation


def _jax_homographies(key, B, shape, cfg):
    """The homographies JAX's homography_adaptation samples from ``key``
    (ops/homography_adaptation.py:99-113): (B, num - 1, 3, 3)."""
    n_extra = cfg.num - 1
    chunk = min(cfg.chunk, n_extra)
    pad_total = -(-n_extra // chunk) * chunk
    img_keys = jax.random.split(key, B)
    keys = jax.vmap(lambda k: jax.random.split(k, pad_total))(img_keys)
    Hs = jax.vmap(jax.vmap(
        lambda k: sample_homography(k, shape, cfg.params)))(keys)
    return np.asarray(Hs)[:, :n_extra]


# float32: the warps and masks agree to float32 rounding, the forwards
# to the order of their sums (measured 1.4e-7); bf16: a float32 ulp
# before a bf16 rounding (the port's and XLA's H^-1 differ by ulps) can
# flip it, and one bf16 ulp of a probability near 0.02 is 1.2e-4, two
# taps of which can meet in one output (measured 2.7e-5)
TOL = {"float32": 1e-6, "bfloat16": 2.5e-4}


@pytest.mark.parametrize("aggregation", ["sum", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_homography_adaptation_matches_jax(small, aggregation, dtype):
    model, variables, port = small
    B, shape = 2, (24, 32)
    kw = dict(num=6, chunk=2, aggregation=aggregation, compute_dtype=dtype,
              valid_border_margin=2)
    jcfg = JaxHAConfig.from_dict({**kw, "params": HA_PARAMS})
    tcfg = HAConfig.from_dict({**kw, "params": HA_PARAMS})
    img = _images(B, *shape)
    key = jax.random.PRNGKey(35)
    want = np.asarray(jax_ha(jexport.make_prob_fn(model, variables),
                             jnp.asarray(img), key, jcfg))
    Hs = torch.from_numpy(_jax_homographies(key, B, shape, jcfg))
    got = homography_adaptation(texport.make_prob_fn(port),
                                torch.from_numpy(img), Hs, tcfg).numpy()
    assert got.shape == (B,) + shape
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    assert np.mean(np.abs(got - want) > TOL[dtype] / 10) < 0.05
    assert want.max() > 0.01


def test_homography_adaptation_rejects_wrong_homography_count(small):
    port = small[2]
    with pytest.raises(ValueError, match="expected"):
        homography_adaptation(texport.make_prob_fn(port),
                              torch.zeros(2, 16, 16, 1),
                              torch.eye(3).expand(2, 3, 3, 3),
                              HAConfig(num=5))


def test_homography_adaptation_warp_impl_names_one_kernel(small,
                                                          monkeypatch):
    """Both ``warp_impl`` names send the bf16 warps to the kernel's
    wrapper (two per chunk, given H^-1) with the same result; another
    name raises."""
    port = small[2]
    img = torch.from_numpy(_images(2, 24, 32))
    Hs = image_homographies(0, [0, 1], 3, (24, 32), HAConfig().params)
    calls = []
    wrapper = tha.warp_by_inverse

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(tha, "warp_by_inverse", counted)
    outs = [homography_adaptation(texport.make_prob_fn(port), img, Hs,
                                  HAConfig(num=4, chunk=2, warp_impl=impl))
            for impl in ("pallas", "matmul")]
    assert torch.equal(*outs)
    # 3 views in chunks of 2 and 1, for 2 images
    assert calls == [(4, 3, 3)] * 2 + [(2, 3, 3)] * 2 + [(4, 3, 3)] * 2 + \
        [(2, 3, 3)] * 2
    with pytest.raises(ValueError, match="warp_impl"):
        homography_adaptation(texport.make_prob_fn(port), img, Hs,
                              HAConfig(num=4, chunk=2, warp_impl="xla"))


def test_fast_prob_fn_close_to_jax(small):
    """BN-folded bf16 forwards of the two frameworks within 2e-4 on
    probabilities near 1/65 (measured 4.4e-5): bf16 rounds at other
    places in each, flax after the conv and again after the bias,
    PyTorch once after both."""
    model, variables, port = small
    img = _images(2)
    want = np.asarray(jexport.make_prob_fn(model, variables, fast=True)(
        jnp.asarray(img)))
    got = texport.make_prob_fn(port, fast=True)(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


# -------------------------------------------------------------- export


def _config(batch_size, num=4, **export):
    return {
        "data": {"experiment_name": "ha", "batch_size": batch_size},
        "model": {"detector_head": {"nms": 4, "det_thresh": 0.001,
                                    "top_k": 0}},
        "homography_adaptation": {"num": num, "chunk": 2,
                                  "params": HA_PARAMS},
        "export": export,
    }


def _batches(images, b):
    names = [f"img{i}" for i in range(len(images))]
    return [{"image": images[i:i + b], "name": names[i:i + b]}
            for i in range(0, len(images), b)]


def _run(monkeypatch, root, fn, *args, **kw):
    monkeypatch.setattr(texport, "EXPER_PATH", root)
    out_dir = fn(*args, **kw)
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.npy"))}


def test_export_without_ha_matches_jax(small, tmp_path, monkeypatch):
    """float32 forwards: equal .npy files."""
    model, variables, port = small
    images = _images(3)
    monkeypatch.setattr(jexport, "EXPER_PATH", tmp_path / "jax")
    jdir = jexport.export_pseudo_labels(
        _config(2, topk_cap=500), model, variables, _batches(images, 2),
        enable_ha=False,
        fast=False)
    want = {p.name: p.read_bytes() for p in sorted(jdir.glob("*.npy"))}
    got = _run(monkeypatch, tmp_path / "port", texport.export_pseudo_labels,
               _config(2, topk_cap=500), port, _batches(images, 2),
               enable_ha=False,
               fast=False, device="cpu")
    assert set(got) == set(want) and len(got) == 3
    for name in want:
        assert got[name] == want[name], name
        pts = np.load(tmp_path / "port/outputs/ha/training" / name)
        assert pts.dtype == np.int64 and pts.shape[1] == 2 and len(pts) > 0


def test_ha_export_batch_size_invariant(small, tmp_path, monkeypatch):
    """Batch 2 and batch 3 write byte-identical files: views depend only
    on (seed, global image index), and padding is dropped."""
    port = small[2]
    images = _images(5)
    outs = {}
    for b in (2, 3):
        outs[b] = _run(monkeypatch, tmp_path / f"b{b}",
                       texport.export_pseudo_labels, _config(b), port,
                       _batches(images, b), seed=7, device="cpu")
    assert len(outs[2]) == 5 and outs[2] == outs[3]


def test_ha_export_resumes_and_skips_existing(small, tmp_path, monkeypatch):
    port = small[2]
    images = _images(3)
    args = (_config(2), port)
    first = _run(monkeypatch, tmp_path, texport.export_pseudo_labels, *args,
                 _batches(images, 2), seed=3, device="cpu")
    out = tmp_path / "outputs/ha/training"
    (out / "img0.npy").unlink()
    np.save(out / "img1.npy", np.zeros((1, 2), np.int64))  # must survive
    again = _run(monkeypatch, tmp_path, texport.export_pseudo_labels, *args,
                 _batches(images, 2), seed=3, device="cpu")
    assert again["img0.npy"] == first["img0.npy"]
    assert again["img2.npy"] == first["img2.npy"]
    assert np.load(out / "img1.npy").tolist() == [[0, 0]]


def test_ha_export_int8_serving_route(tmp_path, monkeypatch):
    """``export.serving: int8`` at full width through the port's
    DataLoader (calibration closes its first iterator)."""
    model = init_superpoint(0, SuperPointConfig(model_name="magicpoint"),
                            device="cpu")
    data = [{"image": im, "name": f"s{i}"}
            for i, im in enumerate(_images(3, 32, 48))]
    loader = DataLoader(data, 2, drop_last=False)
    got = _run(monkeypatch, tmp_path, texport.export_pseudo_labels,
               _config(2, num=3, serving="int8"), model, loader,
               device="cpu")
    assert sorted(got) == ["s0.npy", "s1.npy", "s2.npy"]
    for name in got:
        pts = np.load(tmp_path / "outputs/ha/training" / name)
        assert pts.dtype == np.int64 and len(pts) > 0
        assert (pts >= 0).all() and (pts < [32, 48]).all()


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_ha_export_bf16_and_mixed_serving_routes(tmp_path, monkeypatch,
                                                 mode):
    """``export.serving: mixed`` and ``bf16`` end to end at full width:
    the labels are those of HA over the port's own
    ``make_prob_fn(serving=...)`` heatmaps, with the same views, NMS and
    threshold."""
    model = init_superpoint(0, SuperPointConfig(model_name="magicpoint"),
                            device="cpu")
    with torch.no_grad():  # spread the probabilities away from 1/65
        model.detector["convPb"].Conv_0.weight.mul_(10.0)
    images = _images(3, 32, 48)
    config = _config(3, num=3, serving=mode)
    got = _run(monkeypatch, tmp_path, texport.export_pseudo_labels, config,
               model, _batches(images, 3), seed=5, device="cpu")
    # the same pipeline by hand: uint8 images, the graph calibrated on the
    # batch, the views of (seed, image index)
    x = torch.from_numpy(np.rint(images * 255.0).astype(np.uint8)).float()
    x = x * (1.0 / 255.0)
    sp = ServingSuperPoint.build(model.config, model,
                                 torch.from_numpy(images), mode=mode,
                                 device="cpu")
    ha_cfg = HAConfig.from_dict(config["homography_adaptation"])
    homs = image_homographies(5, range(3), ha_cfg.num - 1, (32, 48),
                              ha_cfg.params)
    prob = homography_adaptation(texport.make_prob_fn(model, serving=sp), x,
                                 homs, ha_cfg)
    pn = tnms.box_nms(prob, size=4, iou=0.1, min_prob=0.001)
    assert sorted(got) == ["img0.npy", "img1.npy", "img2.npy"]
    for i in range(3):
        pts = np.load(tmp_path / f"outputs/ha/training/img{i}.npy")
        want = {tuple(p) for p in pn[i].nonzero().tolist()}
        assert pts.dtype == np.int64 and len(pts) > 0
        assert {tuple(p) for p in pts.tolist()} == want


def test_loader_batches_and_closes_its_thread():
    import threading

    data = [{"x": np.full((2,), i), "meta": {"i": i}} for i in range(5)]
    loader = DataLoader(data, 2, drop_last=False)
    batches = list(loader)
    assert [b["x"][:, 0].tolist() for b in batches] == [[0, 1], [2, 3], [4]]
    assert batches[0]["meta"]["i"].tolist() == [0, 1]
    assert collate(data[:2])["x"].shape == (2, 2)
    before = threading.active_count()
    it = iter(DataLoader(data, 1, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before
