"""``ops/nerf_label_fusion.py`` and ``tasks/export_nerf.py`` of the port
against ``spnerf_tpu`` on the CPU.

The splat and the fusion are equal to JAX's, a point that reprojects to
NaN included: XLA converts NaN to int 0, so the reference splats such a
point's centre value at pixel (0, 0), and the port does the same
(``geometry.reprojection.float_to_int32``). The label export from the
demo MagicPoint over the procedural scene of ``chip_smoke.box_room`` at
48 x 64 writes equal files on both packages.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from spnerf_tpu.ops import nerf_label_fusion as jf
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.models.superpoint import SuperPointConfig, init_superpoint
from spnerf_tpu_torch.ops import nerf_label_fusion as tf
from spnerf_tpu_torch.tasks import export_nerf as te
from spnerf_tpu_torch.tasks.nerf_task import write_scene
from spnerf_tpu_torch.tasks.train_task import restore_pretrained

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo" / "pretrained" / "demo_mp_5000.ckpt"


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _splat_case(rng, F, H, W, K):
    probs = rng.uniform(0, 1, (F, H, W)).astype(np.float32)
    src = rng.integers(0, [H, W], (F, K, 2)).astype(np.float32)
    dst = rng.uniform(-3, [H + 3, W + 3], (F, K, 2)).astype(np.float32)
    # borders on either side, overlapping splats, and a NaN reprojection
    src[0, :6] = [[0, 0], [1, 5], [H - 1, 7], [9, W - 2], [9, 9], [9, 9]]
    dst[0, :6] = [[5, 5], [6, 6], [20, 20], [1.5, 12], [30, 30], [30.5, 31]]
    dst[1, 0] = [np.nan, np.nan]
    dst[1, 1] = [np.inf, 4.0]
    mask = rng.uniform(size=(F, K)) < 0.8
    mask[:2, :6] = True
    return probs, src, dst, mask


def test_splat_equals_jax():
    rng = np.random.default_rng(0)
    F, H, W, K = 3, 48, 64, 40
    probs, src, dst, mask = _splat_case(rng, F, H, W, K)
    got = tf.splat_reprojected_points(*_t(probs, src, dst, mask)).numpy()
    for f in range(F):
        want = jf.splat_reprojected_points(
            jnp.asarray(probs[f]), jnp.asarray(src[f]), jnp.asarray(dst[f]),
            jnp.asarray(mask[f]))
        np.testing.assert_array_equal(got[f], np.asarray(want))
    # the NaN point of frame 1 puts its source's centre value at (0, 0)
    sy, sx = src[1, 0].astype(int)
    assert got[1, 0, 0] >= probs[1, sy, sx] > 0


def test_splat_reference_cases():
    """``tests/test_ha_and_fusion.py``'s splat cases on the port."""
    prob = torch.zeros((1, 16, 16))
    prob[0, 8, 8], prob[0, 7, 8] = 0.9, 0.2
    out = tf.splat_reprojected_points(prob, torch.tensor([[[8.0, 8.0]]]),
                                      torch.tensor([[[4.0, 4.0]]]),
                                      torch.tensor([[True]]))[0]
    assert out[4, 4] == pytest.approx(0.9) and out[3, 4] == pytest.approx(0.2)
    assert float(out.sum()) == pytest.approx(1.1, abs=1e-5)
    border = torch.zeros((1, 16, 16))
    border[0, 1, 1] = 0.7
    out = tf.splat_reprojected_points(border, torch.tensor([[[1.0, 1.0]]]),
                                      torch.tensor([[[5.0, 5.0]]]),
                                      torch.tensor([[True]]))[0]
    assert out[5, 5] == pytest.approx(0.7) and int((out > 0).sum()) == 1


def _fusion_case(rng, F, H, W, K):
    probs = rng.uniform(0, 0.2, (F, H, W)).astype(np.float32)
    pts = rng.integers(0, [H, W], (F, K, 2)).astype(np.int32)
    mask = rng.uniform(size=(F, K)) < 0.9
    depths = rng.uniform(2.0, 2.02, (F, H, W)).astype(np.float32)
    depths[:, 10:20, 10:30] += 1.0
    Ks = np.tile(np.array([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]],
                          np.float32), (F, 1, 1))
    angles = rng.uniform(-0.15, 0.15, F)
    Rs = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]] for a in angles]).astype(
        np.float32)
    ts = rng.normal(0, 0.1, (F, 3, 1)).astype(np.float32)
    # frame 3's camera centre is frame 0's and its depth is 0 under its
    # first point: that point reprojects into frame 0 as 0 / 0 (the same
    # rotation too would put every other point on an integer, where the
    # floor is rounding's choice)
    ts[3] = ts[0]
    depths[3] = np.where(np.arange(W)[None] < W // 2, 0.0, depths[3])
    pts[3, 0], mask[3, 0] = (10, 12), True
    return probs, pts, mask, depths, Ks, Rs, ts


@pytest.mark.parametrize("target", [0, 2])
def test_fuse_equals_jax(target):
    rng = np.random.default_rng(1)
    F, H, W, K = 5, 48, 64, 60
    case = _fusion_case(rng, F, H, W, K)
    selected = np.array([True, True, False, True, True])
    got = tf.fuse_nerf_labels(*_t(*case), target, torch.from_numpy(selected))
    want = jf.fuse_nerf_labels(*map(jnp.asarray, case), jnp.asarray(target),
                               jnp.asarray(selected))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    if target == 0:  # the 0 / 0 point of frame 3 splats at (0, 0)
        probs = case[0]
        assert got[0, 0] * 4 >= probs[3, 10, 12]


def test_fuse_identity_cameras():
    """``tests/test_ha_and_fusion.py:68`` on the port: identical cameras,
    detections reproject onto themselves and average over 3 views."""
    F, H, W = 3, 32, 32
    probs = torch.zeros((F, H, W))
    probs[1, 16, 16], probs[2, 10, 10] = 0.8, 0.6
    pts = torch.zeros((F, 4, 2))
    mask = torch.zeros((F, 4), dtype=torch.bool)
    pts[1, 0], pts[2, 0] = torch.tensor([16.0, 16.0]), torch.tensor([10.0, 10.0])
    mask[1, 0] = mask[2, 0] = True
    K = torch.tensor([[20.0, 0, 16.0], [0, 20.0, 16.0], [0, 0, 1.0]]).expand(
        F, 3, 3)
    fused = tf.fuse_nerf_labels(probs, pts, mask, torch.full((F, H, W), 2.0),
                                K, torch.eye(3).expand(F, 3, 3),
                                torch.zeros((F, 3, 1)), 0,
                                torch.tensor([False, True, True]))
    assert float(fused[16, 16]) == pytest.approx(0.8 / 3, abs=1e-4)
    assert float(fused[10, 10]) == pytest.approx(0.6 / 3, abs=1e-4)


def test_fusion_subset_draws_as_jax():
    """The subsets come from the same numpy stream in the same order."""
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for F in (16, 5, 2, 1):
        for j in range(F):
            got = te.fusion_subset(a, F, j)
            others = [k for k in range(F) if k != j]
            chosen = b.choice(others, size=max(1, int(0.75 * len(others))),
                              replace=False) if others else []
            want = np.zeros(F, bool)
            want[list(chosen)] = True
            np.testing.assert_array_equal(got, want)


EXPORT_SHAPE = (48, 64)


def _export_config(smoke):
    config = {**smoke.NERF_EXPORT_CONFIG, **smoke.NERF_EXPORT_CUTS}
    config["data"] = dict(config["data"], data_dir="Room",
                          experiment_name="MP_NeRF_v1/Room")
    return config


def test_export_nerf_labels_equal_jax(tmp_path, monkeypatch):
    from spnerf_tpu.data import nerf_dataset as jds
    from spnerf_tpu.models.superpoint import SuperPoint as JaxSuperPoint
    from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
    from spnerf_tpu.tasks import export_nerf as jexport

    smoke = chip_smoke()
    for mod, names in ((settings, ("DATA_PATH", "EXPER_PATH")),
                       (jds, ("DATA_PATH", "EXPER_PATH")),
                       (jexport, ("EXPER_PATH",))):
        for name in names:
            monkeypatch.setattr(mod, name, tmp_path / name.lower())
    scene = smoke.box_room(3, shape=EXPORT_SHAPE)
    write_scene("Room", scene["rgb"], scene["depth"], scene["poses"],
                scene["splits"])
    config = _export_config(smoke)
    det = config["model"]["detector_head"]

    monkeypatch.setattr(settings, "CKPT_PATH", ROOT / "demo")
    model = init_superpoint(0, SuperPointConfig.from_dict(config["model"]),
                            device="cpu")
    restore_pretrained(config, model)
    data = serialization.msgpack_restore(DEMO.read_bytes())
    jmodel = JaxSuperPoint(JaxConfig(model_name="magicpoint", nms=det["nms"],
                                     det_thresh=det["det_thresh"]))
    variables = {"params": data["params"], "batch_stats": data["batch_stats"]}

    for split in ("training", "validation"):
        got_dir = te.export_nerf_labels(config, model, seed=4, split=split,
                                        device="cpu")
        labels = {p.name: np.load(p) for p in sorted(got_dir.glob("*.npy"))}
        for p in got_dir.glob("*.npy"):
            p.unlink()
        want_dir = jexport.export_nerf_labels(config, jmodel, variables,
                                              seed=4, split=split)
        assert want_dir == got_dir
        want = {p.name: np.load(p) for p in sorted(want_dir.glob("*.npy"))}
        assert sorted(labels) == sorted(want)
        assert len(labels) == len(scene["splits"][split])
        for name, pts in want.items():
            assert labels[name].dtype == np.int64 and labels[name].shape[1] == 2
            np.testing.assert_array_equal(labels[name], pts, err_msg=name)
        assert sum(len(v) for v in want.values()) > 2 * len(want)
    # a frame whose file exists is skipped
    first = sorted(got_dir.glob("*.npy"))[0]
    np.save(first, np.zeros((0, 2), np.int64))
    te.export_nerf_labels(config, model, seed=4, split="validation",
                          device="cpu")
    assert np.load(first).shape == (0, 2)
