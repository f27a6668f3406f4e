"""The port's relative-pose evaluation (``eval/pose.py``) against the
JAX package's (``spnerf_tpu/eval/pose.py``, cv2 inside) on the CPU.

Tolerances: the protocol functions equal the reference's (the same numpy
arithmetic), the RANSAC + pose recovery too (R and t within 1e-9, the
masks equal: the port draws cv2's samples, ``tests/test_torch_essential.
py``). Exactly five matches are left out: they give several Es, whose
order (cv2's ``solvePoly`` against the companion matrix) decides between
candidates of equal support. ``load_gray`` equals the reference's ``cv2.imread`` + ``cv2.resize``
on PNGs of odd sizes at every rotation: exactly on the uint8 resize,
within 4e-5 on the float32 one (3.1e-5 measured; ``data/resize.py``).
Over posed pairs of a small box room, with one narrow checkpoint the
JAX package writes and both read: the inference as the reference's
(heatmaps and descriptors within 1e-5, the same keypoints, the mutual
matches equal but for near-ties, as ``tests/test_torch_cli.py`` holds
them), and on the same inference outputs the port's evaluation loop and
entry point (``main``, on the CPU) give the reference loop's results: AUCs,
precision, matching score and their intervals equal. (A near-tie that
flips one match changes the RANSAC's input and so its draws: the loops
are held on one side's matches.)
"""

import functools
import importlib.util
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port import flax_superpoint
from spnerf_tpu.eval import pose as jpose
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.tasks import train_task as jtrain
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.eval import pose as tpose
from spnerf_tpu_torch.utils.config import apply_overrides, load_config

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (96, 128)
SCENE = "PoseRoom"
NARROW = {"model.vgg_cn": "[8,8,8,8,16,16,16,16]",
          "model.detector_head.detector_dim": "[16,32]",
          "model.descriptor_head.descriptor_dim": "[16,32]",
          "model.detector_head.top_k": "300",
          "data.resize": f"[{SHAPE[1]},{SHAPE[0]}]",
          "data.images_path": SCENE,
          "data.gt_pairs": f"{SCENE}/pairs.txt",
          "pretrained": "narrow/narrow_0.ckpt"}
SETS = [a for k, v in NARROW.items() for a in ("--set", f"{k}={v}")]


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _golden_setup():
    """The inputs of ``tests/test_pose.py``'s golden pins."""
    rng = np.random.RandomState(0)
    K0 = np.array([[458.0, 0, 321.0], [0, 460.0, 239.0], [0, 0, 1.0]])
    K1 = np.array([[520.0, 0, 310.0], [0, 515.0, 252.0], [0, 0, 1.0]])
    T = np.eye(4)
    ang = 0.2
    T[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                          [-np.sin(ang), 0, np.cos(ang)]])
    T[:3, 3] = [0.3, -0.1, 0.05]
    return rng.uniform(0, 640, (7, 2)), rng.uniform(0, 480, (7, 2)), K0, K1, T


def _synthetic_pair(seed, n=200, noise=0.5, outliers=0.3):
    """Pixel matches of random points seen by two cameras (the setup of
    ``tests/test_pose.py``) with noise and outliers: (k0, k1, K, T)."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], axis=1)
    angle = rng.uniform(0.05, 0.3)
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, rng.normal(0, 0.3, 3)
    p0, p1 = pts @ K.T, (pts @ R.T + T[:3, 3]) @ K.T
    k0 = p0[:, :2] / p0[:, 2:] + rng.normal(0, noise, (n, 2))
    k1 = p1[:, :2] / p1[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    k1[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    return k0, k1, K, T


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert np.asarray(got).shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (got != got and want != want)


def _protocol_cases():
    k0, k1, K0, K1, T = _golden_setup()
    pk0, pk1, K, T2 = _synthetic_pair(3, noise=0.0, outliers=0.0)
    rng = np.random.default_rng(4)
    prob = np.where(rng.random((64, 64)) < 0.05,
                    rng.uniform(0.01, 1, (64, 64)), 0).astype(np.float32)
    prob[10, 10] = prob[20, 20] = prob[30, 30] = 0.5  # a tie at the cut
    desc = rng.standard_normal((64, 64, 8)).astype(np.float32)
    return {
        "resize_dims": [(640, 480, s) for s in ([320], [-1], [320, 200],
                                               [1000], [333])]
        + [(481, 643, [640])],
        "rescale_K": [(K0, (2.0, 2.0)), (K1, (1.3, 0.7))],
        "_quarter_turn": [(K0, 640, 480), (K1, 481, 643)],
        "rotate_K": [(K, s, r) for K in (K0, K1)
                     for s in ((480, 640), (640, 480)) for r in range(5)],
        "_rz_homogeneous": [(r,) for r in range(5)],
        "rotate_extrinsic": [(T, r) for r in range(5)],
        "_normalized": [(k0, K0), (k1, K1)],
        "_cross_matrix": [(T[:3, 3],), (np.array([1.0, -2.0, 0.5]),)],
        "epipolar_errors": [(k0, k1, T, K0, K1), (pk0, pk1, T2, K, K)],
        "rotation_angle_deg": [(T[:3, :3], T2[:3, :3]),
                               (T[:3, :3], T[:3, :3])],
        "direction_angle_deg": [(T[:3, 3], T2[:3, 3]),
                                (T[:3, 3], -T[:3, 3])],
        "pose_errors_deg": [(T, T2[:3, :3], T2[:3, 3]),
                            (T, T[:3, :3], -T[:3, 3])],
        "error_auc": [([3.0, 7.0, 12.0, 25.0, 1.0], [5, 10, 20]), ([], [5]),
                      ([0.0, 0.0], [5]), ([1.0, np.inf, 4.0], [5, 10])],
        "top_keypoints_with_border": [(prob, 10), (prob, 1000),
                                      (prob, 5, 8)],
        "match_pair": [(prob, prob.T.copy(), desc, desc.transpose(1, 0, 2)),
                       (prob, prob, desc, desc, 7),
                       (prob, np.zeros_like(prob), desc, desc)],
        "bootstrap_ci": [(rng.uniform(0, 30, 12), rng.random(12),
                          rng.random(12), [5, 10, 20]),
                         ([1.0], [0.5], [0.2], [5, 10, 20]),
                         ([np.inf, 2.0, 7.0], [0.1, 0.2, 0.3],
                          [0.0, 0.1, 0.2], [5, 10, 20], 50, 3)],
    }


@pytest.mark.parametrize("name", sorted(_protocol_cases()))
def test_protocol_functions_equal_jax(name):
    for args in _protocol_cases()[name]:
        _equal(getattr(tpose, name)(*args), getattr(jpose, name)(*args))


def test_match_pair_with_sampled_descriptors_equals_jax():
    rng = np.random.default_rng(8)
    prob = np.where(rng.random((48, 64)) < 0.1,
                    rng.uniform(0.01, 1, (48, 64)), 0).astype(np.float32)
    table = rng.standard_normal((48, 64, 16)).astype(np.float32)

    def desc(pts):
        return table[pts[:, 0], pts[:, 1]] * 2.0

    _equal(tpose.match_pair(prob, prob[::-1].copy(), desc, desc, 50),
           jpose.match_pair(prob, prob[::-1].copy(), desc, desc, 50))


@pytest.mark.parametrize("seed", range(6))
def test_recover_relative_pose_equals_jax(seed):
    k0, k1, K, _ = _synthetic_pair(seed)
    want = jpose.recover_relative_pose(k0, k1, K, K, thresh=1.0)
    got = tpose.recover_relative_pose(k0, k1, K, K, thresh=1.0)
    assert got is not None and want is not None
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[2], want[2])


def test_recover_relative_pose_needs_five_matches():
    k0, k1, K, _ = _synthetic_pair(0)
    assert tpose.recover_relative_pose(k0[:4], k1[:4], K, K, 1.0) is None
    assert jpose.recover_relative_pose(k0[:4], k1[:4], K, K, 1.0) is None


def test_recover_pose_distance_is_cv2s_default():
    """The reference's recoverPose call leaves cv2's distance threshold at
    50 (its positional 1e9 lands in the R output): points farther than 50
    baselines do not count, and a pose of a short baseline is lost in both
    packages alike."""
    _, _, K, T = _synthetic_pair(1)
    far = 0.02 * T[:3, 3] / np.linalg.norm(T[:3, 3])  # depths over 200
    assert tpose.RECOVER_POSE_DISTANCE == 50.0
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                    rng.uniform(4, 8, 200)], axis=1)
    p1 = (pts @ T[:3, :3].T + far) @ K.T
    k0 = (pts @ K.T)[:, :2] / (pts @ K.T)[:, 2:]
    k1 = p1[:, :2] / p1[:, 2:]
    assert tpose.recover_relative_pose(k0, k1, K, K, 1.0) is None
    assert jpose.recover_relative_pose(k0, k1, K, K, 1.0) is None


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Gray and RGB PNGs of odd sizes."""
    root = tmp_path_factory.mktemp("gray")
    rng = np.random.default_rng(9)
    paths = []
    for i, (h, w) in enumerate(((37, 53), (61, 47), (90, 120))):
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        path = root / f"g{i}.png"
        png.write_gray(path, img)
        paths.append(path)
    rgb = rng.integers(0, 256, (41, 59, 3)).astype(np.uint8)
    png.write_rgb(root / "c.png", rgb)
    paths.append(root / "c.png")
    return paths


@pytest.mark.parametrize("rotation", range(4))
@pytest.mark.parametrize("resize_float", [False, True])
def test_load_gray_equals_jax(images, rotation, resize_float):
    for path in images:
        for spec in ([80, 60], [64], [-1], [47, 33]):
            got, gs = tpose.load_gray(path, spec, rotation, resize_float)
            want, ws = jpose.load_gray(path, spec, rotation, resize_float)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape and gs == ws
            if resize_float:
                np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)
            else:
                np.testing.assert_array_equal(got, want)


def test_load_gray_missing_and_jpeg(tmp_path):
    """A missing file is (None, None) in both; a JPEG reads as the JAX
    package reads it through cv2; a format cv2 reads and the port does not
    decode raises, and is (None, None) when missing."""
    assert tpose.load_gray(tmp_path / "none.png", [64]) == (None, None)
    assert jpose.load_gray(tmp_path / "none.png", [64]) == (None, None)
    assert tpose.load_gray(tmp_path / "none.jpg", [64]) == (None, None)
    jpg = tmp_path / "a.jpg"
    rng = np.random.default_rng(3)
    cv2.imwrite(str(jpg), cv2.GaussianBlur(
        rng.integers(0, 256, (48, 70, 3), dtype=np.uint8), (5, 5), 0))
    for spec in ([64], [-1], [40, 30]):
        got, got_scale = tpose.load_gray(jpg, spec)
        want, want_scale = jpose.load_gray(jpg, spec)
        np.testing.assert_array_equal(got, want)
        assert got_scale == want_scale
    bmp = tmp_path / "a.bmp"
    cv2.imwrite(str(bmp), np.zeros((8, 8), np.uint8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tpose.load_gray(bmp, [64])
    assert tpose.load_gray(tmp_path / "missing.bmp", [64]) == (None, None)
    assert jpose.load_gray(tmp_path / "missing.bmp", [64]) == (None, None)


def test_build_infer_fn_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    config = apply_overrides(load_config(
        ROOT / "spnerf_tpu_torch/configs/pose_estimation_indoor.yaml"),
        ["pretrained=null"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpose.build_infer_fn(config)


@pytest.fixture(scope="module")
def pose_tree(tmp_path_factory):
    """A box room's frames and pairs (chip_smoke's writer, at 96 x 128,
    six frames, three pairs turned) and the narrow checkpoint the JAX
    package wrote."""
    from flax import serialization

    root = tmp_path_factory.mktemp("pose")
    smoke = _chip_smoke()
    scene = smoke.box_room(3, shape=SHAPE,
                           frames={"training": 6, "validation": 0})
    pairs = smoke.write_pose_pairs(scene, root / "data" / SCENE)
    _, variables = flax_superpoint(
        JaxConfig(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16), detector_dim=(16, 32),
                  descriptor_dim=(16, 32)), (1,) + SHAPE + (1,), seed=46)
    ckpt = root / "ckpt" / "narrow" / "narrow_0.ckpt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(serialization.msgpack_serialize(
        {"iteration": np.asarray(0), **variables}))
    return root, pairs


@pytest.fixture(scope="module")
def pose_models(pose_tree):
    """(config, both packages' inference), built once from the tree's
    checkpoint."""
    root, _ = pose_tree
    config = apply_overrides(load_config(
        ROOT / "spnerf_tpu_torch/configs/pose_estimation_indoor.yaml"),
        SETS[1::2])
    with pytest.MonkeyPatch.context() as mp:
        for mod in (settings, jtrain):
            mp.setattr(mod, "CKPT_PATH", root / "ckpt")
        return (config, jpose.build_infer_fn(config),
                tpose.build_infer_fn(config, "cpu"))


@pytest.fixture
def pose_run(pose_tree, pose_models, monkeypatch):
    """(root, config, the pair lines, the JAX package's and the port's
    inference), both packages' roots on the tree."""
    root, pairs = pose_tree
    for mod in (settings, jpose):
        monkeypatch.setattr(mod, "DATA_PATH", root / "data")
    for mod in (settings, jtrain):
        monkeypatch.setattr(mod, "CKPT_PATH", root / "ckpt")
    lines = [line.split() for line in
             (root / "data" / SCENE / "pairs.txt").read_text().splitlines()]
    assert len(lines) == len(pairs) == 8
    return (root, pose_models[0], lines) + pose_models[1:]


def test_pose_inference_matches_jax(pose_run):
    """``build_infer_fn`` on every image: heatmaps within 1e-5 (5.6e-9
    measured), the same keypoints, descriptors within 1e-5; the mutual
    matches of each pair equal but for near-ties."""
    root, config, lines, jinfer, tinfer = pose_run
    top_k = config["model"]["detector_head"]["top_k"]
    for line in lines:
        outs = []
        for name, rot in ((line[0], int(line[2])), (line[1], int(line[3]))):
            image, _ = tpose.load_gray(root / "data" / SCENE / name,
                                       config["data"]["resize"], rot)
            got, want = tinfer(image), jinfer(image)
            np.testing.assert_allclose(got["prob"], want["prob"], rtol=0,
                                       atol=1e-5)
            kpts = tpose.top_keypoints_with_border(want["prob"], top_k)
            assert {tuple(p) for p in kpts} == {tuple(p) for p in
                                                tpose.top_keypoints_with_border(
                                                    got["prob"], top_k)}
            d_port, d_jax = got["desc"](kpts), want["desc"](kpts)
            np.testing.assert_allclose(d_port, d_jax, rtol=0, atol=1e-5)
            outs.append((d_port, d_jax))
        (p0, j0), (p1, j1) = outs
        got = np.stack(tpose.mutual_nn_match(p0, p1), -1)
        want = np.stack(tpose.mutual_nn_match(j0, j1), -1)
        _chip_smoke()._near_tie_flips(got, want, j0, j1)


def test_pose_evaluation_matches_jax(pose_run, capsys):
    """The port's evaluation loop and entry point against the reference's
    on the same inference outputs (the port's, on the CPU), pair by pair
    and in the aggregate: every result equal."""
    root, config, lines, _, tinfer = pose_run
    for line in lines:
        got = tpose.estimate_pose_errors(config, tinfer, [line])
        want = jpose.estimate_pose_errors(config, tinfer, [line])
        assert got == want, line[:4]
    want = jpose.estimate_pose_errors(config, tinfer, lines)
    assert want["num_pairs"] == 8 and want["ci95"]
    out = root / "runs" / "pose.jsonl"
    for _ in range(2):  # appends
        got = tpose.main(["--config-path", str(
            ROOT / "spnerf_tpu_torch/configs/pose_estimation_indoor.yaml"),
            "--device", "cpu", "--json-out", str(out)] + SETS)
    assert got == dict(want, pretrained="narrow/narrow_0.ckpt")
    records = [json.loads(r) for r in out.read_text().splitlines()]
    assert len(records) == 2 and records[0] == json.loads(json.dumps(got))
    assert "AUC@5" in capsys.readouterr().out
    shuffled = tpose.read_pairs(config, max_length=3, shuffle=True)
    import random

    random.Random(0).shuffle(lines)
    assert shuffled == lines[:3]
