"""The port's SIFT (``eval/sift.py`` over ``native/cv_sift.cpp``) against
this host's cv2 5.0, and the pose table's SIFT row
(``demo/pose_baseline_classical.py``) against the reference tool
(``tools/pose_baseline_classical.py``) through the JAX package's pose
evaluation.

Images: five GT test views of the demo's scene 0 (the scene rebuilt and
ray-traced as ``demo/gt_test_views.py`` does, 240 x 320), random
textures at 240 x 320 and 480 x 640, an odd 37 x 53 texture and a flat
image. On each, the keypoints equal cv2's in count, order, octave word,
position, size and response, bit for bit, and the descriptors equal
cv2's; the angles agree within ``ANGLE_TOL`` degrees: cv2 computes the
orientation histogram's weights and magnitudes with IPP (``hal::exp32f``,
``hal::magnitude32f``), the port with OpenCV's own kernels, and the two
differ in the last float32 bits of the angle (3.8e-5 degrees at most on
these images, 9.9e-5 on the wide sample below; ROADMAP Queue 3).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from spnerf_tpu.eval import pose as jpose
from _pose_gt import write_gt_tree
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.demo import pose_baseline_classical
from spnerf_tpu_torch.eval import sift
from spnerf_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
N_VIEWS = 5
ANGLE_TOL = 4e-5  # degrees, the measured 3.8e-5 pinned (1e-2 accepted)
WIDE_ANGLE_TOL = 1e-4  # the wide sample's measured 9.9e-5


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "pose_baseline_classical_ref",
        ROOT / "tools" / "pose_baseline_classical.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    """DATA_PATH with the demo's scene 0 GT test views 0-4 and their
    pose pairs (``tests/_pose_gt.py``)."""
    return write_gt_tree(tmp_path_factory.mktemp("sift_gt") / "data",
                         N_VIEWS)


def textures():
    rng = np.random.default_rng(0)
    return {
        "texture240": cv2.GaussianBlur(
            rng.integers(0, 256, (240, 320)).astype(np.uint8), (0, 0), 2.0),
        "texture480": cv2.GaussianBlur(
            rng.integers(0, 256, (480, 640)).astype(np.uint8), (0, 0), 1.5),
        "odd37x53": cv2.GaussianBlur(
            rng.integers(0, 256, (37, 53)).astype(np.uint8), (0, 0), 1.0),
        "flat": np.full((60, 80), 128, np.uint8),
    }


def cv2_sift(img, nfeatures):
    kps, desc = cv2.SIFT_create(nfeatures=nfeatures).detectAndCompute(
        img, None)
    return {"pt": np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            "size": np.array([k.size for k in kps], np.float32),
            "angle": np.array([k.angle for k in kps], np.float32),
            "response": np.array([k.response for k in kps], np.float32),
            "octave": np.array([k.octave for k in kps], np.int32),
            "desc": np.zeros((0, 128), np.float32) if desc is None else desc}


def assert_equal_to_cv2(got: sift.Sift, want: dict, name: str):
    assert len(got) == len(want["size"]), name
    for key in ("pt", "size", "response", "octave"):
        np.testing.assert_array_equal(getattr(got, key), want[key],
                                      err_msg=f"{name} {key}")
    diff = np.abs(got.angle - want["angle"])
    diff = np.minimum(diff, 360 - diff)
    assert diff.max(initial=0) <= ANGLE_TOL, (name, diff.max())
    assert got.desc.dtype == np.float32
    np.testing.assert_array_equal(got.desc, want["desc"], err_msg=name)


@pytest.mark.parametrize("name", ["texture240", "texture480", "odd37x53",
                                  "flat"])
def test_sift_matches_cv2_on_textures(name):
    img = textures()[name]
    got = sift.sift(img, 1024)
    assert_equal_to_cv2(got, cv2_sift(img, 1024), name)
    if name == "flat":
        assert len(got) == 0 and got.desc.shape == (0, 128)
    if name == "texture480":  # more than 1,024 found: retainBest's cut
        assert len(got) >= 1024


def test_sift_matches_cv2_on_gt_views(gt_tree):
    _, views, _ = gt_tree
    counts = []
    for i, img in enumerate(views[:4]):
        got = sift.sift(img, 1024)
        assert_equal_to_cv2(got, cv2_sift(img, 1024), f"GT view {i}")
        counts.append(len(got))
    assert min(counts) > 50, counts


def test_sift_wide_sample_within_pinned_bounds():
    """12 random textures of 20-500 x 20-660 px, blurred 0.6-4 px (a
    third of them nearest-resized), at ``nfeatures`` 0: counts, order,
    positions, sizes and octave words equal cv2's; a response may be one
    float32 ulp off (6 of the 5,431 keypoints: the port's contraction of
    the refinement's 3 x 3 solve and dot product misses cv2's build on
    those, ROADMAP Queue 3); angles within ``WIDE_ANGLE_TOL``; a descriptor
    entry at most one level off (1 keypoint's row, where the angle
    carries IPP's last bits)."""
    rng = np.random.default_rng(123)
    n_kp = n_resp = n_desc = 0
    for k in range(12):
        h, w = int(rng.integers(20, 500)), int(rng.integers(20, 660))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.6, 4)))
        if k % 3 == 0:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
        got, want = sift.sift(img, 0), cv2_sift(img, 0)
        name = f"texture {k} ({h}x{w})"
        assert len(got) == len(want["size"]), name
        for key in ("pt", "size", "octave"):
            np.testing.assert_array_equal(getattr(got, key), want[key],
                                          err_msg=f"{name} {key}")
        ulps = np.abs(got.response - want["response"]) / np.spacing(
            want["response"])
        assert ulps.max(initial=0) <= 1, name
        diff = np.abs(got.angle - want["angle"])
        assert np.minimum(diff, 360 - diff).max(initial=0) <= WIDE_ANGLE_TOL
        dd = np.abs(got.desc - want["desc"])
        assert dd.max(initial=0) <= 1, name
        n_kp += len(got)
        n_resp += int((ulps > 0).sum())
        n_desc += int((dd > 0).any(1).sum())
    assert n_kp == 5431, n_kp
    assert n_resp <= 6, n_resp
    assert n_desc <= 1, n_desc


def test_sift_all_features_matches_cv2():
    """``nfeatures=0``: every keypoint kept, in the sorted order."""
    img = textures()["texture240"]
    got = sift.sift(img, 0)
    assert_equal_to_cv2(got, cv2_sift(img, 0), "texture240 nfeatures=0")
    assert np.all(np.diff(got.pt[:, 0]) >= 0)


CV2_AVX2 = """
import pickle, sys
import cv2, numpy as np
rng = np.random.default_rng(0)
img = cv2.GaussianBlur(rng.integers(0, 256, (240, 320)).astype(np.uint8),
                       (0, 0), 2.0)
kps, desc = cv2.SIFT_create(nfeatures=1024).detectAndCompute(img, None)
sys.stdout.buffer.write(pickle.dumps((
    np.array([k.pt for k in kps], np.float32),
    np.array([k.response for k in kps], np.float32),
    np.array([k.octave for k in kps], np.int32), desc,
    cv2.getCPUFeaturesLine())))
"""


def test_sift_eight_lanes_matches_cv2_without_avx512():
    """``lanes=8`` against cv2 with its AVX-512 dispatch switched off
    (``OPENCV_CPU_DISABLE``), as it runs on a CPU with AVX2 only."""
    import pickle

    env = dict(os.environ, OPENCV_CPU_DISABLE="AVX512-SKX")
    proc = subprocess.run([sys.executable, "-c", CV2_AVX2], env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    pt, response, octave, desc, features = pickle.loads(proc.stdout)
    assert "AVX512-SKX" not in features.replace("AVX512-SKX?", "")
    got = sift.sift(textures()["texture240"], 1024, lanes=8)
    np.testing.assert_array_equal(got.pt, pt)
    np.testing.assert_array_equal(got.response, response)
    np.testing.assert_array_equal(got.octave, octave)
    np.testing.assert_array_equal(got.desc, desc)


def test_sift_rejects_bad_input():
    with pytest.raises(ValueError):
        sift.sift(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        sift.sift(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        sift.sift(np.zeros((8, 8), np.uint8), lanes=4)
    assert sift.dispatch_lanes() in (8, 16)


def test_build_infer_matches_reference_tool(gt_tree):
    _, views, _ = gt_tree
    ref = reference_tool().build_infer("sift", 1024)
    port = pose_baseline_classical.build_infer("sift", 1024)
    for i, img in enumerate(views[:4]):
        image = img.astype(np.float32)
        want, got = ref(image), port(image)
        np.testing.assert_array_equal(got["prob"], want["prob"],
                                      err_msg=f"view {i}")
        ys, xs = np.nonzero(want["prob"])
        pts = np.stack([ys, xs], -1)
        assert len(pts) > 50
        np.testing.assert_array_equal(got["desc"](pts), want["desc"](pts))
        assert got["desc"](pts[:0]).shape == want["desc"](pts[:0]).shape


def test_orb_is_queued():
    """ORB is ported (``tests/test_torch_orb.py`` holds it against cv2):
    its infer is built, an unknown feature still stops."""
    assert callable(pose_baseline_classical.build_infer("orb", 1024))
    with pytest.raises(SystemExit, match="unknown feature"):
        pose_baseline_classical.build_infer("surf", 1024)


def test_sift_row_matches_reference(gt_tree, tmp_path, monkeypatch):
    """The port's tool on the GT pairs against the reference tool's
    infer through the JAX package's ``estimate_pose_errors``: every
    number of the row within 1e-6."""
    data, _, lines = gt_tree
    assert len(lines) == N_VIEWS - 1
    monkeypatch.setattr(settings, "DATA_PATH", data)
    monkeypatch.setattr(jpose, "DATA_PATH", data)
    config_path = ROOT / "spnerf_tpu_torch" / "demo" / "configs" / \
        "pose_demo.yaml"
    out = tmp_path / "evidence" / "pose_auc.jsonl"
    got = pose_baseline_classical.main(["--config-path", str(config_path),
                                        "--json-out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["pretrained"] == "baseline/sift"
    pairs = [line.split() for line in lines]
    want = jpose.estimate_pose_errors(load_config(config_path),
                                      reference_tool().build_infer("sift",
                                                                   1024),
                                      pairs)
    assert got["num_pairs"] == want["num_pairs"] == len(pairs)
    for key in ("auc5", "auc10", "auc20", "precision", "matching_score"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    for key, interval in want["ci95"].items():
        np.testing.assert_allclose(got["ci95"][key], interval, rtol=0,
                                   atol=1e-6, err_msg=key)
    assert got["precision"] > 0
