"""The port's ORB (``eval/orb.py`` over ``native/cv_orb.cpp``) against
cv2 5.0 (opencv-python), and the pose table's ORB row
(``demo/pose_baseline_classical.py --feature orb``) against the reference
tool (``tools/pose_baseline_classical.py``) through the JAX package's pose
evaluation.

Images: five GT test views of the demo's scene 0 (``tests/_pose_gt.py``,
240 x 320), random textures at 240 x 320 and 480 x 640, an odd 37 x 53
texture, a flat image and a wide sample of random textures. On each, the
keypoints equal cv2's in count, order, level, position, size, angle and
response, bit for bit, and the descriptors byte for byte. The pyramid's
``INTER_LINEAR_EXACT`` resize and the descriptor's blur are also held
against cv2 alone, the blur through a ``cv2.UMat`` sub-matrix of a
bordered buffer, which takes cv2's sub-matrix path as ORB's pyramid does.
"""

import importlib.util
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from _pose_gt import write_gt_tree
from spnerf_tpu.eval import pose as jpose
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.demo import pose_baseline_classical
from spnerf_tpu_torch.eval import orb
from spnerf_tpu_torch.tools import orb_pattern
from spnerf_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
N_VIEWS = 5


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "pose_baseline_classical_ref",
        ROOT / "tools" / "pose_baseline_classical.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    return write_gt_tree(tmp_path_factory.mktemp("orb_gt") / "data",
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


def cv2_orb(img, nfeatures):
    kps, desc = cv2.ORB_create(nfeatures).detectAndCompute(img, None)
    return {"pt": np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            "size": np.array([k.size for k in kps], np.float32),
            "angle": np.array([k.angle for k in kps], np.float32),
            "response": np.array([k.response for k in kps], np.float32),
            "octave": np.array([k.octave for k in kps], np.int32),
            "desc": np.zeros((0, 32), np.uint8) if desc is None else desc}


def assert_equal_to_cv2(got: orb.Orb, want: dict, name: str):
    assert len(got) == len(want["size"]), name
    for key in ("pt", "size", "angle", "response", "octave"):
        np.testing.assert_array_equal(getattr(got, key), want[key],
                                      err_msg=f"{name} {key}")
    assert got.desc.dtype == np.uint8 and got.desc.shape == (len(got), 32)
    np.testing.assert_array_equal(got.desc, want["desc"], err_msg=name)


@pytest.mark.parametrize("name", ["texture240", "texture480", "odd37x53",
                                  "flat"])
def test_orb_matches_cv2_on_textures(name):
    img = textures()[name]
    got = orb.orb(img, 1024)
    assert_equal_to_cv2(got, cv2_orb(img, 1024), name)
    if name in ("odd37x53", "flat"):  # too small / no corner
        assert len(got) == 0
    else:
        assert len(got) > 100
        assert len(set(got.octave.tolist())) >= 6  # most levels take part


@pytest.mark.parametrize("nfeatures", [1, 100, 500, 5000])
def test_orb_budget_matches_cv2(nfeatures):
    """Other budgets cut the levels elsewhere (``retainBest``'s ties)."""
    img = textures()["texture480"]
    assert_equal_to_cv2(orb.orb(img, nfeatures), cv2_orb(img, nfeatures),
                        f"nfeatures={nfeatures}")


def test_orb_matches_cv2_on_gt_views(gt_tree):
    _, views, _ = gt_tree
    counts = []
    for i, img in enumerate(views):
        got = orb.orb(img, 1024)
        assert_equal_to_cv2(got, cv2_orb(img, 1024), f"GT view {i}")
        counts.append(len(got))
    assert min(counts) > 50, counts


def test_orb_wide_sample_matches_cv2():
    """16 random textures of 60-500 x 60-660 px, blurred 0.6-4 px (a
    third of them nearest-resized, a fifth quantised): every keypoint and
    descriptor equal."""
    rng = np.random.default_rng(5)
    n_kp = 0
    for k in range(16):
        h, w = int(rng.integers(60, 500)), int(rng.integers(60, 660))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.6, 4)))
        if k % 3 == 0:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
        if k % 5 == 0:
            img = (img // 16 * 16).astype(np.uint8)
        assert_equal_to_cv2(orb.orb(img, 1024), cv2_orb(img, 1024),
                            f"texture {k} ({h}x{w})")
        n_kp += len(orb.orb(img, 1024))
    assert n_kp > 2000, n_kp


def test_resize_linear_exact_matches_cv2():
    rng = np.random.default_rng(3)
    for t in range(120):
        h, w = int(rng.integers(1, 160)), int(rng.integers(1, 160))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if t % 3 == 0:  # a pyramid step
            size = (max(1, round(w / 1.2)), max(1, round(h / 1.2)))
        elif t % 3 == 1 and h > 1 and w > 1:  # an exact halving
            img = img[:h // 2 * 2, :w // 2 * 2].copy()
            size = (w // 2, h // 2)
        else:
            size = (int(rng.integers(1, 160)), int(rng.integers(1, 160)))
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(orb.resize_linear_exact(img, size),
                                      want, err_msg=f"{img.shape} {size}")


def test_pyramid_blur_matches_cv2_submatrix():
    """cv2 blurs a level in place inside its bordered pyramid buffer, a
    sub-matrix with ``BORDER_REFLECT_101`` (not isolated): the float32
    filter path, not the fixed-point one it takes for a whole image.
    ``TIE_PATCHES`` pin where it fuses its sums."""
    cv2.ocl.setUseOpenCL(False)

    def cv2_blur(img):
        h, w = img.shape
        big = cv2.copyMakeBorder(img, 32, 32, 32, 32,
                                 cv2.BORDER_REFLECT_101)
        roi = cv2.UMat(cv2.UMat(big), (32, 32 + h), (32, 32 + w))
        return cv2.GaussianBlur(roi, (7, 7), 2, 2,
                                borderType=cv2.BORDER_REFLECT_101).get()

    rng = np.random.default_rng(1)
    for t in range(40):
        h, w = int(rng.integers(4, 120)), int(rng.integers(4, 140))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if t % 2:
            img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.5, 3)))
        np.testing.assert_array_equal(orb.pyramid_blur(img), cv2_blur(img),
                                      err_msg=f"{h}x{w}")
    whole = cv2.GaussianBlur(img, (7, 7), 2, 2,
                             borderType=cv2.BORDER_REFLECT_101)
    assert not np.array_equal(whole, cv2_blur(img))  # the two paths differ
    for patch, x in TIE_PATCHES:
        img = np.full((20, 103), 100, np.uint8)
        window = np.asarray(patch, np.uint8)
        img[5:12, x - 3:min(x + 4, 103)] = window[:, :min(7, 106 - x)]
        assert orb.pyramid_blur(img)[8, x] == cv2_blur(img)[8, x], x


# 7 x 7 windows whose float32 sums round to another byte with fma than with
# rounded products (the first in the row pass, the second in the column
# pass, the third in both tails), placed at a column of the row pass's
# AVX2 part (40), of its tail and the column pass's fused part (97), and of
# both tails (101; its window reads the reflected columns 102 -> 100 and
# 103 -> 99, which each patch repeats)
TIE_WINDOWS = [
    [[27, 88, 105, 181, 252, 181, 105], [83, 179, 88, 77, 153, 77, 88],
     [72, 213, 70, 9, 110, 9, 70], [195, 252, 172, 156, 129, 156, 172],
     [154, 153, 121, 178, 64, 178, 121], [171, 170, 73, 98, 113, 98, 73],
     [240, 241, 153, 34, 163, 34, 153]],
    [[15, 9, 46, 108, 166, 108, 46], [147, 163, 37, 236, 170, 236, 37],
     [24, 46, 24, 202, 191, 202, 24], [47, 27, 136, 164, 232, 164, 136],
     [67, 9, 103, 54, 156, 54, 103], [221, 159, 119, 11, 69, 11, 119],
     [224, 248, 46, 164, 110, 164, 46]],
    [[44, 113, 54, 109, 187, 109, 54], [66, 165, 168, 236, 50, 236, 168],
     [129, 179, 91, 98, 107, 98, 91], [29, 110, 35, 114, 125, 114, 35],
     [96, 3, 13, 76, 237, 76, 13], [179, 205, 133, 8, 132, 8, 133],
     [254, 162, 26, 126, 94, 126, 26]],
]
TIE_PATCHES = [(w, x) for w in TIE_WINDOWS for x in (40, 97, 101)]


def test_pattern_equals_cv2_library():
    """The compiled table against the 1,024 int32 at the only occurrence
    of its prefix in cv2's own library."""
    table = orb_pattern.read_table(orb_pattern.cv2_library())
    np.testing.assert_array_equal(orb.pattern(), table)
    assert orb_pattern.main([]) == 0


def test_orb_rejects_bad_input():
    with pytest.raises(ValueError):
        orb.orb(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        orb.orb(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        orb.orb(np.zeros((8, 8), np.uint8), -1)
    for shape in ((1, 1), (1, 100)):  # cv2's resize asserts on them
        with pytest.raises(cv2.error):
            cv2_orb(np.zeros(shape, np.uint8), 500)
        with pytest.raises(ValueError, match="too small"):
            orb.orb(np.zeros(shape, np.uint8))
    for shape in ((2, 2), (3, 100)):
        assert len(orb.orb(np.full(shape, 7, np.uint8))) == 0


def test_build_infer_matches_reference_tool(gt_tree):
    _, views, _ = gt_tree
    ref = reference_tool().build_infer("orb", 1024)
    port = pose_baseline_classical.build_infer("orb", 1024)
    for i, img in enumerate(views[:4]):
        image = img.astype(np.float32)
        want, got = ref(image), port(image)
        np.testing.assert_array_equal(got["prob"], want["prob"],
                                      err_msg=f"view {i}")
        ys, xs = np.nonzero(want["prob"])
        pts = np.stack([ys, xs], -1)
        assert len(pts) > 50
        d = got["desc"](pts)
        assert d.dtype == np.float32 and d.shape[1] == 32
        np.testing.assert_array_equal(d, want["desc"](pts))
        assert got["desc"](pts[:0]).shape == want["desc"](pts[:0]).shape


def test_orb_row_matches_reference(gt_tree, tmp_path, monkeypatch):
    """``--feature orb`` on the GT pairs against the reference tool's
    infer through the JAX package's ``estimate_pose_errors``: every
    number of the row within 1e-6."""
    data, _, lines = gt_tree
    monkeypatch.setattr(settings, "DATA_PATH", data)
    monkeypatch.setattr(jpose, "DATA_PATH", data)
    config_path = ROOT / "spnerf_tpu_torch" / "demo" / "configs" / \
        "pose_demo.yaml"
    out = tmp_path / "evidence" / "pose_auc.jsonl"
    got = pose_baseline_classical.main(["--feature", "orb", "--config-path",
                                        str(config_path), "--json-out",
                                        str(out)])
    assert json.loads(out.read_text()) == got
    assert got["pretrained"] == "baseline/orb"
    pairs = [line.split() for line in lines]
    want = jpose.estimate_pose_errors(load_config(config_path),
                                      reference_tool().build_infer("orb",
                                                                   1024),
                                      pairs)
    assert got["num_pairs"] == want["num_pairs"] == len(pairs)
    for key in ("auc5", "auc10", "auc20", "precision", "matching_score"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    for key, interval in want["ci95"].items():
        np.testing.assert_allclose(got["ci95"][key], interval, rtol=0,
                                   atol=1e-6, err_msg=key)
