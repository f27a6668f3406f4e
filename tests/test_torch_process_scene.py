"""The port's scene preprocessing (``spnerf_tpu_torch/tools/
process_scene.py``) and its image readers against cv2 and
``spnerf_tpu/tools/process_scene.py`` on the CPU.

``data/png.read_rgb`` equals ``cv2.imread(path)[:, :, ::-1]`` and
``data/resize.resize_linear`` equals ``cv2.resize(img, (W, H))`` byte for
byte on every tested shape (non-integer up- and downscales, an exact 2x
downscale, 1, 3 and 4 channels). ``main`` runs the ``tiny`` preset on
``device="cpu"`` and writes the layout the port's ``NeRFDataset`` reads.
"""

import json

import cv2
import numpy as np
import pytest

from spnerf_tpu.tools import process_scene as jps
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset
from spnerf_tpu_torch.data.png import read_rgb, write_rgb
from spnerf_tpu_torch.data.resize import resize_linear
from spnerf_tpu_torch.tools import process_scene as tps


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_rgb_equals_cv2(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    path = tmp_path / "im.png"
    if channels == 2:  # gray + alpha, encoded by hand (cv2 writes no LA)
        from test_torch_png import encode
        path.write_bytes(encode(rng.integers(0, 256, shape, np.uint8), 4))
    else:
        assert cv2.imwrite(str(path), rng.integers(0, 256, shape, np.uint8))
    want = cv2.imread(str(path))[:, :, ::-1]
    got = read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    assert np.array_equal(got, want)


def test_write_rgb_reads_back_through_cv2(tmp_path):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (17, 29, 3), np.uint8)
    write_rgb(tmp_path / "im.png", image)
    assert np.array_equal(cv2.imread(str(tmp_path / "im.png"))[:, :, ::-1],
                          image)
    assert np.array_equal(read_rgb(tmp_path / "im.png"), image)
    with pytest.raises(ValueError, match="write_rgb"):
        write_rgb(tmp_path / "x.png", image[..., 0])


def test_read_rgb_names_the_missing_decoder(tmp_path):
    """The PNG reader given a JPEG names what the file is not; the
    signature dispatch (``data/imread.py``) is what reads it."""
    path = tmp_path / "im.jpg"
    assert cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG file"):
        read_rgb(path)


@pytest.mark.parametrize("src,dst,channels", [
    ((48, 64), (32, 48), 3),     # 2/3 down
    ((30, 41), (77, 90), 3),     # non-integer up
    ((37, 53), (20, 31), 1),     # odd down
    ((100, 130), (37, 61), 4),   # RGBA
    ((48, 64), (24, 32), 3),     # exactly 2x: INTER_AREA
    ((481, 641), (240, 320), 3),  # nearly 2x: bilinear
    ((24, 24), (48, 48), 3),     # exactly 2x up
    ((9, 9), (5, 3), 1),         # rows narrower than a vector
    ((60, 80), (60, 80), 3),     # same size: a copy
])
def test_resize_equals_cv2(src, dst, channels):
    rng = np.random.default_rng(sum(src) + sum(dst))
    shape = src if channels == 1 else src + (channels,)
    img = rng.integers(0, 256, shape, np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]))
    got = resize_linear(img, (dst[1], dst[0]))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)


def _scene(root, n=4, shape=(48, 64)):
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n):
        name = f"images/im_{i}.png"
        cv2.imwrite(str(root / name), rng.integers(0, 255, shape + (3,),
                                                   np.uint8))
        theta = i * np.pi / 8
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [2 * np.sin(theta), 0, 2 * np.cos(theta)]
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    (root / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": 0.9, "frames": frames[::-1]}))
    return root


def test_load_transforms_json_equals_jax(tmp_path):
    tj = _scene(tmp_path / "scene") / "transforms.json"
    got, want = tps.load_transforms_json(tj), jps.load_transforms_json(tj)
    assert got[0] == want[0] and got[2] == want[2]
    assert np.array_equal(got[1], want[1])
    meta = json.loads(tj.read_text())
    del meta["camera_angle_x"]
    meta.update(h=48, fl_y=40.0)
    tj.write_text(json.dumps(meta))
    assert tps.load_transforms_json(tj)[2] == jps.load_transforms_json(tj)[2]


def test_frames_load_as_the_reference_loads_them(tmp_path):
    """The reference's ``cv2.imread`` + ``cv2.resize`` + BGR flip + / 255."""
    scene = _scene(tmp_path / "scene")
    images, _, _ = tps.load_transforms_json(scene / "transforms.json")
    got = tps.load_frames(images, (32, 48))
    want = np.stack([(cv2.resize(cv2.imread(str(p)), (48, 32))[:, :, ::-1]
                      / 255.0).astype(np.float32) for p in images])
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_main_tiny_preset_writes_a_nerf_scene(tmp_path, monkeypatch):
    """transforms.json -> the tiny field trained 12 steps on the CPU ->
    5 novel views in the layout ``NeRFDataset`` reads."""
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path / "data")
    scene = _scene(tmp_path / "scene")
    root = tps.main(["--data-path", str(scene), "--scene-name", "toolscene",
                     "--train-iters", "12", "--render-size", "32", "48",
                     "--n-novel-views", "5", "--nerf-preset", "tiny",
                     "--device", "cpu"])
    assert root == tmp_path / "data" / "NeRF" / "toolscene"
    for sub, ext in (("images", "png"), ("depth", "npy"),
                     ("camera_transforms", "npy")):
        files = sorted((root / sub).rglob(f"*.{ext}"))
        assert len(files) == 5, sub
    counts = {}
    for split in ("training", "validation", "test"):
        ds = NeRFDataset({"name": "NeRF", "data_dir": "toolscene",
                          "warped_pair": False}, split)
        counts[split] = len(ds)
        if not len(ds):
            continue
        sample = ds[0]
        assert sample["image"].shape == (32, 48, 1)
        assert sample["depth"].shape == (32, 48)
        assert np.isfinite(sample["depth"]).all()
        assert sample["rotation"].shape == (3, 3)
    # the reference's 80 / 10 / 10 split of 5 views
    assert counts == {"training": 4, "validation": 0, "test": 1}


def test_main_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene(tmp_path / "scene", n=2, shape=(8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tps.main(["--data-path", str(scene), "--train-iters", "1",
                  "--render-size", "8", "8", "--nerf-preset", "tiny"])
