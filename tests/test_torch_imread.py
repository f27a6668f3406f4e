"""The port's readers by signature (``spnerf_tpu_torch/data/imread.py``)
against cv2 and the JAX package: ``read_rgb`` equal to
``cv2.imread(path)[..., ::-1]`` for PNG, PPM, PGM and JPEG (colour and
gray-coded); ``tools.process_scene.load_frames`` over JPEG frames equal
to the reference's ``cv2.imread`` + ``cv2.resize`` loop
(``spnerf_tpu/tools/process_scene.py``); and ``NeRFDataset`` over a scene
whose frames are ``.jpg`` equal to the JAX package's ``NeRFDataset``."""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest

from _jpeg_fixtures import DIR
from spnerf_tpu.data import nerf_dataset as jnerf
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import imread
from spnerf_tpu_torch.data import nerf_dataset as tnerf
from spnerf_tpu_torch.tasks.nerf_task import write_scene
from spnerf_tpu_torch.tools import process_scene

ROOT = Path(__file__).resolve().parents[1]


def _image(seed, shape=(29, 43)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape + (3,), np.uint8),
                            (5, 5), 0)


@pytest.mark.parametrize("name", ["rgb.png", "gray.png", "rgb.ppm",
                                  "gray.pgm", "rgb.jpg", "gray.jpg",
                                  "rgb.JPEG"])
def test_read_rgb_matches_cv2(tmp_path, name):
    img = _image(len(name))
    path = tmp_path / name
    cv2.imwrite(str(path), img[..., 1] if name.startswith("gray") else img)
    want = cv2.imread(str(path))[..., ::-1]
    got = imread.read_rgb(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread.read_gray(path),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_read_rgb_other_suffix_raises(tmp_path):
    """The decoder follows the file's signature, not its suffix: a TIFF and
    a WebP file (whatever they are called) raise naming ROADMAP Queue 1
    item 7, a missing file ``FileNotFoundError`` (cv2 returns None for
    it); a BMP named ``.tif`` reads as cv2 reads it."""
    img = _image(5)
    ok, buf = cv2.imencode(".bmp", img)
    (tmp_path / "d.tif").write_bytes(buf.tobytes())
    np.testing.assert_array_equal(
        imread.read_rgb(tmp_path / "d.tif"),
        cv2.imread(str(tmp_path / "d.tif"))[..., ::-1])
    for name, ext in (("a.webp", ".webp"), ("b.tif", ".tif"),
                      ("c.jpg", ".tif")):
        ok, buf = cv2.imencode(ext, img)
        (tmp_path / name).write_bytes(buf.tobytes())
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            imread.read_rgb(tmp_path / name)
    assert cv2.imread(str(tmp_path / "c")) is None
    with pytest.raises(FileNotFoundError):
        imread.read_rgb(tmp_path / "c")


def test_load_frames_jpeg_equals_reference_loop():
    """JPEG frames of every kind the fixtures hold (baseline, progressive,
    4:1:1, CMYK, cut, EXIF-rotated, arithmetic, RGB-coded, smoothed,
    resynced, a PNG named .jpg) through ``load_frames``, against the
    reference's loop; not the lossless file, whose colour read is cv2's
    None (the reference's loop fails on it)."""
    paths = [p for p in sorted(DIR.glob("*.jpg"))
             if cv2.imread(str(p)) is not None]
    assert len(paths) == len(list(DIR.glob("*.jpg"))) - 1
    H, W = 60, 80
    want = []
    for p in paths:
        img = cv2.imread(str(p))
        img = cv2.resize(img, (W, H))[:, :, ::-1] / 255.0
        want.append(img.astype(np.float32))
    got = process_scene.load_frames(paths, (H, W))
    assert got.dtype == np.float32 and got.shape == (len(paths), H, W, 3)
    np.testing.assert_array_equal(got, np.stack(want))


def test_nerf_dataset_jpeg_frames_equal_jax(tmp_path, monkeypatch):
    """A box-room scene whose frames are colour JPEGs: the port's
    ``NeRFDataset`` (``imread.read_gray``) against the JAX package's
    (``cv2.imread(..., IMREAD_GRAYSCALE)``), both splits, with the
    partner frame and the random crop."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for module in (settings, jnerf):
        monkeypatch.setattr(module, "DATA_PATH", tmp_path / "data")
        monkeypatch.setattr(module, "EXPER_PATH", tmp_path / "exper")
    scene = smoke.box_room(5, shape=(48, 64))
    write_scene("Room", scene["rgb"], scene["depth"], scene["poses"],
                scene["splits"])
    images = tmp_path / "data" / "NeRF" / "Room" / "images"
    for k, png in enumerate(sorted(images.rglob("*.png"))):
        gray = cv2.imread(str(png), cv2.IMREAD_GRAYSCALE)
        tint = np.stack([gray, 255 - gray, gray // 2], axis=-1)
        cv2.imwrite(str(png.with_suffix(".jpg")), tint, [
            cv2.IMWRITE_JPEG_QUALITY, 80,
            cv2.IMWRITE_JPEG_PROGRESSIVE, k % 2])
        png.unlink()
    config = {"name": "NeRF", "data_dir": "Room", "fov": 44,
              "warped_pair": True, "downsample": True,
              "downsample_size": [32, 40],
              "augmentation": {"photometric": {"enable": False}}}
    for split in ("training", "validation"):
        got_ds = tnerf.NeRFDataset(config, split)
        want_ds = jnerf.NeRFDataset(config, split)
        assert len(got_ds) == len(want_ds) > 0
        assert all(p.endswith(".jpg") for p in got_ds.samples["image_paths"])
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert sorted(got) == sorted(want)
            for key, value in want.items():
                if isinstance(value, str):
                    assert got[key] == value
                else:
                    np.testing.assert_array_equal(got[key], value,
                                                  err_msg=key)
