"""The port's COCO dataset (``spnerf_tpu_torch/data/coco.py``) against the
JAX package's (cv2 reads its JPEGs) over one temporary COCO tree of the
committed JPEG fixtures under distinct names, at 120 x 160: export mode,
labels, ``warped_pair``, ``truncate`` and an explicit shard give equal
samples; with host photometric augmentation the images lie within
``test_torch_photometric_host.CHAIN_TOL`` (on the 0-255 scale) and the
names, keypoints and masks are equal. ``shard: auto`` without a process
group is the whole set, as the JAX package's is in one process."""

import shutil

import numpy as np
import pytest

from _jpeg_fixtures import DIR
from spnerf_tpu.data import coco as jcoco
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import coco as tcoco
from spnerf_tpu_torch.utils import factories
from test_torch_photometric_host import CHAIN_TOL

RESIZE = [120, 160]
PHOTO = {"enable": True, "on_device": False, "primitives": "all",
         "params": {"additive_shade": {"kernel_size_range": [50, 100]}}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """COCO/images/{training,validation}: 11 and 3 JPEGs; labels for both
    splits under outputs/labels."""
    root = tmp_path_factory.mktemp("coco")
    fixtures = sorted(DIR.glob("*.jpg"))
    rng = np.random.default_rng(0)
    for split, n in (("training", 11), ("validation", 3)):
        img_dir = root / "data" / "COCO" / "images" / split
        lab_dir = root / "exper" / "outputs" / "labels" / split
        img_dir.mkdir(parents=True)
        lab_dir.mkdir(parents=True)
        for i in range(n):
            name = f"{i:03d}_{fixtures[i % len(fixtures)].stem}"
            shutil.copy(fixtures[i % len(fixtures)], img_dir / f"{name}.jpg")
            k = int(rng.integers(0, 1500))  # past MAX_KPTS too
            np.save(lab_dir / f"{name}.npy",
                    rng.integers(0, RESIZE, (k, 2)).astype(np.int64))
    return root


@pytest.fixture
def roots(tree, monkeypatch):
    monkeypatch.setattr(settings, "DATA_PATH", tree / "data")
    monkeypatch.setattr(settings, "EXPER_PATH", tree / "exper")
    monkeypatch.setattr(jcoco, "DATA_PATH", tree / "data")
    monkeypatch.setattr(jcoco, "EXPER_PATH", tree / "exper")
    return tree


def _config(**kw):
    config = {"name": "COCO", "class_name": "COCO",
              "preprocessing": {"resize": RESIZE}, "has_labels": False,
              "warped_pair": False, "truncate": False,
              "augmentation": {"photometric": {"enable": False}}}
    config.update(kw)
    return config


def _assert_equal_samples(got_ds, want_ds, image_tol=0.0):
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.samples["names"] == want_ds.samples["names"]
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, str):
                assert got[key] == value
                continue
            assert got[key].dtype == value.dtype, key
            assert got[key].shape == value.shape, key
            if key.startswith("image") and image_tol:
                assert np.abs(got[key] - value).max() * 255 <= image_tol, key
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_export_mode(roots, split):
    config = _config()
    got = tcoco.COCO(config, split)
    _assert_equal_samples(got, jcoco.COCO(config, split))
    assert got[0]["image"].shape == tuple(RESIZE) + (1,)
    assert sorted(got[0]) == ["image", "name"]


@pytest.mark.parametrize("warped_pair", [False, True])
def test_labels_and_warped_pair(roots, warped_pair):
    config = _config(has_labels="outputs/labels", warped_pair=warped_pair)
    got = tcoco.COCO(config, "training")
    _assert_equal_samples(got, jcoco.COCO(config, "training"))
    sample = got[0]
    assert sample["kpts"].shape == (tcoco.MAX_KPTS, 2)
    assert "image_warp_src" not in sample  # no host photometric


@pytest.mark.parametrize("warped_pair", [False, True])
def test_host_photometric(roots, warped_pair):
    config = _config(has_labels="outputs/labels", warped_pair=warped_pair,
                     augmentation={"photometric": PHOTO})
    got = tcoco.COCO(config, "training")
    want = jcoco.COCO(config, "training")
    _assert_equal_samples(got, want, image_tol=CHAIN_TOL)
    assert ("image_warp_src" in got[0]) == warped_pair
    # validation is never augmented
    _assert_equal_samples(tcoco.COCO(config, "validation"),
                          jcoco.COCO(config, "validation"))


def test_truncate_and_shard(roots):
    config = _config(truncate=0.5)
    got = tcoco.COCO(config, "training")
    _assert_equal_samples(got, jcoco.COCO(config, "training"))
    assert len(got) == 5
    for shard in ([0, 3], [1, 3], [2, 3]):
        config = _config(shard=shard, truncate=False)
        got, want = tcoco.COCO(config, "training"), jcoco.COCO(config,
                                                               "training")
        assert got.shard_offset == want.shard_offset
        _assert_equal_samples(got, want)
    with pytest.raises(ValueError, match="bad shard"):
        tcoco.COCO(_config(shard=[3, 3]), "training")


def test_shard_auto_raises(roots):
    """``shard: auto`` raised until the port had process groups; without
    one it is now the one process's block, every image."""
    config = _config(shard="auto")
    got, want = tcoco.COCO(config, "training"), jcoco.COCO(config,
                                                           "training")
    assert got.shard_offset == want.shard_offset == 0
    assert len(got) == len(tcoco.COCO(_config(), "training"))
    _assert_equal_samples(got, want)


def test_factory_builds_coco(roots):
    ds = factories.get_dataset(_config(), "validation")
    assert isinstance(ds, tcoco.COCO) and len(ds) == 3
    with pytest.raises(ValueError, match="Unknown dataset"):
        factories.get_dataset({"name": "Nope"})


def test_reads_png_and_pnm_too(roots, tmp_path):
    """Images other than JPEG go through the port's PNG and PNM readers."""
    import cv2

    img = (np.arange(40 * 56) % 251).astype(np.uint8).reshape(40, 56)
    for suffix in (".png", ".pgm"):
        path = tmp_path / f"im{suffix}"
        cv2.imwrite(str(path), img)
        np.testing.assert_array_equal(tcoco.read_gray(path),
                                      cv2.imread(str(path), 0))


@pytest.mark.parametrize("suffix", [".png", ".pgm", ".ppm", ".jpg", ".JPEG",
                                    ".bmp", ".tif"])
def test_one_gray_reader_for_coco_hpatches_and_pose(tmp_path, suffix):
    """COCO, HPatches and the pose evaluation read through one dispatch
    (``data/imread.py``, by the file's signature): the formats the port
    decodes (BMP among them) as cv2 reads them, the ones cv2 reads through
    libraries of their own (TIFF) raising the same NotImplementedError
    naming ROADMAP Queue 1 item 7; a missing file
    raises in the loaders and is (None, None) in the pose loader, as
    cv2.imread's None is in the reference."""
    import cv2

    from spnerf_tpu_torch.data import hpatches as thp
    from spnerf_tpu_torch.data import imread
    from spnerf_tpu_torch.eval import pose as tpose

    rng = np.random.default_rng(len(suffix))
    img = cv2.GaussianBlur(rng.integers(0, 256, (37, 53, 3), np.uint8),
                           (5, 5), 0)
    path = tmp_path / f"im{suffix}"
    cv2.imwrite(str(path), img[..., 0] if suffix == ".pgm" else img)
    readers = (tcoco.read_gray, thp.read_gray,
               lambda p: tpose.load_gray(p, [-1])[0])
    assert tcoco.read_gray is thp.read_gray is imread.read_gray
    missing = tmp_path / f"missing{suffix}"
    assert tpose.load_gray(missing, [-1]) == (None, None)
    for read in readers[:2]:
        with pytest.raises(FileNotFoundError):
            read(missing)
    if suffix.lower() != ".tif":
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        for read in readers:
            np.testing.assert_array_equal(read(path), want)
        return
    for read in readers:
        with pytest.raises(NotImplementedError, match=f"im{suffix}"):
            read(path)
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            read(path)
