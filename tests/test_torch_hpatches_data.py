"""The port's HPatches reading (``data/pnm.py``, ``data/preprocessing.py``,
``data/hpatches.py``) against cv2 and the JAX package on the CPU.

Tolerances: images byte for byte (``cv2.imread(..., IMREAD_GRAYSCALE)``,
``cv2.resize`` through the reference); the adapted homographies within
1e-6 relative (float32 products in the same order).
"""

import cv2
import numpy as np
import pytest

from _hpatches_tree import NAMES, write_tree
from spnerf_tpu.data import hpatches as jhp
from spnerf_tpu.data import preprocessing as jpre
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import hpatches as thp
from spnerf_tpu_torch.data import pnm
from spnerf_tpu_torch.data import preprocessing as tpre


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (37, 53), (240, 319)])
@pytest.mark.parametrize("channels", [1, 3])
def test_pnm_reads_what_cv2_writes_as_cv2_reads_it(tmp_path, shape,
                                                   channels):
    rng = np.random.default_rng(shape[0] * 7 + channels)
    img = rng.integers(0, 256, shape + (channels,) * (channels == 3),
                       dtype=np.uint8)
    path = tmp_path / ("x.pgm" if channels == 1 else "x.ppm")
    assert cv2.imwrite(str(path), img)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = pnm.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pnm_every_rgb_triple_of_a_lattice_as_cv2(tmp_path):
    """Gray of 32^3 RGB values over the range, rounding ties included."""
    v = np.arange(0, 256, 8, dtype=np.uint8)
    v[-1] = 255
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    rgb = np.stack([r, g, b], -1).reshape(len(v) ** 2, len(v), 3)
    pnm.write(tmp_path / "l.ppm", rgb)
    np.testing.assert_array_equal(
        pnm.read_gray(tmp_path / "l.ppm"),
        cv2.imread(str(tmp_path / "l.ppm"), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "l.ppm"), cv2.IMREAD_COLOR)[..., ::-1],
        rgb)  # the writer's layout is what cv2 reads as RGB


def test_pnm_header_comments_and_refusals(tmp_path):
    """Comments in the header; what now reads as cv2 reads it (ASCII
    samples, 16-bit samples); what cv2 refuses too, beside its None: an
    ASCII file ending on a digit, a cut binary file, a cut header."""
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5\n# a comment\n4 # width\n3\n255\n" + img.tobytes())
    np.testing.assert_array_equal(pnm.read_gray(path), img)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
    for good in (b"P2\n4 3\n255\n" + b" ".join(b"%d" % v for v in range(12))
                 + b"\n", b"P5\n4 3\n65535\n" + bytes(range(24))):
        path.write_bytes(good)
        np.testing.assert_array_equal(
            pnm.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    for bad, what in ((b"P2\n4 3\n255\n0 1 2", "ends"),
                      (b"P5\n4 3\n255\n" + bytes(5), "truncated"),
                      (b"P5\n4", "header")):
        path.write_bytes(bad)
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None
        with pytest.raises(ValueError, match=what):
            pnm.read_gray(path)


@pytest.mark.parametrize("src,target", [
    ((480, 640), (240, 320)), ((90, 119), (64, 80)), ((75, 97), (64, 80)),
    ((97, 131), (120, 160)), ((600, 800), (480, 640)), ((64, 80), (64, 80)),
    ((301, 199), (240, 320))])
def test_ratio_preserving_resize_equals_jax(src, target):
    img = np.random.default_rng(src[0]).integers(0, 256, src, np.uint8)
    got = tpre.ratio_preserving_resize(img, target)
    want = jpre.ratio_preserving_resize(img, target)
    assert got.shape == want.shape == target
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shapes", [((90, 119), (75, 97)),
                                    ((480, 640), (480, 640)),
                                    ((97, 131), (301, 199))])
def test_adapt_homography_equals_jax(shapes):
    H = np.array([[1.05, 0.02, 3.5], [-0.01, 0.97, -2.25],
                  [1e-4, -2e-4, 1.0]])
    got = tpre.adapt_homography_to_ratio_resize(H, *shapes, (64, 80))
    want = jpre.adapt_homography_to_ratio_resize(H, *shapes, (64, 80))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hp")
    write_tree(root, lambda path, rgb: cv2.imwrite(str(path), rgb[..., ::-1]))
    return root


@pytest.mark.parametrize("alteration", ["i", "v", "all"])
@pytest.mark.parametrize("resize", [None, [64, 80]])
def test_hpatches_items_equal_jax(tree, monkeypatch, alteration, resize):
    monkeypatch.setattr(settings, "DATA_PATH", tree)
    monkeypatch.setattr(jhp, "DATA_PATH", tree)
    cfg = {"name": "HPatches", "alteration": alteration}
    if resize:
        cfg["preprocessing"] = {"resize": resize}
    got_ds, want_ds = thp.HPatches(cfg), jhp.HPatches(cfg)
    names = NAMES["i"] + NAMES["v"] if alteration == "all" \
        else NAMES[alteration]
    assert got_ds.samples["names"] == want_ds.samples["names"] == names
    assert len(got_ds) == len(want_ds)
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want)
        assert got["name"] == want["name"]
        for key in ("image", "warped_image"):
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
        assert got["homography"].dtype == np.float32
        np.testing.assert_allclose(got["homography"], want["homography"],
                                   rtol=1e-6, atol=1e-6)


def test_hpatches_jpeg_sequences_raise(tmp_path, monkeypatch):
    """A sequence of ``.jpg`` files (which raised before the port had a
    JPEG decoder) reads as the JAX package reads it through cv2."""
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    monkeypatch.setattr(jhp, "DATA_PATH", tmp_path)
    seq = tmp_path / "HPatches" / "v_jpeg"
    seq.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in (1, 2):
        img = cv2.GaussianBlur(rng.integers(0, 256, (45, 61, 3),
                                            dtype=np.uint8), (5, 5), 0)
        cv2.imwrite(str(seq / f"{i}.jpg"), img)
    np.savetxt(seq / "H_1_2", np.eye(3))
    config = {"name": "HPatches", "preprocessing": {"resize": [24, 32]}}
    ds = thp.HPatches(config)
    assert ds.samples["names"] == ["v_jpeg_1_2"]
    got, want = ds[0], jhp.HPatches(config)[0]
    for key in ("image", "warped_image"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        thp.read_gray(str(seq / "1.jpg")),
        cv2.imread(str(seq / "1.jpg"), cv2.IMREAD_GRAYSCALE))
