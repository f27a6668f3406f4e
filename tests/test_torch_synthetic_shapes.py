"""The port's Synthetic Shapes (``spnerf_tpu_torch/data/synthetic_draw.py``,
``synthetic_shapes.py``) against the JAX package's, which draws with cv2:
every primitive's sample byte-equal and its points equal
for the same numpy seed and the same OpenCV generator state, and a
dataset dump whose samples and points equal the reference's in one
process (PNG bytes may differ: each package has its own encoder; the
decoded pixels are equal)."""

import cv2
import numpy as np
import pytest

from spnerf_tpu.data import synthetic_draw as jdraw
from spnerf_tpu.data import synthetic_shapes as jshapes
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import synthetic_draw as tdraw
from spnerf_tpu_torch.data import synthetic_shapes as tshapes
from spnerf_tpu_torch.eval import cv_rng

CUT = {"generate_background": {"min_kernel_size": 5, "max_kernel_size": 40}}


def _pair(primitive, seed, size, params):
    cv2.setRNGSeed(seed + 1)
    want = jdraw.generate_sample(primitive, np.random.default_rng(seed),
                                 size, params)
    got = tdraw.generate_sample(primitive, np.random.default_rng(seed), size,
                                params, cv_rng=cv_rng.CvRNG(seed + 1))
    return got, want


def _assert_sample_equal(got, want):
    (gi, gp), (wi, wp) = got, want
    assert gi.dtype == np.uint8 and gp.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("primitive", tdraw.PRIMITIVES)
@pytest.mark.parametrize("size,seeds", [((120, 160), range(6)),
                                        ((240, 320), range(2))])
def test_sample_equals_reference(primitive, size, seeds):
    for seed in seeds:
        _assert_sample_equal(*_pair(primitive, seed, size, CUT))


@pytest.mark.parametrize("primitive", ["draw_checkerboard", "draw_cube",
                                       "gaussian_noise"])
def test_sample_at_default_background_kernels(primitive):
    """The defaults' kernels (150-500) on a 96 x 128 image: the blur reads
    its reflected border again and again."""
    _assert_sample_equal(*_pair(primitive, 3, (96, 128), {}))


def test_global_generator_is_the_default():
    cv2.setRNGSeed(77)
    cv_rng.set_rng_seed(77)
    want = jdraw.generate_sample("gaussian_noise", np.random.default_rng(5),
                                 (40, 60), CUT)
    got = tdraw.generate_sample("gaussian_noise", np.random.default_rng(5),
                                (40, 60), CUT)
    _assert_sample_equal(got, want)
    # both generators moved on by the same draws
    a, b = np.zeros((3, 4), np.uint8), np.zeros((3, 4), np.uint8)
    cv2.randu(a, 0, 255)
    cv_rng.randu(b, 0, 255)
    np.testing.assert_array_equal(a, b)


DATA = {
    "name": "Synthetic_dataset", "class_name": "SyntheticShapes",
    "primitives": "all", "data_dir": "syn",
    "truncate": {"draw_ellipses": 0.5, "gaussian_noise": 0.5},
    "generation": {"split_sizes": {"training": 3, "validation": 2,
                                   "test": 1},
                   "image_size": [120, 160], "random_seed": 4,
                   "params": CUT},
    "preprocessing": {"resize": [60, 80], "blur_size": 11},
}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One dump by each package, both generators at the same state."""
    root = tmp_path_factory.mktemp("syn")
    mp = pytest.MonkeyPatch()
    mp.setattr(jshapes, "DATA_PATH", root / "jax")
    mp.setattr(settings, "DATA_PATH", root / "port")
    cv2.setRNGSeed(9)
    want = {s: jshapes.SyntheticShapes(DATA, s) for s in ("training",
                                                           "validation")}
    cv_rng.set_rng_seed(9)
    got = {s: tshapes.SyntheticShapes(DATA, s) for s in ("training",
                                                          "validation")}
    yield root, got, want
    mp.undo()


def test_dump_equals_reference(dumps):
    root, got, want = dumps
    for split in ("training", "validation"):
        g, w = got[split], want[split]
        assert len(g) == len(w) > 0
        assert [p.relative_to(root / "port") for p in g.samples["images"]] \
            == [p.relative_to(root / "jax") for p in w.samples["images"]]
        for i in range(len(g)):
            gs, ws = g[i], w[i]
            assert sorted(gs) == sorted(ws) == ["image", "kpts", "kpts_mask"]
            for key in ws:
                assert gs[key].dtype == ws[key].dtype, key
                np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)
            assert gs["kpts"].shape == (tshapes.MAX_KPTS, 2)
        for gp, wp in zip(g.samples["points"], w.samples["points"]):
            np.testing.assert_array_equal(np.load(gp), np.load(wp))
    # truncate: half of the noise and ellipse images, at least one
    names = [p.parts[-4] for p in got["training"].samples["images"]]
    assert names.count("gaussian_noise") == 1
    assert names.count("draw_lines") == 3


def test_dump_resumes_without_drawing(dumps, monkeypatch):
    """A second dataset over a complete dump draws nothing."""
    root, got, _ = dumps

    def no_draw(*a, **k):
        raise AssertionError("drew a sample over a complete dump")

    monkeypatch.setattr(settings, "DATA_PATH", root / "port")
    monkeypatch.setattr(tshapes, "generate_sample", no_draw)
    again = tshapes.SyntheticShapes(DATA, "training")
    assert again.samples == got["training"].samples
