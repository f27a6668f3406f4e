"""The port's host photometric augmentation (``spnerf_tpu_torch/data/
photometric.py``) against the JAX package's (numpy + cv2) for the same
numpy ``Generator``: brightness, contrast, Gaussian and speckle noise
equal exactly; motion blur and shade within the float32 filters' bound
(``tests/test_torch_cv_filter.py``); the whole ``PhotometricAug`` chain
within ``CHAIN_TOL`` on the 0-255 scale; and the generator at the same
state after every call. Measured over these cases: the chain at most
6.1e-5, the shade 6.9e-5, the motion blur 3.1e-5."""

import numpy as np
import pytest

from spnerf_tpu.data import photometric as jphoto
from spnerf_tpu_torch.data import photometric as tphoto

SHADE_TOL = 2e-4
BLUR_TOL = 5e-5
CHAIN_TOL = 2e-4
# magicpoint_syn.yaml's parameters (the COCO configs' are narrower)
PARAMS = {
    "random_brightness": {"max_abs_change": 75},
    "random_contrast": {"strength_range": [0.3, 1.8]},
    "additive_gaussian_noise": {"stddev_range": [0, 15]},
    "additive_speckle_noise": {"prob_range": [0, 0.0035]},
    "additive_shade": {"transparency_range": [-0.5, 0.8],
                       "kernel_size_range": [50, 100], "nb_ellipses": 20},
    "motion_blur": {"max_kernel_size": 7},
}


def _image(seed, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float32)
    img[:] = rng.integers(0, 256)
    img[shape[0] // 4:, : shape[1] // 2] = rng.integers(0, 256)
    return img + rng.uniform(0, 20, shape).astype(np.float32)


def _run(fn_j, fn_t, img, seed, **kw):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = fn_j(img, rj, **kw)
    got = fn_t(img, rt, **kw)
    assert rj.random() == rt.random(), "the draws diverged"
    assert got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize("name", ["random_brightness", "random_contrast",
                                  "additive_gaussian_noise",
                                  "additive_speckle_noise"])
def test_exact_primitives(name):
    for seed in range(5):
        img = _image(seed)
        got, want = _run(jphoto.AUG_FNS[name], tphoto.AUG_FNS[name], img,
                         seed, **PARAMS[name])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_kernel_size", [1, 3, 7])
def test_motion_blur_within_bound(max_kernel_size):
    for seed in range(12):
        got, want = _run(jphoto.motion_blur, tphoto.motion_blur,
                         _image(seed), seed, max_kernel_size=max_kernel_size)
        assert np.abs(got - want).max() <= BLUR_TOL


@pytest.mark.parametrize("kernel_size_range", [(50, 100), (100, 150)])
def test_additive_shade_within_bound(kernel_size_range):
    for seed in range(4):
        got, want = _run(jphoto.additive_shade, tphoto.additive_shade,
                         _image(seed, (96, 128)), seed,
                         kernel_size_range=kernel_size_range,
                         transparency_range=(-0.5, 0.8))
        assert np.abs(got - want).max() <= SHADE_TOL


@pytest.mark.parametrize("primitives", ["all", ["motion_blur",
                                                "random_contrast"]])
def test_chain_within_bound(primitives):
    config = {"enable": True, "primitives": primitives, "params": PARAMS}
    j, t = jphoto.PhotometricAug(config), tphoto.PhotometricAug(config)
    assert t.primitives == j.primitives
    for seed in range(6):
        img = _image(seed, (64, 80)).astype(np.uint8)
        got, want = _run(j, t, img, seed)
        assert got.shape == want.shape == img.shape
        assert np.abs(got - want).max() <= CHAIN_TOL
