"""The port's photometric augmentation against ``spnerf_tpu.ops
.photometric_device`` on the CPU.

torch cannot reproduce ``jax.random``: each primitive of the port is a
deterministic function of its draws, so the tests re-derive the random
numbers the JAX primitive draws from its key (the key splits below follow
the reference's source line by line) and feed them to the port.

Tolerance: atol 2e-6 on images in [0, 1] (float32 convolution sums of up
to 151 taps and means over the image in another order); where the
reference compares a noise field with a threshold the fields are JAX's
own, so those pixels agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.ops import photometric_device as jp
from spnerf_tpu_torch.ops import photometric_device as tp

ATOL = 2e-6


def _np(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def jax_draws(name, key, B, H, W, cfg):
    """What ``jp.AUG_FNS[name](images, key, cfg)`` draws from ``key``, in
    the layout of ``tp.draw_photometric_randoms``."""
    per_sample = lambda k, lo, hi: _np(jp._per_sample_uniform(k, B, lo, hi)).reshape(B)  # noqa: E731
    if name == "random_brightness":
        m = cfg.brightness_max_abs_change / 255.0
        return {"delta": per_sample(key, -m, m)}
    if name == "random_contrast":
        return {"strength": per_sample(key, *cfg.contrast_strength_range)}
    if name == "additive_gaussian_noise":
        k_std, k_noise = jax.random.split(key)
        lo, hi = cfg.gaussian_stddev_range
        return {"std": per_sample(k_std, lo / 255.0, hi / 255.0),
                "noise": _np(jax.random.normal(k_noise, (B, H, W, 1),
                                               jnp.float32))}
    if name == "additive_speckle_noise":
        k_p, k_u = jax.random.split(key)
        return {"prob": per_sample(k_p, *cfg.speckle_prob_range),
                "u": _np(jax.random.uniform(k_u, (B, H, W, 1),
                                            dtype=jnp.float32))}
    if name == "motion_blur":
        k_size, k_dir = jax.random.split(key)
        m = cfg.motion_max_kernel_size
        return {"size": _np(jax.random.randint(k_size, (B,), 0,
                                               (m + 1) // 2 + 1), np.int64),
                "direction": _np(jax.random.randint(k_dir, (B,), 0, 4),
                                 np.int64)}
    assert name == "additive_shade"
    n = cfg.shade_nb_ellipses
    k_ax, k_ay, k_x, k_y, k_ang, k_t, k_ks = jax.random.split(key, 7)
    min_dim = min(H, W) / 4.0
    uni = lambda k, **kw: _np(jax.random.uniform(k, (B, n), **kw))  # noqa: E731
    return {"ax": uni(k_ax, minval=min_dim / 5, maxval=min_dim),
            "ay": uni(k_ay, minval=min_dim / 5, maxval=min_dim),
            "cx": uni(k_x), "cy": uni(k_y),
            "angle": uni(k_ang, minval=0.0, maxval=jnp.pi / 2),
            "transparency": per_sample(k_t, *cfg.shade_transparency_range),
            "ksize": _np(jax.random.randint(k_ks, (B,),
                                            *cfg.shade_kernel_size_range),
                         np.int64)}


def jax_augment_draws(key, B, H, W, cfg):
    """The draws of ``jp.photometric_augment(key, images, cfg)``."""
    k_order, k_apply = jax.random.split(key)
    order = np.asarray(jax.random.permutation(k_order, len(cfg.primitives)))
    draws = {"order": torch.from_numpy(order.astype(np.int64))}
    for pos, which in enumerate(order):
        name = cfg.primitives[int(which)]
        draws[name] = jax_draws(name, jax.random.fold_in(k_apply, pos), B, H,
                                W, cfg)
    return draws


def _images(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, (B, H, W, 1)).astype(np.float32)


def _configs(**kw):
    return jp.PhotometricDeviceConfig(**kw), tp.PhotometricDeviceConfig(**kw)


# the training config's parameters, the shade kernel sized for small images
TRAIN_KW = dict(speckle_prob_range=(0.0, 0.0035),
                shade_transparency_range=(-0.5, 0.5),
                shade_kernel_size_range=(9, 15), motion_max_kernel_size=3)
PRIMITIVE_CASES = {
    "random_brightness": TRAIN_KW,
    "random_contrast": TRAIN_KW,
    "additive_gaussian_noise": TRAIN_KW,
    "additive_speckle_noise": dict(TRAIN_KW, speckle_prob_range=(0.0, 0.2)),
    "motion_blur": dict(TRAIN_KW, motion_max_kernel_size=7),
    "motion_blur_even": dict(TRAIN_KW, motion_max_kernel_size=4),
    "additive_shade": TRAIN_KW,
    # the config's 151-tap kernel on a 24 x 40 image: truncated per axis
    "additive_shade_truncated": dict(TRAIN_KW,
                                     shade_kernel_size_range=(100, 150)),
}


@pytest.mark.parametrize("case", list(PRIMITIVE_CASES))
def test_primitive_fed_jax_draws(case):
    name = case.replace("_even", "").replace("_truncated", "")
    jcfg, tcfg = _configs(**PRIMITIVE_CASES[case])
    B, H, W = 4, 24, 40
    images = _images(B, H, W)
    moved = 0.0
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jp.AUG_FNS[name](jnp.asarray(images), key, jcfg))
        got = tp.AUG_FNS[name](torch.from_numpy(images),
                               jax_draws(name, key, B, H, W, jcfg), tcfg)
        assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        moved = max(moved, float(np.abs(want - images).max()))
    assert moved > 1e-3  # the primitive did something


def test_augment_fed_jax_draws():
    jcfg, tcfg = _configs(**TRAIN_KW)
    B, H, W = 3, 32, 48
    images = _images(B, H, W, seed=1)
    orders = set()
    for seed in range(4):
        key = jax.random.PRNGKey(10 + seed)
        want = np.asarray(jp.photometric_augment(key, jnp.asarray(images),
                                                 jcfg))
        draws = jax_augment_draws(key, B, H, W, jcfg)
        orders.add(tuple(draws["order"].tolist()))
        got = tp.photometric_from_draws(torch.from_numpy(images), draws, tcfg)
        # six primitives in a row: clipping and thresholds amplify nothing,
        # the errors of the blurs add up
        np.testing.assert_allclose(got.numpy(), want, atol=4 * ATOL, rtol=0)
    assert len(orders) > 1


def test_subset_of_primitives_and_empty():
    kw = dict(TRAIN_KW, primitives=("motion_blur", "random_contrast"))
    jcfg, tcfg = _configs(**kw)
    images = _images(2, 16, 24, seed=2)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jp.photometric_augment(key, jnp.asarray(images), jcfg))
    got = tp.photometric_from_draws(torch.from_numpy(images),
                                    jax_augment_draws(key, 2, 16, 24, jcfg),
                                    tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    none = tp.PhotometricDeviceConfig(primitives=())
    x = torch.from_numpy(images)
    assert tp.photometric_augment(torch.Generator().manual_seed(0), x,
                                  none) is x


def test_own_draws_ranges_and_determinism():
    cfg = tp.PhotometricDeviceConfig(**TRAIN_KW)
    B, H, W = 64, 16, 24
    d = tp.draw_photometric_randoms(torch.Generator().manual_seed(3), B, H, W,
                                    cfg)
    again = tp.draw_photometric_randoms(torch.Generator().manual_seed(3), B,
                                        H, W, cfg)
    assert sorted(d["order"].tolist()) == list(range(6))
    for name in tp.PRIMITIVES:
        for field, t in d[name].items():
            assert torch.equal(t, again[name][field]), (name, field)
    m = 50.0 / 255.0
    assert -m <= float(d["random_brightness"]["delta"].min())
    assert float(d["random_brightness"]["delta"].max()) <= m
    s = d["random_contrast"]["strength"]
    assert 0.5 <= float(s.min()) and float(s.max()) <= 1.5 and float(s.std()) > 0.1
    assert float(d["additive_gaussian_noise"]["std"].max()) <= 10 / 255.0
    assert float(d["additive_speckle_noise"]["prob"].max()) <= 0.0035
    assert set(d["motion_blur"]["size"].tolist()) == {0, 1, 2}
    assert set(d["motion_blur"]["direction"].tolist()) == {0, 1, 2, 3}
    ks = d["additive_shade"]["ksize"]
    assert 9 <= int(ks.min()) and int(ks.max()) <= 14  # upper bound exclusive
    shade = d["additive_shade"]
    assert shade["ax"].shape == (B, 20) and float(shade["ax"].min()) >= 0.8
    assert float(shade["angle"].max()) <= np.pi / 2
    noise = d["additive_gaussian_noise"]["noise"]
    assert noise.shape == (B, H, W, 1) and abs(float(noise.std()) - 1) < 0.05
    out = tp.photometric_from_draws(torch.rand((B, H, W, 1)), d, cfg)
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


def test_config_from_dict_matches_reference():
    block = {
        "enable": True, "on_device": True,
        "primitives": ["random_brightness", "random_contrast",
                       "additive_speckle_noise", "additive_gaussian_noise",
                       "additive_shade", "motion_blur"],
        "params": {
            "random_brightness": {"max_abs_change": 50},
            "random_contrast": {"strength_range": [0.5, 1.5]},
            "additive_gaussian_noise": {"stddev_range": [0, 10]},
            "additive_speckle_noise": {"prob_range": [0, 0.0035]},
            "additive_shade": {"transparency_range": [-0.5, 0.5],
                               "kernel_size_range": [100, 150],
                               "nb_ellipses": 20},
            "motion_blur": {"max_kernel_size": 3}}}
    for cfg in (block, None, {"primitives": "all"}):
        assert (vars(tp.PhotometricDeviceConfig.from_dict(cfg))
                == vars(jp.PhotometricDeviceConfig.from_dict(cfg)))
