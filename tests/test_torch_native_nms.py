"""The port's native exact NMS (``ops/native_nms.py`` over its own
``native/exact_nms.cpp``) against the JAX package's ctypes wrapper and
the numpy greedy oracle of ``tests/test_ops.py``, within 1e-7 as
``tests/test_native_nms.py`` holds the reference."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from spnerf_tpu.ops import native_nms as jnms
from spnerf_tpu_torch.ops import native_nms as tnms
from spnerf_tpu_torch.utils import native
from test_ops import _greedy_nms_numpy

ROOT = Path(__file__).resolve().parents[1]


def _prob(seed, shape=(48, 64), n=120):
    rng = np.random.default_rng(seed)
    prob = np.zeros(shape, np.float32)
    prob[rng.integers(0, shape[0], n), rng.integers(0, shape[1], n)] = \
        rng.uniform(0.02, 1.0, n).astype(np.float32)
    return prob


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("top_k", [0, 25])
def test_native_nms_matches_jax_and_the_oracle(seed, top_k):
    prob = _prob(seed, n=120 + 200 * (seed % 2))
    got = tnms.exact_nms(prob, size=4, iou=0.1, min_prob=0.015,
                         keep_top_k=top_k)
    np.testing.assert_allclose(
        got, jnms.exact_nms(prob, size=4, iou=0.1, min_prob=0.015,
                            keep_top_k=top_k), atol=1e-7, rtol=0)
    if top_k == 0:
        np.testing.assert_allclose(
            got, _greedy_nms_numpy(prob, size=4, iou=0.1, min_prob=0.015),
            atol=1e-7, rtol=0)
    else:
        assert (got > 0).sum() == min(top_k, (tnms.exact_nms(prob) > 0).sum())


def test_native_top_k():
    prob = np.zeros((32, 32), np.float32)
    prob[4, 4], prob[12, 12], prob[20, 20] = 0.9, 0.8, 0.7
    out = tnms.exact_nms(prob, size=4, iou=0.1, min_prob=0.1, keep_top_k=2)
    assert (out > 0).sum() == 2
    assert out[4, 4] == pytest.approx(0.9)
    assert out[20, 20] == 0.0


def test_builds_its_own_source_into_build():
    tnms.exact_nms(_prob(0))
    assert native.SOURCE_DIR == ROOT / "spnerf_tpu_torch/native"
    assert (native.SOURCE_DIR / "exact_nms.cpp").is_file()
    assert native.BUILD_DIR == ROOT / "build/spnerf_tpu_torch/native"
    assert (native.BUILD_DIR / "libexact_nms.so").is_file()
    assert native.BUILD_DIR / "libexact_nms.so" != \
        ROOT / "native/libexact_nms.so"


def test_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnms.exact_nms(_prob(0))
    assert not tnms.native_available()


def test_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "exact_nms.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: "):
        tnms.exact_nms(_prob(0))
