"""The port's ``get_loaders`` / ``get_nerf_loaders`` with
``data.num_workers`` against the JAX package's
``spnerf_tpu.utils.factories.get_loaders`` on the same configs: at 0 and
1 workers the batches are equal for COCO with the host photometric (the
images within ``test_torch_photometric_host.CHAIN_TOL`` on the 0-255
scale, as ``test_torch_coco.py`` holds them), for SyntheticShapes and
for one NeRF scene; at 4 the batch indices are equal, and so are the
batches of COCO in export mode, which draws nothing (a dataset that
draws takes a thread-local stream per pool thread, in both packages, so
its draws are not repeatable there). An exception raised inside a worker
reaches the consumer, and closing the iterator joins the thread."""

import importlib.util
import shutil
import sys
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from _jpeg_fixtures import DIR
from spnerf_tpu.data import coco as jcoco
from spnerf_tpu.data import nerf_dataset as jnerf
from spnerf_tpu.data import synthetic_shapes as jshapes
from spnerf_tpu.utils import factories as jfactories
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.eval import cv_rng
from spnerf_tpu_torch.tasks.nerf_task import write_scene
from spnerf_tpu_torch.utils import factories
from test_torch_photometric_host import CHAIN_TOL

ROOT = Path(__file__).resolve().parents[1]
RESIZE = [60, 80]
PHOTO = {"enable": True, "on_device": False, "primitives": "all",
         "params": {"additive_shade": {"kernel_size_range": [20, 40]}}}
SYN = {
    "name": "Synthetic_dataset", "class_name": "SyntheticShapes",
    "primitives": ["draw_lines", "draw_star", "gaussian_noise"],
    "data_dir": "syn", "truncate": {},
    "generation": {"split_sizes": {"training": 4, "validation": 2,
                                   "test": 0},
                   "image_size": [60, 80], "random_seed": 2,
                   "params": {"generate_background": {
                       "min_kernel_size": 5, "max_kernel_size": 20}}},
    "preprocessing": {"resize": [30, 40], "blur_size": 5},
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """COCO/images/{training,validation} (9 and 3 of the JPEG fixtures)
    with labels, and one box-room NeRF scene written by the port."""
    root = tmp_path_factory.mktemp("loaders")
    fixtures = sorted(DIR.glob("*.jpg"))
    rng = np.random.default_rng(0)
    for split, n in (("training", 9), ("validation", 3)):
        img_dir = root / "data" / "COCO" / "images" / split
        lab_dir = root / "exper" / "labels" / split
        img_dir.mkdir(parents=True)
        lab_dir.mkdir(parents=True)
        for i in range(n):
            src = fixtures[(3 * i + len(split)) % len(fixtures)]
            shutil.copy(src, img_dir / f"{i:03d}_{src.stem}.jpg")
            np.save(lab_dir / f"{i:03d}_{src.stem}.npy",
                    rng.integers(0, RESIZE, (50, 2)).astype(np.int64))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mp = pytest.MonkeyPatch()
    mp.setattr(settings, "DATA_PATH", root / "data")
    scene = smoke.box_room(3, shape=(48, 64))
    write_scene("Room", scene["rgb"], scene["depth"], scene["poses"],
                scene["splits"])
    mp.undo()
    return root


@pytest.fixture
def roots(tree, monkeypatch, tmp_path):
    """Both packages' roots at the tree; SyntheticShapes dumps apart."""
    monkeypatch.setattr(settings, "DATA_PATH", tree / "data")
    monkeypatch.setattr(settings, "EXPER_PATH", tree / "exper")
    for module in (jcoco, jnerf):
        monkeypatch.setattr(module, "DATA_PATH", tree / "data")
    monkeypatch.setattr(jcoco, "EXPER_PATH", tree / "exper")
    monkeypatch.setattr(jnerf, "EXPER_PATH", tree / "exper")
    monkeypatch.setattr(jshapes, "DATA_PATH", tmp_path / "jax")
    return tree


def _coco(**kw):
    data = {"name": "COCO", "class_name": "COCO", "batch_size": 2,
            "preprocessing": {"resize": RESIZE}, "has_labels": "labels",
            "warped_pair": True, "truncate": False,
            "augmentation": {"photometric": PHOTO}}
    data.update(kw)
    return {"data": data}


def _nerf(**kw):
    data = {"name": "NeRF", "class_name": "NeRF", "batch_size": 2,
            "all_data_dirs": ["Room"], "fov": 44, "warped_pair": True,
            "downsample": True, "downsample_size": [32, 40],
            "augmentation": {"photometric": {"enable": False}}}
    data.update(kw)
    return {"data": data}


def _loaders(config, nerf=False, syn_seed=None, tmp=None):
    """(port's, JAX package's) loaders of ``config``, one list each of
    (split, loader)."""
    if syn_seed is not None:
        settings.DATA_PATH = tmp / "port"
        cv2.setRNGSeed(syn_seed)
    want = jfactories.get_loaders(config, "train", nerf_train=nerf)
    if syn_seed is not None:
        cv_rng.set_rng_seed(syn_seed)
    got = factories.get_loaders(config, "train", nerf_train=nerf)
    flat = []
    for split in ("train", "validation"):
        g, w = got[split], want[split]
        pairs = zip(g, w) if nerf else [(g, w)]
        flat += [(split, a, b) for a, b in pairs]
    return flat


def _assert_batches_equal(got_loader, want_loader, image_tol=0.0):
    got, want = list(got_loader), list(want_loader)
    assert len(got) == len(want) == len(want_loader) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            assert g[key].dtype == value.dtype and g[key].shape == value.shape
            if key.startswith("image") and image_tol:
                assert np.abs(g[key] - value).max() * 255 <= image_tol, key
            else:
                np.testing.assert_array_equal(g[key], value, err_msg=key)


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("dataset", ["coco", "syn", "nerf"])
def test_batches_equal_jax(roots, tmp_path, dataset, workers):
    if dataset == "coco":
        flat = _loaders(_coco(num_workers=workers))
    elif dataset == "syn":
        flat = _loaders({"data": dict(SYN, batch_size=3,
                                      num_workers=workers)},
                        syn_seed=11, tmp=tmp_path)
    else:
        flat = _loaders(_nerf(num_workers=workers), nerf=True)
    for split, got, want in flat:
        assert got.num_workers == want.num_workers == workers
        assert (got.shuffle, got.drop_last) == (want.shuffle, want.drop_last)
        _assert_batches_equal(got, want, CHAIN_TOL if dataset == "coco"
                              else 0.0)


@pytest.mark.parametrize("nerf", [False, True])
def test_four_workers(roots, nerf):
    """At 4 workers: every loader takes the key, the batch indices equal
    the JAX package's, and COCO's export-mode batches (no draws) are
    equal, in index order."""
    if nerf:
        flat = _loaders(_nerf(num_workers=4), nerf=True)
    else:
        flat = _loaders(_coco(num_workers=4))
    for split, got, want in flat:
        assert got.num_workers == want.num_workers == 4
        got_idx = [list(i) for i in got.batch_indices()]
        assert got_idx == [list(i) for i in want._index_stream()]
        assert len(got_idx) == len(got) > 0
    if nerf:
        return
    export = _coco(num_workers=4, has_labels=False, warped_pair=False,
                   augmentation={"photometric": {"enable": False}})
    for split, got, want in _loaders(export):
        _assert_batches_equal(got, want)
        names = [n for batch in got for n in batch["name"]]
        assert names == [got.dataset.samples["names"][int(i)]
                         for idx in got.batch_indices() for i in idx]


class _Failing:
    """Samples of their index; index 5 raises."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 5:
            raise RuntimeError("sample 5 is broken")
        return {"i": np.array(i)}


def test_worker_exception_reaches_the_consumer():
    before = threading.active_count()
    loader = DataLoader(_Failing(), 4, num_workers=4)
    seen = []
    with pytest.raises(RuntimeError, match="sample 5 is broken"):
        for batch in loader:
            seen.append(batch["i"].tolist())
    assert seen == [[0, 1, 2, 3]]
    # in order at 4 workers, and the iterator's close joins its thread
    it = iter(DataLoader(_Failing(), 2, num_workers=4, prefetch=1))
    assert next(it)["i"].tolist() == [0, 1]
    it.close()
    assert threading.active_count() == before


def test_other_loaders_ignore_the_key(roots):
    """``data.num_workers`` reaches only ``get_loaders`` and
    ``get_nerf_loaders``: the export loaders keep the loader's own
    thread, as the reference's do."""
    import inspect

    from spnerf_tpu_torch import cli
    from spnerf_tpu_torch.eval import on_the_fly
    from spnerf_tpu_torch.tasks import export_nerf

    for module in (cli, on_the_fly, export_nerf):
        assert "num_workers" not in inspect.getsource(module)
    for loader in factories.get_nerf_loaders(_nerf(num_workers=3))["train"]:
        assert loader.num_workers == 3
    assert factories.get_loaders(_coco(), "validation")[
        "validation"].num_workers == 0


class _Slow:
    """Samples that sleep a seeded while and do numpy work, so that pool
    threads finish out of order."""

    def __init__(self, n):
        self.delays = np.random.default_rng(0).uniform(0, 2e-3, n)

    def __len__(self):
        return len(self.delays)

    def __getitem__(self, i):
        time.sleep(self.delays[i])
        x = np.full((16, 16), float(i))
        return {"i": np.array(i), "sum": (x @ x).sum()}


def test_many_workers_keep_index_order():
    """More workers than cores and a short switch interval: every batch
    holds its indices in order, with each sample's own values, and the
    loader's thread ends."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(_Slow(96), 12, shuffle=True, num_workers=16)
        batches = list(loader)
        order = [list(i) for i in loader.batch_indices()]
    finally:
        sys.setswitchinterval(saved)
    assert [b["i"].tolist() for b in batches] == order
    for b in batches:
        np.testing.assert_array_equal(b["sum"], 256.0 * 16 * b["i"] ** 2)
