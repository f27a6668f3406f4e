"""The NeRF-pair training slice of the port against ``spnerf_tpu`` on the
CPU: the dataset, the batch preparation, the NeRF descriptor loss, one
NeRF step (dense and blockwise) and the training step's photometric
draws; then the trainer over per-scene loaders.

Scenes are ``chip_smoke.box_room`` written by ``tasks.nerf_task
.write_scene``. Both steps start from one flax state and take JAX's
tie-break noise (and, for ``train_step``, JAX's photometric draws), as
``tests/test_torch_train.py`` does.

Tolerances: dataset samples and prepared heatmaps equal; the step as
``test_torch_train.py`` holds it (losses and metrics rtol 1e-5;
gradients and Adam's moments rtol 1e-3, atol 1e-4 of the tensor's
largest entry; running statistics rtol 1e-5, atol 1e-6); the descriptor
loss alone rtol 1e-5. The scene's walls carry a fine grain: on exactly
flat walls the training-mode BatchNorm's one-pass variance (E[x^2] -
E[x]^2, flax's and the port's) is left to rounding, and the two
forwards' descriptors differ by 1.9e-4 of their largest (measured; 9e-6
with a grain of 0.01).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from spnerf_tpu.ops import photometric_device as jp
from spnerf_tpu.train import loop as jloop
from spnerf_tpu.train import losses as jl
from spnerf_tpu.train import pipeline as jpipe
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import nerf_dataset as tds
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.ops import photometric_device as tp
from spnerf_tpu_torch.tasks import train_task
from spnerf_tpu_torch.tasks.nerf_task import write_scene
from spnerf_tpu_torch.train import loop as tloop
from spnerf_tpu_torch.train import losses as tl
from spnerf_tpu_torch.train import pipeline as tpipe
from spnerf_tpu_torch.utils import factories
from test_torch_photometric import TRAIN_KW, jax_augment_draws
from test_torch_train import (
    DESC,
    LR,
    G,
    H,
    W,
    _compare_step,
    _jax_state,
    _np_tree,
    _port_state,
)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = chip_smoke()


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages' DATA_PATH and EXPER_PATH (and the port's CKPT_PATH)
    under ``tmp_path``."""
    from spnerf_tpu.data import nerf_dataset as jds

    for name in ("DATA_PATH", "EXPER_PATH", "CKPT_PATH"):
        monkeypatch.setattr(settings, name, tmp_path / name.lower())
    for name in ("DATA_PATH", "EXPER_PATH"):
        monkeypatch.setattr(jds, name, tmp_path / name.lower())
    return tmp_path


def _write_scene(name, seed, shape=(H, W), n_labels=40):
    """A procedural scene and random labels of every frame under
    EXPER_PATH/outputs/lab/<name>/<split>."""
    scene = SMOKE.box_room(seed, shape=shape)
    write_scene(name, scene["rgb"], scene["depth"], scene["poses"],
                scene["splits"])
    rng = np.random.default_rng(seed)
    for split, frames in scene["splits"].items():
        out = Path(settings.EXPER_PATH, "outputs", "lab", name, split)
        out.mkdir(parents=True)
        for j in range(len(frames)):
            n = n_labels + j  # frame 0 keeps fewer, 1 more, ...
            pts = rng.integers(0, shape, (n, 2)).astype(np.int64)
            np.save(out / f"{j}.npy", pts)
    return scene


def _data_config(scene="Room", **kw):
    config = {"name": "NeRF", "class_name": "NeRF", "data_dir": scene,
              "fov": 44, "has_labels": f"outputs/lab/{scene}",
              "warped_pair": True, "batch_size": 2,
              "augmentation": {"photometric": {"enable": False}}}
    config.update(kw)
    return config


@pytest.mark.parametrize("split,crop", [("training", True),
                                        ("training", False),
                                        ("validation", True)])
def test_nerf_dataset_samples_equal_jax(roots, split, crop):
    from spnerf_tpu.data.nerf_dataset import NeRFDataset as JaxNeRFDataset

    _write_scene("Room", 0)
    config = _data_config(downsample=crop, downsample_size=[40, 56])
    got_ds, want_ds = tds.NeRFDataset(config, split), JaxNeRFDataset(config,
                                                                     split)
    assert len(got_ds) == len(want_ds) == {"training": 16,
                                           "validation": 4}[split]
    if split == "training":  # a string sort: "10" comes before "2"
        assert got_ds.samples["names"][:3] == ["0", "1", "10"]
    assert got_ds.samples == want_ds.samples
    partners = set()
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, str):
                assert got[key] == value, key
            else:
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
        names = got_ds.samples["names"]
        partners.add(abs(names.index(got["warped_name"]) - i))
        shape = (40, 56) if crop and split == "training" else (H, W)
        assert got["image"].shape == shape + (1,)
    # 7-15% of the sequence away in the sorted order: 1 frame of 16, 1 of 4
    assert partners == {1}


def test_nerf_dataset_host_photometric_raises(roots):
    """Host photometric augmentation (which raised before the port had
    ``data/photometric.py``): both frames augmented by their own draws,
    within ``test_torch_photometric_host.CHAIN_TOL`` of the JAX package's,
    and nothing on the host where ``on_device`` is set."""
    from spnerf_tpu.data.nerf_dataset import NeRFDataset as JaxNeRFDataset
    from test_torch_photometric_host import CHAIN_TOL

    _write_scene("Room", 0)
    config = _data_config(augmentation={"photometric": {"enable": True}})
    got_ds = tds.NeRFDataset(config, "training")
    want_ds = JaxNeRFDataset(config, "training")
    assert got_ds.photometric is not None
    for i in range(3):
        got, want = got_ds[i], want_ds[i]
        assert got["warped_name"] == want["warped_name"]
        for key in ("image", "image_warp"):
            assert np.abs(got[key] - want[key]).max() * 255 <= CHAIN_TOL
        np.testing.assert_array_equal(got["kpts"], want["kpts"])
    config["augmentation"]["photometric"]["on_device"] = True
    on_device = tds.NeRFDataset(config, "training")
    assert len(on_device) == 16 and on_device.photometric is None


def test_factories(roots):
    _write_scene("A", 1)
    _write_scene("B", 2)
    config = {"data": _data_config(all_data_dirs=["A", "B"],
                                   all_label_dirs=["outputs/lab/A",
                                                   "outputs/lab/B"])}
    loaders = factories.get_nerf_loaders(config)
    assert [len(v) for v in loaders.values()] == [2, 2]
    train, val = loaders["train"][1], loaders["validation"][1]
    assert train.shuffle and train.drop_last and len(train) == 8
    assert not val.shuffle and not val.drop_last and len(val) == 2
    assert train.dataset.samples["label_paths"][0].endswith(
        "outputs/lab/B/training/0.npy")
    # COCO, which raised before it was ported, builds over an empty root
    assert len(factories.get_dataset({"name": "COCO"})) == 0
    with pytest.raises(ValueError, match="Unknown dataset"):
        factories.get_dataset({"name": "Nope"})


def _nerf_batch(seed=0, B=2, n_pts=40):
    """A host NeRF batch of the procedural scene: frames 0, 3 against
    their partners 2, 1, with seeded keypoints."""
    scene = SMOKE.box_room(seed, shape=(H, W))
    rng = np.random.default_rng(seed)
    src, dst = [0, 3][:B], [2, 1][:B]
    poses = scene["poses"]
    kpts = rng.uniform(0, [H, W], (B, n_pts, 2)).astype(np.float32)
    mask = np.ones((B, n_pts), bool)
    mask[:, -5:] = False
    K = SMOKE.camera_intrinsics((H, W), 44)
    return {"image": scene["rgb"][src], "image_warp": scene["rgb"][dst],
            "depth": scene["depth"][src],
            "rotation": poses[src, :3, :3], "translation": poses[src, :3, 3:],
            "rotation_warp": poses[dst, :3, :3],
            "translation_warp": poses[dst, :3, 3:],
            "intrinsics": np.stack([K] * B), "kpts": kpts, "kpts_mask": mask}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_prepare_nerf_batch_equals_jax():
    batch = _nerf_batch()
    want = jpipe.prepare_nerf_batch({k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got = tpipe.prepare_nerf_batch(_torch(batch))
    assert set(got) == set(want) == {"raw", "warp", "intrinsics"}
    for view in ("raw", "warp"):
        assert set(got[view]) == set(want[view])
        for key, value in want[view].items():
            np.testing.assert_array_equal(got[view][key].numpy(),
                                          np.asarray(value), err_msg=key)
    heat = got["warp"]["kpts_heatmap"].numpy()
    assert 10 < heat.sum() < 80  # most points stay in view
    assert not np.array_equal(heat, got["raw"]["kpts_heatmap"].numpy())


@pytest.mark.parametrize("normalise", [False, True],
                         ids=["hinge", "normalised"])
def test_descriptor_loss_nerf_equals_jax(normalise):
    batch = _nerf_batch(1)
    rng = np.random.default_rng(2)
    desc = rng.standard_normal((2, 2, H // G, W // G, 32)).astype(np.float32)
    geom = [batch[k] for k in ("depth", "intrinsics", "rotation",
                               "translation", "rotation_warp",
                               "translation_warp")]
    valid = np.ones((2, H, W), np.int32)
    valid[:, :, :5] = 0
    kw = dict(DESC, normalise_descriptors=normalise)
    want = jl.descriptor_loss_nerf(*map(jnp.asarray, [desc[0], desc[1], *geom]),
                                   jl.DescriptorLossConfig(**kw),
                                   jnp.asarray(valid))
    got = tl.descriptor_loss_nerf(*map(torch.from_numpy, [desc[0], desc[1],
                                                          *geom]),
                                  tl.DescriptorLossConfig(**kw),
                                  torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
    assert float(got[1]) > 0  # some cells reproject onto their partner


@pytest.mark.parametrize("blockwise", [True, False], ids=["blockwise", "dense"])
def test_nerf_step_matches_jax(blockwise):
    """One NeRF step's losses, gradients, Adam state and BatchNorm
    statistics: the port's loss takes the kernels' plain version on the
    CPU (blockwise) or the dense volume, JAX the Pallas kernel in
    interpret mode or its dense loss."""
    batch = _nerf_batch(2)
    jdesc, tdesc = jl.DescriptorLossConfig(**DESC), tl.DescriptorLossConfig(**DESC)
    model, jstate, tx = _jax_state("superpoint", seed=6)
    pstate = _port_state("superpoint", jstate)
    key = jax.random.PRNGKey(30)
    jdata = jpipe.prepare_nerf_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()})

    @jax.jit
    def jstep(state, data, k):
        (_, (bs, metrics)), grads = jax.value_and_grad(
            lambda p: jloop.superpoint_loss_fn(
                p, state.batch_stats, model, data, k, G, True, jdesc, True,
                True, blockwise), has_aux=True)(state.params)
        updates, opt = tx.update(grads, state.opt_state, state.params)
        import optax
        new = jloop.TrainState(params=optax.apply_updates(state.params,
                                                          updates),
                               batch_stats=bs, opt_state=opt,
                               iteration=state.iteration + 1)
        return new, metrics, grads

    jnew, jmetrics, jgrads = jstep(jstate, jdata, key)
    data = tpipe.prepare_nerf_batch(_torch(batch))
    noise = tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, (2, H // G, W // G, 65), minval=0.0, maxval=0.1)))
        for k in jax.random.split(key))
    pstate.optimizer.zero_grad(set_to_none=True)
    loss, metrics = tloop.superpoint_loss_fn(pstate.model, data, noise, G,
                                             True, tdesc, True, True,
                                             blockwise)
    loss.backward()
    pstate.optimizer.step()
    assert float(metrics["positive_dist"].detach()) > 0
    _compare_step(pstate, metrics, jnew, jmetrics, jgrads)


def test_nerf_train_step_augments_each_view_as_jax(monkeypatch):
    """``train_step`` on a NeRF batch with photometric augmentation: the
    raw view and the second real view each get their own draws, the raw
    view's first, as the JAX step draws them from its key (JAX's draws and
    noise fed to the port); the step's metrics equal JAX's."""
    batch = _nerf_batch(3)
    pcfg = dict(TRAIN_KW)
    jcfg, tcfg = jp.PhotometricDeviceConfig(**pcfg), tp.PhotometricDeviceConfig(**pcfg)
    jdesc, tdesc = jl.DescriptorLossConfig(**DESC), tl.DescriptorLossConfig(**DESC)
    model, jstate, tx = _jax_state("superpoint", seed=7)
    pstate = _port_state("superpoint", jstate)
    key = jax.random.PRNGKey(40)
    k_ph, _, k_loss = jax.random.split(jax.random.fold_in(key, 0), 3)
    draws = [jax_augment_draws(k, 2, H, W, jcfg)
             for k in jax.random.split(k_ph)]
    noise = [torch.from_numpy(np.array(jax.random.uniform(
        k, (2, H // G, W // G, 65), minval=0.0, maxval=0.1)))
        for k in jax.random.split(k_loss)]
    bases = []

    def fed_draws(gen, images, cfg, device_gen, mesh):
        assert mesh is None
        bases.append(images)
        return tp.photometric_from_draws(images, draws[len(bases) - 1], cfg)

    monkeypatch.setattr(tloop, "photometric_augment", fed_draws)
    monkeypatch.setattr(tloop, "_noise",
                        lambda gens, image, grid, mesh: noise.pop(0))

    jcfg_step = jloop.StepConfig(model=model, grid_size=G, include_mask=True,
                                 desc_cfg=jdesc, nerf_desc=True, pair=True,
                                 photometric=jcfg, pallas_desc=False)
    jnew, jmetrics = jloop.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jcfg_step, tx)
    tcfg_step = tloop.StepConfig(grid_size=G, include_mask=True,
                                 desc_cfg=tdesc, nerf_desc=True, pair=True,
                                 photometric=tcfg, blockwise_desc=False)
    metrics = tloop.train_step(pstate, _torch(batch), tcfg_step,
                               tloop.StepGenerators(0, "cpu"))
    assert len(bases) == 2 and not noise
    np.testing.assert_array_equal(bases[0].numpy(), batch["image"])
    np.testing.assert_array_equal(bases[1].numpy(), batch["image_warp"])
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    params = {k: v for k, v in tloop.model_params(pstate.model).items()}
    from spnerf_tpu_torch.tools.import_jax_weights import flax_params_to_torch
    want = flax_params_to_torch(pstate.model, _np_tree(jnew.params))
    for name, p in params.items():
        assert np.abs(p.detach().numpy() - want[name].numpy()).max() \
            <= 2.002 * LR, name


class _Tagged:
    """A loader that logs its tag for every batch it yields."""

    def __init__(self, loader, tag, log):
        self.loader, self.tag, self.log = loader, tag, log

    def __iter__(self):
        for batch in self.loader:
            self.log.append(self.tag)
            yield batch


def _tiny_nerf_config(**top):
    config = SMOKE._cut(SMOKE.NERF_TRAIN_CONFIG, {
        "data.all_data_dirs": ["A", "B"],
        "data.all_label_dirs": ["outputs/lab/A", "outputs/lab/B"],
        "data.augmentation.photometric.params.additive_shade"
        ".kernel_size_range": [9, 15],
        "model.vgg_cn": [8, 8, 16, 16, 32, 32, 32, 32],
        "model.detector_head.detector_dim": [32, 32],
        "model.descriptor_head.descriptor_dim": [32, 32],
        "train.num_iters": 4, "train.val_batches": 1,
        "save_or_validation_interval": 2, "log_every": 1,
        "ckpt_name": "tiny_nerf", "pretrained": None})
    config.update(top)
    return config


def test_train_nerf_cycles_the_scenes(roots):
    _write_scene("A", 4)
    _write_scene("B", 5)
    config = _tiny_nerf_config()
    loaders = factories.get_nerf_loaders(config)
    log = []
    train_loaders = [_Tagged(l, tag, log)
                     for l, tag in zip(loaders["train"], "AB")]
    val_log = []
    val_loaders = [_Tagged(l, tag, val_log)
                   for l, tag in zip(loaders["validation"], "AB")]
    state = train_task.train(config, train_loaders, val_loaders,
                             validate_training=True, nerf_loss=True,
                             train_nerf=True, seed=1, device="cpu")
    assert state.iteration == 4
    assert log[:4] == ["A", "B", "A", "B"]
    assert set(val_log) == {"A"}  # validation reads the first scene
    name = config["ckpt_name"]
    assert sorted(p.name for p in (roots / "ckpt_path" / name).glob("*.ckpt")) \
        == [f"{name}_2.ckpt", f"{name}_4.ckpt"]
    import json
    rows = [json.loads(line) for line in
            (roots / "ckpt_path" / name / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    assert all(np.isfinite(r["value"]) for r in rows)
    assert {"iter_loss/descriptor_loss", "val/val_loss"} <= {r["tag"]
                                                             for r in rows}
    # by default train() builds the loaders from the config itself
    again = train_task.train(dict(config, ckpt_name="tiny_again"),
                             nerf_loss=True, train_nerf=True, seed=1,
                             device="cpu")
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)


def test_chip_smoke_nerf_configs_are_the_config_files():
    """The NeRF dicts of ``chip_smoke.py`` equal the two config files; its
    cuts are the ones it lists."""
    for name, got in (("magicpoint_NeRF_export.yaml",
                       SMOKE.NERF_EXPORT_CONFIG),
                      ("superpoint_NeRF_train.yaml", SMOKE.NERF_TRAIN_CONFIG)):
        want = yaml.safe_load((ROOT / "spnerf_tpu/configs" / name).read_text())
        assert got == want, name
    assert set(SMOKE.NERF_CUTS) == {
        "data.all_data_dirs", "data.all_label_dirs", "train.num_iters",
        "save_or_validation_interval", "train.val_batches", "log_every",
        "pretrained"}
    assert set(SMOKE.NERF_EXPORT_CUTS) == {"pretrained"}
    cut = SMOKE._cut(SMOKE.NERF_TRAIN_CONFIG, SMOKE.NERF_CUTS)
    assert cut["data"]["all_data_dirs"] == list(SMOKE.NERF_SCENES)
    assert cut["model"] == SMOKE.NERF_TRAIN_CONFIG["model"]
