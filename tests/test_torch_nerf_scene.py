"""The port's NeRF scene task (``spnerf_tpu_torch/tasks/nerf_task.py``)
against ``spnerf_tpu/tasks/nerf_task.py`` on the CPU, at a small config:
one training step with Adam, the training loop, and the rendered dataset.

Both sides start from JAX's weights (``nerf_from_jax``) and take JAX's
draws, split as the reference splits its keys.

Tolerances: a small step's losses within 1e-5 relative; Adam's first
moment (0.1 times the gradient) within 1e-4 of its largest entry;
parameters after the step within 1e-6 where the gradient is above 1e-3
of its largest (Adam's first step is lr times the gradient's sign there),
within 2 lr elsewhere; a full-width step as ``FULL_STEP_TOL`` states.
Rendered depth within 2e-5 (float32 sums in another order); transforms
equal; gray levels equal but for a stated share off by one (a mean of
rgb at a rounding edge).
"""

import importlib.util
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spnerf_tpu.models import nerf as jn
from spnerf_tpu.tasks import nerf_task as jt
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset, camera_intrinsics
from spnerf_tpu_torch.data.png import read_gray
from spnerf_tpu_torch.models import nerf as tn
from spnerf_tpu_torch.tasks import nerf_task as tt
from spnerf_tpu_torch.tools.import_jax_weights import nerf_from_jax
from test_torch_nerf_model import SMALL, image_draws, ray_draws

ROOT = Path(__file__).resolve().parents[1]
LR = 5e-3
# share of pixels allowed one gray level apart (a mean of rgb at a
# rounding edge); measured 0 of 576 in each view
GRAY_OFF_BY_ONE = 0.01


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages' DATA_PATH under ``tmp_path``: the port's in
    ``settings``, the reference's as imported by its NeRF task."""
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path / "port")
    monkeypatch.setattr(jt, "DATA_PATH", tmp_path / "jax")
    return tmp_path


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


# a full-width step (NeRFConfig(), near 0.5, far 4.5, 64 rays, lr 5e-4):
# (losses' relative tolerance, the norm-relative distance of Adam's first
# moment on the tensors off the sampler's gradient path
# (``chip_smoke.off_sampler``), the share of a tensor's largest moment
# above which its parameters are held within 1e-6). The coarse trunk and
# density head take a gradient through sample_pdf's 1 / (cdf_a - cdf_b),
# which bins of weight ~1e-5 make ill-conditioned: JAX and the port part
# by 16-32% of its norm there (float32; 56-89% in bf16), not held.
# Measured: float32 losses 1.6e-5, moments 2.2e-2, parameters 3e-8 above
# 0.1; bf16 1.9e-4, 6.7e-2, 3e-8
FULL_STEP_TOL = {"float32": (1e-4, 0.1, 0.1), "bfloat16": (1e-3, 0.2, 0.1)}
FULL_LR = 5e-4


@pytest.mark.parametrize("width,dtype", [("small", "float32"),
                                         ("full", "float32"),
                                         ("full", "bfloat16")])
def test_one_step_matches_jax(width, dtype):
    if width == "small":
        jcfg, tcfg, lr = jn.NeRFConfig(**SMALL), tn.NeRFConfig(**SMALL), LR
    else:
        jcfg = jn.NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
        tcfg = tn.NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
        lr = FULL_LR
    n = 64
    model, variables = jn.init_nerf(jax.random.PRNGKey(1), jcfg)
    port = nerf_from_jax(_np(variables), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tx = optax.adam(lr)
    key = jax.random.PRNGKey(4)
    params, opt_state, metrics = jt.nerf_train_step(
        model, jax.tree.map(jnp.array, variables), tx.init(variables), tx,
        key, o, d, target, jcfg)

    optimizer = tt.create_nerf_optimizer(port, lr)
    got = tt.nerf_train_step(port, optimizer, torch.from_numpy(o),
                             torch.from_numpy(d), torch.from_numpy(target),
                             tcfg, draws=ray_draws(key, n, tcfg))
    loss_tol = 1e-5 if width == "small" else FULL_STEP_TOL[dtype][0]
    for k in ("loss", "coarse", "fine"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=loss_tol, err_msg=k)
    want = nerf_from_jax(_np(params), tcfg, device="cpu")
    mu = nerf_from_jax(_np({"params": opt_state[0].mu["params"]}), tcfg,
                       device="cpu")
    for (name, p), q, m in zip(port.named_parameters(), want.parameters(),
                               mu.parameters()):
        m, got_mu = m.detach(), optimizer.state[p]["exp_avg"]
        diff = (p.detach() - q.detach()).abs()
        assert diff.max() <= 2.002 * lr, name
        if width == "small":
            assert (got_mu - m).abs().max() <= 1e-4 * m.abs().max(), name
            clear = m.abs() > 1e-3 * m.abs().max()
            assert clear.float().mean() > 0.5, name
        elif SMOKE.off_sampler(name):
            _, mu_tol, clear_at = FULL_STEP_TOL[dtype]
            assert (got_mu - m).norm() <= mu_tol * m.norm(), name
            clear = m.abs() > clear_at * m.abs().max()
        else:
            continue
        assert diff[clear].max() <= 1e-6, name


def _tiny_scene(smoke, frames=4, shape=(16, 20)):
    scene = smoke.box_room(5, shape=shape, fov=60,
                           frames={"training": frames, "validation": 1})
    rgb = np.repeat(scene["rgb"], 3, axis=-1)
    return rgb, scene["poses"], camera_intrinsics(shape, 60)


def test_train_nerf_scene_is_seeded_and_learns():
    """60 steps of 128 rays on a 16 x 20 box room: the same history and
    field twice under one seed, another under another seed, and a loss
    that falls."""
    rgb, poses, K = _tiny_scene(SMOKE)
    cfg = tn.NeRFConfig(**SMALL)
    kw = dict(num_iters=60, ray_batch=128, learning_rate=LR, log_every=20,
              device="cpu")
    model, history = tt.train_nerf_scene(rgb, poses, K, cfg, seed=3, **kw)
    again, history2 = tt.train_nerf_scene(rgb, poses, K, cfg, seed=3, **kw)
    other, history3 = tt.train_nerf_scene(rgb, poses, K, cfg, seed=4, **kw)
    assert len(history) == 3 and history == history2 != history3
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))
    assert history[-1] < history[0], history


def test_history_boundaries_match_jax():
    """The logged steps: chunk ends (min(log_every, 100) steps) that are
    multiples of log_every, and the last step."""
    import spnerf_tpu_torch.tasks.nerf_task as module

    seen = []

    def fake_steps(model, optimizer, pool, config, ray_batch, n_steps, gen):
        seen.append(n_steps)
        start = sum(seen[:-1])
        return torch.arange(start + 1, start + n_steps + 1, dtype=torch.float32)

    rgb = np.zeros((1, 2, 2, 3), np.float32)
    poses = np.eye(4, dtype=np.float32)[None]
    K = camera_intrinsics((2, 2), 60)
    cfg = tn.NeRFConfig(**SMALL)
    original = module.nerf_train_steps
    module.nerf_train_steps = fake_steps
    try:
        for num_iters, log_every, want in ((350, 150, [300, 350]),
                                           (90, 30, [30, 60, 90]),
                                           (20, 500, [20])):
            seen.clear()
            _, history = tt.train_nerf_scene(rgb, poses, K, cfg,
                                             num_iters=num_iters,
                                             log_every=log_every,
                                             device="cpu")
            assert history == want, (num_iters, log_every, history)
    finally:
        module.nerf_train_steps = original


def test_render_dataset_matches_jax(roots):
    """Two views at 24 x 24 (one chunk of 4,096 rays, padded) through both
    packages' ``render_dataset``, then the port's ``NeRFDataset``."""
    jcfg = jn.NeRFConfig(**SMALL, near=0.5, far=3.0)
    tcfg = tn.NeRFConfig(**SMALL, near=0.5, far=3.0)
    model, variables = jn.init_nerf(jax.random.PRNGKey(2), jcfg)
    port = nerf_from_jax(_np(variables), tcfg, device="cpu")
    poses = tt.pose_orbit(6, radius=1.0, height=0.2)[:2]
    K = camera_intrinsics((24, 24), 50)
    splits = {"training": [0], "validation": [1]}
    want_root = jt.render_dataset(model, variables, "Scene", poses, (24, 24),
                                  K, jcfg, splits, seed=6)
    key, draws = jax.random.PRNGKey(6), []
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append(image_draws(k, 24 * 24, 4096, tcfg))
    got_root = tt.render_dataset(port, "Scene", poses, (24, 24), K, tcfg,
                                 splits, draws=draws, device="cpu")
    assert got_root == Path(settings.DATA_PATH, "NeRF", "Scene")
    off = []
    for split in splits:
        for sub, name in (("camera_transforms", "0.npy"), ("depth", "0.npy"),
                          ("images", "0.png")):
            got, want = got_root / sub / split / name, \
                want_root / sub / split / name
            if sub == "images":
                g = read_gray(got).astype(int)
                w = cv2.imread(str(want), cv2.IMREAD_GRAYSCALE).astype(int)
                assert g.shape == w.shape == (24, 24)
                assert np.abs(g - w).max() <= 1
                off.append(np.mean(g != w))
            elif sub == "depth":
                np.testing.assert_allclose(np.load(got), np.load(want),
                                           rtol=0, atol=2e-5)
            else:
                assert np.array_equal(np.load(got), np.load(want))
    assert max(off) <= GRAY_OFF_BY_ONE, off

    for split, n in (("training", 1), ("validation", 1)):
        ds = NeRFDataset({"name": "NeRF", "data_dir": "Scene",
                          "warped_pair": False}, split)
        assert len(ds) == n
        sample = ds[0]
        assert sample["image"].shape == (24, 24, 1)
        assert np.array_equal(sample["depth"], np.load(
            got_root / "depth" / split / "0.npy"))
        np.testing.assert_allclose(
            np.concatenate([sample["rotation"], sample["translation"]], 1),
            poses[splits[split][0]][:3], rtol=0, atol=1e-7)


def test_write_scene_and_render_dataset_share_the_layout(roots):
    """``write_scene`` of a rendered view writes the files
    ``render_dataset`` wrote for it."""
    cfg = tn.NeRFConfig(**SMALL)
    port = tn.init_nerf(0, cfg, device="cpu")
    pose = tt.pose_orbit(3, radius=1.0)[:1]
    K = camera_intrinsics((8, 10), 60)
    root = tt.render_dataset(port, "A", pose, (8, 10), K, cfg, seed=1,
                             device="cpu")
    out = tn.render_image(port, (8, 10), K, pose[0], cfg,
                          generator=torch.Generator().manual_seed(1),
                          device="cpu")
    again = tt.write_scene("B", out["rgb"].numpy()[None],
                           out["depth"].numpy()[None], pose)
    for sub, name in (("images", "0.png"), ("depth", "0.npy"),
                      ("camera_transforms", "0.npy")):
        assert (root / sub / "training" / name).read_bytes() == \
            (again / sub / "training" / name).read_bytes(), sub
