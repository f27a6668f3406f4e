"""The training slice of the port as a whole against the JAX package on
the CPU: batch preparation, the SuperPoint and MagicPoint steps with
Adam, and the trainer with checkpoints.

Both sides start from one flax state (weights, BatchNorm statistics and,
for the second step, Adam moments) carried into the port by
``tools.import_jax_weights.train_state_from_flax``; the port's batch is
prepared from the homography draws JAX makes from its key, and its
detector losses take the tie-break noise JAX draws. The Pallas descriptor
loss runs in interpret mode; the port's wrapper runs its plain version.

The port's prepared batch is held against JAX's (heatmaps and masks
equal, homographies and images within 1e-4), and then the step takes
JAX's warped image: the two float32 homography solves differ by 1e-4,
that moves a few warped pixels by 2e-5, and such a pixel flips a ReLU or
a max-pool choice in the first blocks (measured: 1e-3 of their gradients,
the loss unmoved). With the same image the steps agree to rounding.

Tolerances (float32 sums in another order on both sides): losses and
metrics rtol 1e-5; gradients and Adam's first moments rtol 1e-3 with atol
1e-4 of the tensor's largest entry (measured 1e-5 of it), second moments
twice that; BatchNorm running statistics rtol 1e-5, atol 1e-6. A conv
bias in front of a training-mode BatchNorm has gradient 0, both sides
compute rounding noise (1e-7) for it, and Adam's step lr * g / (|g| +
1e-8) turns that noise into a move of up to lr in either direction on
both sides: those biases are held to |g| < 1e-5 and to the step's bound.
Every other parameter is held to 2e-2 * lr wherever |g| is above 1e-3 of
the tensor's largest (elsewhere the step's size depends on g's rounding),
and to the step's bound, 2.002 * lr, everywhere.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import flax_superpoint, jax_homography_draws
from spnerf_tpu.geometry import homography as jh
from spnerf_tpu.models.superpoint import SuperPointConfig as JCfg
from spnerf_tpu.train import loop as jloop
from spnerf_tpu.train import losses as jl
from spnerf_tpu.train import pipeline as jpipe
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.geometry import homography as th
from spnerf_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from spnerf_tpu_torch.tasks import train_task
from spnerf_tpu_torch.tools.import_jax_weights import (
    flax_params_to_torch,
    train_state_from_flax,
)
from spnerf_tpu_torch.train import loop as tloop
from spnerf_tpu_torch.train import losses as tl
from spnerf_tpu_torch.train import pipeline as tpipe

ROOT = Path(__file__).resolve().parents[1]
H, W, G = 64, 80, 8
LR = 1e-3
MODEL = dict(vgg_cn=(8, 8, 16, 16, 32, 32, 32, 32), detector_dim=(32, 32),
             descriptor_dim=(32, 32))
PAIR_PARAMS = dict(translation=True, rotation=True, scaling=True,
                   perspective=True, scaling_amplitude=0.2, n_scales=5,
                   n_angles=25, perspective_amplitude_x=0.2,
                   perspective_amplitude_y=0.2, patch_ratio=0.85,
                   max_angle=1.57, allow_artifacts=True,
                   translation_overflow=0.0)
DESC = dict(grid_size=G, lambda_d=250, lambda_loss=1e-4, positive_margin=1.0,
            negative_margin=0.2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _host_batch(seed, B=2, n_pts=30):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (B, H // 8, W // 8))
    image = np.kron(coarse, np.ones((8, 8))) + 0.1 * rng.uniform(size=(B, H, W))
    kpts = rng.uniform(0, [H, W], (B, n_pts, 2)).astype(np.float32)
    mask = np.ones((B, n_pts), bool)
    mask[:, -5:] = False
    return {"image": np.clip(image, 0, 1).astype(np.float32)[..., None],
            "kpts": kpts, "kpts_mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _torch_homographies(key, B):
    """The homographies jax's homographic_augment samples from ``key``."""
    cfg = jh.HomographyConfig.from_dict(PAIR_PARAMS)
    draws = [jax_homography_draws(k, cfg) for k in jax.random.split(key, B)]
    batched = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    return th.homography_from_draws(batched, (H, W),
                                    th.HomographyConfig.from_dict(PAIR_PARAMS))


def _assert_prepared_equal(got: dict, want: dict):
    # the two float32 DLT solves agree to 1e-4, which moves a source
    # coordinate by up to some 1e-4 pixel on an image with steps
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=1e-4)
    for key in ("kpts_heatmap", "valid_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert 0 < np.asarray(want[key]).sum() < np.asarray(want[key]).size or \
            key == "valid_mask"


def test_prepare_superpoint_batch_fed_jax_draws():
    batch = _host_batch(0)
    key = jax.random.PRNGKey(1)
    want = jpipe.prepare_superpoint_batch(
        key, {k: jnp.asarray(v) for k, v in batch.items()},
        jh.HomographyConfig.from_dict(PAIR_PARAMS), erosion=3)
    homs = _torch_homographies(key, 2)
    got = tpipe.prepare_superpoint_batch(homs, _torch_batch(batch), erosion=3)
    np.testing.assert_allclose(got["homography"].numpy(),
                               np.asarray(want["homography"]), atol=1e-4,
                               rtol=1e-4)
    _assert_prepared_equal(got["raw"], want["raw"])
    _assert_prepared_equal(got["warp"], want["warp"])
    assert np.asarray(want["warp"]["valid_mask"]).min() == 0
    # the warped view is made from image_warp_src where the batch has one
    src = dict(_torch_batch(batch), image_warp_src=torch.zeros((2, H, W, 1)))
    assert float(tpipe.prepare_superpoint_batch(homs, src)["warp"]["image"]
                 .abs().max()) == 0.0


@pytest.mark.parametrize("augment", [True, False], ids=["warped", "raw"])
def test_prepare_detector_batch_fed_jax_draws(augment):
    batch = _host_batch(1)
    key = jax.random.PRNGKey(2)
    cfg = jh.HomographyConfig.from_dict(PAIR_PARAMS) if augment else None
    want = jpipe.prepare_detector_batch(
        key, {k: jnp.asarray(v) for k, v in batch.items()}, cfg, erosion=2)
    homs = _torch_homographies(key, 2) if augment else None
    got = tpipe.prepare_detector_batch(homs, _torch_batch(batch), erosion=2)
    assert set(got) == {"image", "kpts_heatmap", "valid_mask"}
    _assert_prepared_equal(got, want)


# ---------------------------------------------------------------- the steps


def _jax_state(model_name, seed):
    cfg = JCfg(model_name=model_name, **MODEL)
    model, variables = flax_superpoint(cfg, (1, H, W, 1), seed=seed)
    state, tx = jloop.create_train_state(
        jax.tree.map(jnp.asarray, variables), LR)
    return model, state, tx


def _jax_step_fn(tx, loss_fn):
    """A jitted Adam step of ``loss_fn(params, batch_stats, *args)``:
    (state, *args) -> (new state, metrics, gradients)."""
    @jax.jit
    def step(state, *args):
        (_, (bs, metrics)), grads = jax.value_and_grad(
            lambda p: loss_fn(p, state.batch_stats, *args), has_aux=True)(
                state.params)
        updates, opt = tx.update(grads, state.opt_state, state.params)
        new = jloop.TrainState(
            params=optax.apply_updates(state.params, updates), batch_stats=bs,
            opt_state=opt, iteration=state.iteration + 1)
        return new, metrics, grads
    return step


def _port_state(model_name, jstate):
    """The JAX state carried into the port."""
    model = SuperPoint(SuperPointConfig(model_name=model_name, **MODEL))
    adam = jstate.opt_state[0]
    return train_state_from_flax(
        model, {"params": _np_tree(jstate.params),
                "batch_stats": _np_tree(jstate.batch_stats)},
        _np_tree(adam.mu), _np_tree(adam.nu), int(adam.count),
        int(jstate.iteration), LR)


def _close(got, want, rtol, atol_of_max, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _compare_step(pstate, metrics, jstate_new, jmetrics, jgrads):
    model = pstate.model
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    grads = flax_params_to_torch(model, _np_tree(jgrads))
    params = flax_params_to_torch(model, _np_tree(jstate_new.params))
    adam = jstate_new.opt_state[0]
    mu = flax_params_to_torch(model, _np_tree(adam.mu))
    nu = flax_params_to_torch(model, _np_tree(adam.nu))
    for name, p in model.named_parameters():
        st = pstate.optimizer.state[p]
        assert int(st["step"]) == int(adam.count)
        diff = np.abs(p.detach().numpy() - params[name].numpy())
        assert diff.max() <= 2.002 * LR, name
        g = grads[name].numpy()
        if name.endswith("Conv_0.bias"):  # gradient 0 through BatchNorm
            assert np.abs(g).max() < 1e-5 and float(p.grad.abs().max()) < 1e-5
            continue
        _close(p.grad, g, 1e-3, 1e-4, f"grad {name}")
        _close(st["exp_avg"], mu[name], 1e-3, 1e-4, f"mu {name}")
        _close(st["exp_avg_sq"], nu[name], 2e-3, 2e-4, f"nu {name}")
        clear = np.abs(g) > 1e-3 * np.abs(g).max()
        assert clear.mean() > 0.5, name
        assert diff[clear].max() <= 2e-2 * LR, name
    stats = tloop.model_batch_stats(model)
    assert len(stats) == len(jax.tree.leaves(jstate_new.batch_stats))
    for name, buf in stats.items():
        *path, leaf = name.split(".")
        node = jstate_new.batch_stats
        for part in path:
            node = node[part]
        want = node["mean" if leaf == "running_mean" else "var"]
        np.testing.assert_allclose(buf.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("blockwise", [True, False], ids=["blockwise", "dense"])
def test_two_superpoint_steps_match_jax(blockwise):
    batch = _host_batch(2)
    jcfg = jh.HomographyConfig.from_dict(PAIR_PARAMS)
    jdesc, tdesc = jl.DescriptorLossConfig(**DESC), tl.DescriptorLossConfig(**DESC)
    model, jstate, tx = _jax_state("superpoint", seed=3)
    jstep = _jax_step_fn(tx, lambda p, bs, d, k: jloop.superpoint_loss_fn(
        p, bs, model, d, k, G, True, jdesc, False, True, blockwise))
    for step in range(2):
        k_aug, k_loss = jax.random.split(jax.random.PRNGKey(10 + step))
        jdata = jpipe.prepare_superpoint_batch(
            k_aug, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, 3)
        pstate = _port_state("superpoint", jstate)
        assert pstate.iteration == step
        jnew, jmetrics, jgrads = jstep(jstate, jdata, k_loss)

        data = tpipe.prepare_superpoint_batch(_torch_homographies(k_aug, 2),
                                              _torch_batch(batch), 3)
        _assert_prepared_equal(data["warp"], jdata["warp"])
        data["warp"]["image"] = torch.from_numpy(
            np.array(jdata["warp"]["image"]))
        noise = tuple(torch.from_numpy(np.array(jax.random.uniform(
            k, (2, H // G, W // G, 65), minval=0.0, maxval=0.1)))
            for k in jax.random.split(k_loss))
        pstate.optimizer.zero_grad(set_to_none=True)
        loss, metrics = tloop.superpoint_loss_fn(
            pstate.model, data, noise, G, True, tdesc, False, True, blockwise)
        loss.backward()
        pstate.optimizer.step()
        _compare_step(pstate, metrics, jnew, jmetrics, jgrads)
        jstate = jnew


def test_magicpoint_step_matches_jax():
    batch = _host_batch(4)
    model, jstate, tx = _jax_state("magicpoint", seed=5)
    k_aug, k_loss = jax.random.split(jax.random.PRNGKey(20))
    jdata = jpipe.prepare_detector_batch(
        k_aug, {k: jnp.asarray(v) for k, v in batch.items()},
        jh.HomographyConfig.from_dict(PAIR_PARAMS), 3)
    pstate = _port_state("magicpoint", jstate)
    jnew, jmetrics, jgrads = _jax_step_fn(
        tx, lambda p, bs, d, k: jloop.magicpoint_loss_fn(
            p, bs, model, d, k, G, True, True))(jstate, jdata, k_loss)
    data = tpipe.prepare_detector_batch(_torch_homographies(k_aug, 2),
                                        _torch_batch(batch), 3)
    _assert_prepared_equal(data, jdata)
    data["image"] = torch.from_numpy(np.array(jdata["image"]))
    noise = torch.from_numpy(np.array(jax.random.uniform(
        k_loss, (2, H // G, W // G, 65), minval=0.0, maxval=0.1)))
    pstate.optimizer.zero_grad(set_to_none=True)
    loss, metrics = tloop.magicpoint_loss_fn(pstate.model, data, noise, G,
                                             True, True)
    loss.backward()
    pstate.optimizer.step()
    _compare_step(pstate, metrics, jnew, jmetrics, jgrads)


def test_batch_norm_training_forward_is_flax():
    """Output, gradient and running statistics of one training forward
    against flax's BatchNorm (biased variance into the running variance;
    ``nn.BatchNorm2d`` would put n / (n - 1) = 1.07 times as much)."""
    from flax import linen as nn

    from spnerf_tpu_torch.models.superpoint import BatchNorm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32) * 2 + 1  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 4), rng.uniform(-1, 1, 4)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                            "bias": jnp.asarray(bias, jnp.float32)},
                 "batch_stats": {"mean": jnp.full((4,), 0.3),
                                 "var": jnp.full((4,), 2.0)}}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want_g = jax.grad(lambda v: jnp.sum(jnp.sin(bn.apply(
        variables, v, mutable=["batch_stats"])[0])))(jnp.asarray(x))

    mod = BatchNorm(4, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale.astype(np.float32)))
        mod.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
        mod.running_mean.fill_(0.3)
        mod.running_var.fill_(2.0)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = mod(xt)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_g), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    biased = x.reshape(-1, 4).var(axis=0)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               0.9 * 2.0 + 0.1 * biased, rtol=1e-5)
    # eval mode normalises with the running statistics and leaves them
    before = mod.running_var.clone()
    mod.eval()(xt.detach())
    assert torch.equal(mod.running_var, before)


# -------------------------------------------------------------- the trainer


def _train_config(model_name="superpoint", num_iters=6, **top):
    config = {
        "data": {"augmentation": {
            "photometric": {
                "enable": True, "on_device": True, "primitives": "all",
                "params": {"additive_shade": {"kernel_size_range": [9, 15]}}},
            "homographic": {"enable": True, "params": PAIR_PARAMS,
                            "valid_border_margin": 3},
            "pair_homography": {"params": PAIR_PARAMS,
                                "valid_border_margin": 3}}},
        "model": {"model_name": model_name, "vgg_cn": list(MODEL["vgg_cn"]),
                  "detector_head": {"detector_dim": [32, 32], "grid_size": G,
                                    "det_thresh": 0.001},
                  "descriptor_head": dict(DESC, descriptor_dim=[32, 32])},
        "train": {"num_iters": num_iters, "learning_rate": LR,
                  "pallas_desc_loss": True, "val_batches": 1},
        "save_or_validation_interval": 3, "log_every": 2,
        "ckpt_name": f"tiny_{model_name}",
    }
    config.update(top)
    return config


def _metrics(ckpt_root, name):
    import json
    lines = (ckpt_root / name / "logs" / "metrics.jsonl").read_text()
    return [json.loads(line) for line in lines.splitlines()]


@pytest.fixture
def ckpt_root(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path)
    return tmp_path


def test_train_checkpoints_validates_and_resumes(ckpt_root):
    batches = [dict(_host_batch(s), name=np.array(["a", "b"]))
               for s in range(3)]
    config = _train_config()
    state = train_task.train(config, batches, val_loader=batches,
                             validate_training=True, seed=1, device="cpu")
    assert state.iteration == 6
    name = config["ckpt_name"]
    assert sorted(p.name for p in (ckpt_root / name).glob("*.ckpt")) == [
        f"{name}_3.ckpt", f"{name}_6.ckpt"]
    rows = _metrics(ckpt_root, name)
    tags = {r["tag"] for r in rows}
    assert {"iter_loss/loss", "iter_loss/descriptor_loss", "val/precision",
            "val/recall", "val/val_loss", "running_loss/train",
            "perf/steps_per_sec"} <= tags
    assert sorted({r["step"] for r in rows if r["tag"] == "iter_loss/loss"}) \
        == [2, 3, 4, 6]
    assert all(np.isfinite(r["value"]) for r in rows)

    saved = tloop.load_checkpoint(ckpt_root / name / f"{name}_6.ckpt")
    assert saved["iteration"] == 6
    assert set(saved) == {"iteration", "params", "batch_stats", "opt_state"}
    for k, v in tloop.model_params(state.model).items():
        assert torch.equal(saved["params"][k], v.detach())
    for k, v in tloop.model_batch_stats(state.model).items():
        assert torch.equal(saved["batch_stats"][k], v)
    assert len(saved["opt_state"]["state"]) == len(saved["params"])
    assert int(saved["opt_state"]["state"][0]["step"]) == 6

    # the same seed repeats the run to the bit: every draw is seeded from
    # (seed, iteration)
    config_b = _train_config(ckpt_name="tiny_again")
    again = train_task.train(config_b, batches, seed=1, device="cpu")
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)

    # continue_training: from step 3's checkpoint on to step 5
    resume = _train_config(num_iters=5, ckpt_name="tiny_resumed",
                           pretrained=f"{name}/{name}_3.ckpt",
                           continue_training=True)
    resumed = train_task.train(resume, batches, seed=1, device="cpu")
    assert resumed.iteration == 5
    assert [p.name for p in (ckpt_root / "tiny_resumed").glob("*.ckpt")] == [
        "tiny_resumed_5.ckpt"]
    steps = {r["step"] for r in _metrics(ckpt_root, "tiny_resumed")}
    assert min(steps) == 4 and max(steps) == 5
    # without continue_training the weights are taken, the count is not
    fresh = dict(resume, continue_training=False, ckpt_name="tiny_fresh",
                 train=dict(resume["train"], num_iters=1))
    assert train_task.train(fresh, batches, seed=1,
                            device="cpu").iteration == 1


def test_partial_restore_seeds_superpoint_from_magicpoint(ckpt_root):
    batches = [_host_batch(7)]
    mp_cfg = _train_config("magicpoint", num_iters=2,
                           save_or_validation_interval=2)
    mp = train_task.train(mp_cfg, batches, seed=2, device="cpu")
    name = mp_cfg["ckpt_name"]
    sp_cfg = _train_config(num_iters=0, pretrained=f"{name}/{name}_2.ckpt")
    sp = train_task.train(sp_cfg, batches, seed=3, device="cpu")
    assert sp.iteration == 0
    mp_params, sp_params = (tloop.model_params(m.model) for m in (mp, sp))
    mp_stats, sp_stats = (tloop.model_batch_stats(m.model) for m in (mp, sp))
    assert set(mp_params) < set(sp_params)
    for k, v in mp_params.items():
        assert torch.equal(sp_params[k], v), k
    for k, v in mp_stats.items():
        assert torch.equal(sp_stats[k], v), k
    # the descriptor head has no counterpart: it keeps its seeded weights
    own = train_task.init_superpoint(
        3, SuperPointConfig.from_dict(sp_cfg["model"]), device="cpu")
    for k, v in tloop.model_params(own).items():
        if k.startswith("descriptor."):
            assert torch.equal(sp_params[k], v), k
    # a shape that does not match is left alone
    target = {"w": torch.zeros(3), "v": torch.zeros(2)}
    restored = tloop.partial_restore(target, {"w": torch.ones(3),
                                              "v": torch.ones(5),
                                              "u": torch.ones(1)})
    assert restored == ["w"]
    assert target["w"].tolist() == [1, 1, 1] and target["v"].tolist() == [0, 0]


def test_build_step_config_matches_reference():
    for name in ("superpoint", "magicpoint"):
        config = _train_config(name)
        got = train_task.build_step_config(config, include_mask=True)
        from spnerf_tpu.tasks.train_task import build_step_config
        want = build_step_config(config, None, True)
        assert got.pair == want.pair and got.erosion == want.erosion == 3
        assert got.blockwise_desc == want.pallas_desc
        assert got.det_thresh == want.det_thresh
        assert got.grid_size == want.grid_size
        assert vars(got.aug) == vars(want.aug)
        assert vars(got.photometric) == vars(want.photometric)
        assert vars(got.desc_cfg) == vars(want.desc_cfg)


def test_step_generators_depend_on_seed_and_key_only():
    a, b = tloop.StepGenerators(5, "cpu"), tloop.StepGenerators(5, "cpu")
    a.reseed(0, 7)
    first = (torch.rand(4, generator=a.cpu), torch.rand(4, generator=a.device))
    torch.rand(100, generator=b.cpu)  # history does not matter
    b.reseed(0, 7)
    assert torch.equal(first[0], torch.rand(4, generator=b.cpu))
    assert torch.equal(first[1], torch.rand(4, generator=b.device))
    b.reseed(0, 8)
    assert not torch.equal(first[0], torch.rand(4, generator=b.cpu))
    c = tloop.StepGenerators(6, "cpu")
    c.reseed(0, 7)
    assert not torch.equal(first[0], torch.rand(4, generator=c.cpu))


def test_loader_shuffles_and_cycles_like_the_reference():
    from spnerf_tpu.data.loader import DataLoader as JLoader
    from spnerf_tpu_torch.data.loader import DataLoader

    data = [{"idx": np.int64(i)} for i in range(10)]
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, seed=4, drop_last=False)):
        want = [b["idx"].tolist() for b in JLoader(data, 4, **kw)]
        got = [b["idx"].tolist() for b in DataLoader(data, 4, **kw)]
        assert got == want
    it = iter(DataLoader(data, 4, shuffle=True, seed=3, infinite=True))
    jt = iter(JLoader(data, 4, shuffle=True, seed=3, infinite=True))
    got = [next(it)["idx"].tolist() for _ in range(7)]  # into epoch 4
    assert got == [next(jt)["idx"].tolist() for _ in range(7)]
    it.close()
    jt.close()
    # iter_forever cycles a finite loader
    stream = train_task.iter_forever(DataLoader(data, 5))
    assert [next(stream)["idx"][0] for _ in range(5)] == [0, 5, 0, 5, 0]
    stream.close()


def test_device_prefetch_and_to_device_on_the_cpu():
    batches = iter([{"image": np.zeros((1, 8, 8, 1), np.float32),
                     "name": np.array(["x"]), "names": ["x"],
                     "kpts_mask": np.ones((1, 3), bool)}] * 3)
    stream = train_task.device_prefetch(lambda: next(batches), "cpu")
    out = next(stream)
    assert set(out) == {"image", "kpts_mask"}
    assert out["image"].dtype == torch.float32
    assert out["kpts_mask"].dtype == torch.bool
    stream.close()


def test_train_runs_on_the_card_unless_asked_for_the_cpu(ckpt_root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_task.train(_train_config(), [_host_batch(0)])


def test_chip_smoke_trains_the_config_file():
    """The dict ``chip_smoke.py`` trains equals ``superpoint_coco_train
    .yaml`` apart from the cuts it lists."""
    import yaml

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = yaml.safe_load(
        (ROOT / "spnerf_tpu/configs/superpoint_coco_train.yaml").read_text())
    got = smoke.train_config()
    cuts = smoke.TRAIN_CUTS
    assert set(cuts) == {"train.num_iters", "save_or_validation_interval",
                         "pretrained", "train.val_batches", "log_every"}
    for dotted, value in cuts.items():
        node_w, node_g = want, got
        *path, leaf = dotted.split(".")
        for part in path:
            node_w, node_g = node_w[part], node_g[part]
        assert node_g[leaf] == value
        node_w[leaf] = value
    assert got == want
