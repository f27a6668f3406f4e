"""A data-parallel training step of the port over two ranks (gloo, CPU)
against the JAX package's ``train.loop.train_step`` on a 2-device mesh
and against the port's own step in one process.

The global batch of four images splits two and two. The JAX step shards
it over ``Mesh(jax.devices()[:2], ("data",))`` with the state
replicated; the port's ranks take JAX's prepared batch and tie-break
noise (drawn from the keys the JAX step splits), as
``test_torch_train.py`` feeds them, each rank its rows, and
``train.loop.apply_step`` sums over the ranks. Held against JAX's
one-device ``train_step`` at ``test_torch_train.py``'s tolerances, and
against its mesh step within those plus the mesh step's own difference
from the one-device step (``compare_to_jax``); against the one-process
``apply_step`` on the same inputs by ``smoke_dist.compare_steps``: every
metric within rtol 1e-6, the gradients within ``GRAD_TOL`` of the
tensor's largest entry, the parameters within 1e-3 lr where the gradient
is clear of rounding. The two halves' valid masks differ, so a rank that
normalised its descriptor loss by its own mask sum (with the gradients
then averaged, as DDP does) is caught: that case fails the same check.

``train_step`` itself runs too, with the port's own draws (photometric on
the device, homographies, noise) made for the global batch and cut to
each rank's rows: its two ranks against its one process; and
``train()`` over two ranks against one process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spnerf_tpu.geometry import homography as jh
from spnerf_tpu.train import loop as jloop
from spnerf_tpu.train import losses as jl
from spnerf_tpu.train import pipeline as jpipe
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.geometry import homography as th
from spnerf_tpu_torch.ops.photometric_device import PhotometricDeviceConfig
from spnerf_tpu_torch.tools.import_jax_weights import flax_params_to_torch
from spnerf_tpu_torch.tools.smoke_dist import (
    compare_steps,
    load_state,
    spawn_ranks,
    step_result,
)
from spnerf_tpu_torch.tasks import train_task
from spnerf_tpu_torch.train import loop as tloop
from spnerf_tpu_torch.train import losses as tl
from spnerf_tpu_torch.train import pipeline as tpipe
from test_torch_train import (
    DESC,
    G,
    H,
    LR,
    MODEL,
    PAIR_PARAMS,
    W,
    _host_batch,
    _jax_state,
    _np_tree,
    _port_state,
    _torch_batch,
    _torch_homographies,
    _train_config,
)

B = 4
RANKS = 2
METRIC_RTOL = 1e-6
# of the tensor's largest entry; measured: 6.7e-6 on the fed batch, 1.2e-5
# through train_step, whose photometric convolutions run on half batches
GRAD_TOL = 5e-5
STEP_TOL = 1e-3  # of lr, where the gradient is clear of rounding
# the gradient of a conv bias in front of BatchNorm: rounding noise (3e-5
# for the first block's in one process at this batch)
BIAS_GRAD_TOL = 1e-4
TRAIN_LOSS_RTOL = 1e-3


def _payload(name, pstate, cfg, **kw):
    fields = dict(MODEL, model_name=name)
    return dict(model=fields, state=tloop.checkpoint_payload(pstate), lr=LR,
                step_cfg=cfg, **kw)


def _jax_mesh_step(jstate, tx, jdata, key, jcfg):
    """``train_step`` on the 2-device mesh, the state replicated and the
    prepared batch sharded (no augmentation in the step: the batch is the
    one fed to the port); (new state, metrics, gradients)."""
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    state = jax.device_put(jax.tree.map(jnp.array, jstate),
                           NamedSharding(mesh, P()))
    sharded = jax.tree.map(
        lambda v: jax.device_put(v, NamedSharding(mesh, P("data"))), jdata)
    new, metrics = jloop.train_step(state, sharded, key, jcfg, tx)
    adam = new.opt_state[0]
    assert int(adam.count) == 1  # from a fresh Adam: mu = (1 - b1) g
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), adam.mu)
    return new, metrics, grads


def _rank_state(result, name):
    """Rank 0's state after its step, with the summed gradients."""
    state = load_state({"model": dict(MODEL, model_name=name),
                        "state": result["state"], "lr": LR}, "cpu")
    for k, p in state.model.named_parameters():
        p.grad = result["grads"][k]
    return state


def check_against_one_process(result, one, what):
    """``smoke_dist.compare_steps`` at this file's tolerances."""
    try:
        compare_steps(result, one, LR, METRIC_RTOL, GRAD_TOL, STEP_TOL,
                      BIAS_GRAD_TOL)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def _one_process(pstate, data, noise, cfg):
    """``apply_step`` in this process, from a copy of ``pstate``."""
    name = pstate.model.config.model_name
    state = load_state(_payload(name, pstate, cfg), "cpu")
    return step_result(state, tloop.apply_step(state, data, noise, cfg))


def _close(got, want, rtol, atol_of_max, what):
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def compare_to_jax(result, name, mesh, single):
    """The DP step against JAX's ``train_step`` on one device
    (``single``) at ``test_torch_train._compare_step``'s bounds (metrics
    rtol 1e-5; gradients and Adam's first moments rtol 1e-3 with atol
    1e-4 of the largest entry, second moments twice that; parameters
    within 2e-2 lr where the gradient is clear, Adam's step bound
    everywhere; running statistics rtol 1e-5, atol 1e-6; the conv biases
    in front of BatchNorm to ``BIAS_GRAD_TOL``), and against its mesh
    step, whose own difference from the one-device step is a few 1e-3 of
    the first blocks' gradients (max-pool and ReLU choices that sums in
    another order flip): within the same bounds plus that difference,
    element by element."""
    state = _rank_state(result, name)
    model = state.model
    for jnew, jmetrics, jgrads in (single, mesh):
        for k, v in jmetrics.items():
            np.testing.assert_allclose(result["metrics"][k], float(v),
                                       rtol=1e-5, err_msg=k)
    trees = [flax_params_to_torch(model, _np_tree(t)) for t in
             (single[2], mesh[2], single[0].params, mesh[0].params,
              single[0].opt_state[0].mu, single[0].opt_state[0].nu)]
    for k, p in model.named_parameters():
        g_one, g_mesh, p_one, p_mesh, mu, nu = (t[k].numpy() for t in trees)
        g, p = p.grad.numpy(), p.detach().numpy()
        st = state.optimizer.state[state.model.get_parameter(k)]
        assert int(st["step"]) == 1
        for want in (p_one, p_mesh):
            assert np.abs(p - want).max() <= 2.002 * LR, (name, k)
        if k.endswith("Conv_0.bias"):  # gradient 0 through BatchNorm
            assert np.abs(g).max() < BIAS_GRAD_TOL, (name, k)
            assert np.abs(g_one).max() < BIAS_GRAD_TOL, (name, k)
            continue
        _close(g, g_one, 1e-3, 1e-4, f"{name} grad {k}")
        _close(st["exp_avg"].numpy(), mu, 1e-3, 1e-4, f"{name} mu {k}")
        _close(st["exp_avg_sq"].numpy(), nu, 2e-3, 2e-4, f"{name} nu {k}")
        clear = np.abs(g_one) > 1e-3 * np.abs(g_one).max()
        assert clear.mean() > 0.5, (name, k)
        assert np.abs(p - p_one)[clear].max() <= 2e-2 * LR, (name, k)
        bound = (np.abs(g_one - g_mesh) + 1e-3 * np.abs(g_mesh)
                 + 1e-4 * np.abs(g_mesh).max())
        assert (np.abs(g - g_mesh) <= bound).all(), (name, k)
        slack = np.abs(p_one - p_mesh) + 2e-2 * LR
        assert (np.abs(p - p_mesh) <= slack)[clear].all(), (name, k)
    for jnew in (single[0], mesh[0]):
        for path, buf in tloop.model_batch_stats(model).items():
            *parts, leaf = path.split(".")
            node = jnew.batch_stats
            for part in parts:
                node = node[part]
            want = node["mean" if leaf == "running_mean" else "var"]
            np.testing.assert_allclose(buf.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=path)


def _jax_steps(jstate, tx, jdata, key, jcfg):
    """JAX's ``train_step`` on the mesh and on one device."""
    single = jloop.train_step(jax.tree.map(jnp.array, jstate), jdata, key,
                              jcfg, tx)
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                         single[0].opt_state[0].mu)
    return _jax_mesh_step(jstate, tx, jdata, key, jcfg), (*single, grads)


def test_two_rank_step_matches_jax_mesh_and_one_process(tmp_path,
                                                        monkeypatch):
    batch = _host_batch(2, B=B)
    hom = jh.HomographyConfig.from_dict(PAIR_PARAMS)
    key = jax.random.PRNGKey(11)
    _, k_aug, k_loss = jax.random.split(jax.random.fold_in(key, 0), 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    desc = tl.DescriptorLossConfig(**DESC)

    # SuperPoint with the blockwise descriptor loss, and MagicPoint: JAX's
    # prepared batch and noise, fed to both sides
    sp_model, sp_jstate, sp_tx = _jax_state("superpoint", seed=3)
    sp_jdata = jax.jit(jpipe.prepare_superpoint_batch, static_argnums=(2, 3))(
        k_aug, jbatch, hom, 3)
    sp_data = tpipe.prepare_superpoint_batch(_torch_homographies(k_aug, B),
                                             _torch_batch(batch), 3)
    sp_data["warp"]["image"] = torch.from_numpy(
        np.array(sp_jdata["warp"]["image"]))
    sp_noise = tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, (B, H // G, W // G, 65), minval=0.0, maxval=0.1)))
        for k in jax.random.split(k_loss))
    sp_cfg = tloop.StepConfig(grid_size=G, include_mask=True, pair=True,
                              desc_cfg=desc, blockwise_desc=True)
    # the ranks' halves hold different shares of valid cells
    cells = tl._cell_mask(sp_data["warp"]["valid_mask"], G).sum(dim=(1, 2))
    assert float(cells[:2].sum()) != float(cells[2:].sum())

    mp_model, mp_jstate, mp_tx = _jax_state("magicpoint", seed=5)
    mp_jdata = jax.jit(jpipe.prepare_detector_batch, static_argnums=(2, 3))(
        k_aug, jbatch, hom, 3)
    mp_data = tpipe.prepare_detector_batch(_torch_homographies(k_aug, B),
                                           _torch_batch(batch), 3)
    mp_data["image"] = torch.from_numpy(np.array(mp_jdata["image"]))
    mp_noise = torch.from_numpy(np.array(jax.random.uniform(
        k_loss, (B, H // G, W // G, 65), minval=0.0, maxval=0.1)))
    mp_cfg = tloop.StepConfig(grid_size=G, include_mask=True)

    # train_step with the port's own draws, photometric on the device
    step_cfg = tloop.StepConfig(
        grid_size=G, include_mask=True, pair=True, erosion=3, desc_cfg=desc,
        blockwise_desc=True, aug=th.HomographyConfig.from_dict(PAIR_PARAMS),
        photometric=PhotometricDeviceConfig(primitives=(
            "random_brightness", "additive_gaussian_noise",
            "additive_speckle_noise", "motion_blur")))

    cases = {"superpoint": (_port_state("superpoint", sp_jstate), sp_data,
                            sp_noise, sp_cfg),
             "magicpoint": (_port_state("magicpoint", mp_jstate), mp_data,
                            mp_noise, mp_cfg)}
    sp = _payload("superpoint", *cases["superpoint"][::3], data=sp_data,
                  noise=sp_noise)
    jobs = [("apply", sp), ("apply", dict(sp, local=True)),
            ("apply", _payload("magicpoint", *cases["magicpoint"][::3],
                               data=mp_data, noise=mp_noise)),
            ("step", _payload("superpoint", cases["superpoint"][0], step_cfg,
                              seed=4, batch=batch))]
    # the trainer: two steps over two batches, a checkpoint at the second
    train_config = _train_config(num_iters=2, log_every=1,
                                 save_or_validation_interval=2)
    batches = [dict(_host_batch(s, B=B), name=np.array(list("abcd")))
               for s in (5, 6)]
    jobs.append(("train", {"config": train_config, "batches": batches,
                           "seed": 1, "CKPT_PATH": str(tmp_path / "train")}))
    run = spawn_ranks("multi", RANKS, {"jobs": jobs}, tmp_path, threads=2)

    # while the ranks run: JAX's steps, and the port's in one process
    jax_steps = {
        "superpoint": _jax_steps(sp_jstate, sp_tx, sp_jdata, key,
                                 jloop.StepConfig(
                                     model=sp_model, grid_size=G,
                                     include_mask=True,
                                     desc_cfg=jl.DescriptorLossConfig(**DESC),
                                     pair=True, pallas_desc=True)),
        "magicpoint": _jax_steps(mp_jstate, mp_tx, mp_jdata, key,
                                 jloop.StepConfig(model=mp_model, grid_size=G,
                                                  include_mask=True))}
    ones = {name: _one_process(*case) for name, case in cases.items()}
    state = load_state(_payload("superpoint", cases["superpoint"][0],
                                step_cfg), "cpu")
    step_one = step_result(state, tloop.train_step(
        state, _torch_batch(batch), step_cfg, tloop.StepGenerators(4, "cpu")))

    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path / "one")
    trained = train_task.train(train_config, batches, seed=1, device="cpu")
    ckpt = train_config["ckpt_name"]
    logged = {r["step"]: r["value"] for r in map(json.loads, (
        tmp_path / "one" / ckpt / "logs" / "metrics.jsonl").read_text()
        .splitlines()) if r["tag"] == "iter_loss/loss"}

    ranks = run.wait()
    sp_global, sp_local, mp_global, step, train = zip(*ranks)
    for results in (sp_global, sp_local, mp_global, step, train):
        for key_ in ("params", "batch_stats"):  # the ranks agree to the bit
            for k, v in results[0]["state"][key_].items():
                assert torch.equal(v, results[1]["state"][key_][k]), k

    for name, result in (("superpoint", sp_global[0]),
                         ("magicpoint", mp_global[0])):
        check_against_one_process(result, ones[name], name)
        compare_to_jax(result, name, *jax_steps[name])
    check_against_one_process(step[0], step_one, "train_step")
    # a per-rank normaliser is caught
    assert abs(sp_local[0]["metrics"]["descriptor_loss"]
               - sp_global[0]["metrics"]["descriptor_loss"]) \
        > 1e-3 * sp_global[0]["metrics"]["descriptor_loss"]
    with pytest.raises(AssertionError):
        check_against_one_process(sp_local[0], ones["superpoint"], "local")

    # the trainer over two ranks: rank 0 alone writes; the losses it logs
    # are the one process's, the first step's within METRIC_RTOL, the second
    # (from parameters that Adam moved apart where the first gradient was
    # rounding) within TRAIN_LOSS_RTOL; the parameters within two steps
    assert train[1]["written"] == []
    assert set(train[0]["written"]) == {f"{ckpt}/{ckpt}_2.ckpt",
                                        f"{ckpt}/logs/metrics.jsonl"}
    assert sorted(train[0]["metrics"]) == sorted(logged) == [1, 2]
    assert abs(train[0]["metrics"][1] - logged[1]) <= METRIC_RTOL * logged[1]
    assert abs(train[0]["metrics"][2] - logged[2]) <= \
        TRAIN_LOSS_RTOL * logged[2]
    for k, v in trained.model.named_parameters():
        diff = float((train[0]["state"]["params"][k] - v.detach()).abs().max())
        assert diff <= 2 * 2.002 * LR, k
