"""The port's process groups and data-parallel mesh
(``spnerf_tpu_torch/parallel/``) on the CPU: ``maybe_initialize_distributed``
and ``process_local_batch_slice`` against the JAX package's, the mesh's
rows, ``shard_batch`` and the loader's shard, and BatchNorm over two
ranks against one process and flax.

Ranks are processes of ``tools/smoke_dist.py`` joined by gloo on a
localhost store (``spawn_ranks``); they import nothing of JAX.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.models.superpoint import BatchNorm
from spnerf_tpu_torch.parallel import distributed, make_mesh, replicate, shard_batch
from spnerf_tpu_torch.parallel import mesh as dp
from spnerf_tpu_torch.tools.smoke_dist import spawn_ranks

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK")


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()


def test_no_group_without_torchrun_variables(no_torchrun, monkeypatch):
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.process_local_batch_slice(8) == (0, 8)
    assert make_mesh() == dp.Mesh()
    assert distributed.rank_device("cuda") == torch.device("cuda")
    # without a group every sum is the identity
    x = torch.arange(3.0)
    assert dp.psum(x, make_mesh()) is x and dp.batch_sum(x) is x
    with dp.data_parallel(make_mesh()):
        assert dp.batch_sum(x) is x
    assert replicate({"x": x}, make_mesh())["x"] is x


def test_an_existing_group_is_joined_not_made_again(no_torchrun, monkeypatch,
                                                    tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        # WORLD_SIZE 2 would start a second group (and wait for its peer)
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert distributed.maybe_initialize_distributed(device="cpu") is True
        mesh = make_mesh()
        assert (mesh.rank, mesh.size) == (0, 1) and mesh.group is not None
        assert distributed.rank_device("cuda") == torch.device("cuda", 0)
        monkeypatch.setenv("LOCAL_RANK", "3")
        assert distributed.rank_device("cuda") == torch.device("cuda", 3)
        assert distributed.rank_device("cuda:1") == torch.device("cuda", 1)
        assert distributed.rank_device("cpu") == torch.device("cpu")
        # the sums of a one-rank group run and change nothing
        x = torch.randn(5, requires_grad=True)
        y = dp.psum(x, mesh)
        assert y is not x and torch.equal(y, x)
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones(5))
        with dp.data_parallel(mesh):
            assert torch.equal(dp.batch_sum(x), x)
        metrics = {"a": torch.tensor(1.5), "b": torch.tensor(-2.0)}
        assert dp.sum_metrics(metrics, mesh) == metrics
        t = torch.randn(2, 3)
        assert torch.equal(dp.broadcast(t, mesh), t)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("B", [1, 7, 8, 13, 64])
def test_process_local_batch_slice_is_the_references(B, monkeypatch):
    import jax

    from spnerf_tpu.parallel.distributed import process_local_batch_slice

    for n in (1, 2, 3, 4):
        for i in range(n):
            monkeypatch.setattr(jax, "process_count", lambda: n)
            monkeypatch.setattr(jax, "process_index", lambda: i)
            monkeypatch.setattr(distributed, "process_count", lambda: n)
            monkeypatch.setattr(distributed, "process_index", lambda: i)
            assert distributed.process_local_batch_slice(B) == \
                process_local_batch_slice(B), (B, n, i)


def test_rows_shard_batch_and_loader_shard():
    batch = {"image": np.arange(12).reshape(6, 2), "name": list("abcdef"),
             "pair": {"t": torch.arange(6)}, "scalar": np.float32(2.0),
             "zero_d": np.array(3)}
    parts = [shard_batch(batch, dp.Mesh(r, 3)) for r in range(3)]
    assert [p["name"] for p in parts] == [["a", "b"], ["c", "d"], ["e", "f"]]
    np.testing.assert_array_equal(
        np.concatenate([p["image"] for p in parts]), batch["image"])
    assert torch.equal(torch.cat([p["pair"]["t"] for p in parts]),
                       torch.arange(6))
    assert all(p["scalar"] == 2.0 and p["zero_d"] == 3 for p in parts)
    assert shard_batch(batch, dp.Mesh()) is batch
    with pytest.raises(ValueError, match="does not split"):
        dp.Mesh(0, 4).rows(6)
    assert dp.global_rows(3, dp.Mesh(1, 2)) == (6, slice(3, 6))
    assert dp.global_rows(3, None) == (3, slice(None))

    data = [{"idx": np.int64(i)} for i in range(12)]
    loader = DataLoader(data, 4, shuffle=True, seed=5, drop_last=True)
    whole = [b["idx"].tolist() for b in loader]
    for n in (1, 2, 4):
        shards = [[b["idx"].tolist() for b in loader.shard(r, n)]
                  for r in range(n)]
        assert [sum(parts, []) for parts in zip(*shards)] == whole
    assert loader.shard_of == (0, 1)  # the shards are copies
    with pytest.raises(ValueError, match="does not split"):
        list(loader.shard(0, 3))


def test_batch_norm_over_two_ranks_is_one_process_and_flax(tmp_path):
    """The training forward over two ranks, each with two of the four
    images: output, input and parameter gradients and running statistics
    equal BatchNorm's on the whole batch (float32 sums in another order)
    and flax's, as ``test_torch_train.test_batch_norm_training_forward_is_
    flax`` holds the one-process module."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5, 6, 3)).astype(np.float32) * 2 + 1  # NHWC
    # different statistics on the two ranks' halves
    x[2:] = x[2:] * 3 - 2
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.uniform(-1, 1, 3).astype(np.float32)
    payload = {"x": x.transpose(0, 3, 1, 2).copy(), "weight": scale,
               "bias": bias, "running_mean": np.full(3, 0.3, np.float32),
               "running_var": np.full(3, 2.0, np.float32)}
    run = spawn_ranks("bn", 2, payload, tmp_path, threads=1)

    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.full((3,), 0.3),
                                 "var": jnp.full((3,), 2.0)}}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want_g = jax.grad(lambda v: jnp.sum(jnp.sin(bn.apply(
        variables, v, mutable=["batch_stats"])[0])))(jnp.asarray(x))

    mod = BatchNorm(3, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(mod, name).copy_(torch.from_numpy(payload[name]))
    xt = torch.from_numpy(payload["x"]).requires_grad_()
    out = mod(xt)
    torch.sin(out).sum().backward()

    ranks = run.wait()
    got = torch.cat([r["out"] for r in ranks])
    got_g = torch.cat([r["x_grad"] for r in ranks])
    torch.testing.assert_close(got, out.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_g, xt.grad, rtol=1e-5, atol=1e-6)
    for r in ranks:
        torch.testing.assert_close(r["weight_grad"], mod.weight.grad,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r["bias_grad"], mod.bias.grad,
                                   rtol=1e-5, atol=1e-6)
        for name in ("running_mean", "running_var"):
            assert torch.equal(r[name], ranks[0][name])
            torch.testing.assert_close(r[name], getattr(mod, name),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_g.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_g), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["running_mean"].numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["running_var"].numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
