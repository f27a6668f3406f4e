"""Carry weights of the flax SuperPoint, of the tiny NeRF field and of
the scene NeRFs (``models/nerf``, ``models/hash_nerf``; as numpy trees)
into the port.

The flax tree nests ``params/<head>/<block>/Conv_0/{kernel, bias}`` with
HWIO kernels, and ``BatchNorm_0/{scale, bias}`` beside running stats in
``batch_stats``. The torch module keeps the same paths with OIHW
kernels. Nothing here imports JAX: callers hand over numpy arrays
(``jax.tree.map(np.asarray, variables)``).
"""

from __future__ import annotations

import numpy as np
import torch

from spnerf_tpu_torch.device import resolve_device
from spnerf_tpu_torch.models.hash_nerf import HashNeRF, HashNeRFConfig
from spnerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from spnerf_tpu_torch.models.superpoint import SuperPoint, conv_blocks
from spnerf_tpu_torch.ops.serving import ServingSuperPoint
from spnerf_tpu_torch.train.loop import TrainState, create_train_state


def _node(tree: dict, path: str) -> dict:
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@torch.no_grad()
def load_flax_variables(model: SuperPoint, variables: dict) -> SuperPoint:
    """Copy a flax ``{'params', 'batch_stats'}`` numpy tree into ``model``
    (in place) and return it."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    for path, block in conv_blocks(model).items():
        node = _node(params, path)
        conv = block.Conv_0
        conv.weight.copy_(_t(node["Conv_0"]["kernel"]).permute(3, 2, 0, 1))
        conv.bias.copy_(_t(node["Conv_0"]["bias"]))
        if block.BatchNorm_0 is not None:
            bn, st = block.BatchNorm_0, _node(stats, path)["BatchNorm_0"]
            bn.weight.copy_(_t(node["BatchNorm_0"]["scale"]))
            bn.bias.copy_(_t(node["BatchNorm_0"]["bias"]))
            bn.running_mean.copy_(_t(st["mean"]))
            bn.running_var.copy_(_t(st["var"]))
    return model


def _block_params(prefix: str, node: dict, with_bn: bool) -> dict:
    """One flax VGG block's parameters -> {torch path: float32 tensor}."""
    out = {f"{prefix}.Conv_0.weight": _t(
               node["Conv_0"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
           f"{prefix}.Conv_0.bias": _t(node["Conv_0"]["bias"])}
    if with_bn:
        out[f"{prefix}.BatchNorm_0.weight"] = _t(node["BatchNorm_0"]["scale"])
        out[f"{prefix}.BatchNorm_0.bias"] = _t(node["BatchNorm_0"]["bias"])
    return out


def flax_params_to_torch(model: SuperPoint, params: dict) -> dict:
    """A flax ``params``-shaped numpy tree (the parameters, their
    gradients or an Adam moment) -> {torch parameter path: float32 tensor
    in the torch layout} for ``model``'s parameters."""
    out = {}
    for path, block in conv_blocks(model).items():
        out.update(_block_params(path.replace("/", "."), _node(params, path),
                                 block.BatchNorm_0 is not None))
    return out


def flax_checkpoint_to_torch(data: dict) -> dict:
    """A checkpoint the JAX package wrote, as ``train.loop.load_checkpoint``
    decodes it -> the payload the port's own checkpoints hold:
    {"iteration", "params", "batch_stats"} with torch paths and layouts,
    for every block the checkpoint has (a MagicPoint checkpoint has no
    descriptor head; ``partial_restore`` matches by path and shape)."""
    params, stats = {}, {}
    for prefix, node in _holding(data["params"], "Conv_0"):
        params.update(_block_params(prefix, node, "BatchNorm_0" in node))
    for prefix, node in _holding(data.get("batch_stats", {}), "BatchNorm_0"):
        stats[f"{prefix}.BatchNorm_0.running_mean"] = _t(
            node["BatchNorm_0"]["mean"])
        stats[f"{prefix}.BatchNorm_0.running_var"] = _t(
            node["BatchNorm_0"]["var"])
    return {"iteration": int(data["iteration"]), "params": params,
            "batch_stats": stats}


def _holding(tree: dict, key: str, path: tuple = ()):
    """(torch path prefix, node) of every node of a flax tree that holds
    ``key``."""
    if key in tree:
        yield ".".join(path), tree
        return
    for name, child in tree.items():
        if isinstance(child, dict):
            yield from _holding(child, key, path + (name,))


def train_state_from_flax(model: SuperPoint, variables: dict, mu: dict,
                          nu: dict, count: int, iteration: int,
                          learning_rate: float) -> TrainState:
    """The port's ``TrainState`` holding a flax training state: the
    ``{'params', 'batch_stats'}`` numpy tree goes into ``model`` (in
    place), and ``optax.adam``'s state (first moments ``mu``, second
    moments ``nu``, both shaped like the parameters, and its step
    ``count``) into a fresh Adam, so that both sides take the same step
    from the same state."""
    load_flax_variables(model, variables)
    state = create_train_state(model, learning_rate)
    state.iteration = int(iteration)
    exp_avg = flax_params_to_torch(model, mu)
    exp_avg_sq = flax_params_to_torch(model, nu)
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }
    return state


def folded_from_flax(folded: dict, has_descriptor: bool = True) -> dict:
    """The flax ``fold_batch_norm`` output (numpy tree ``{'params': ...}``)
    -> the port's folded dict {path: {"kernel" HWIO, "bias"}}."""
    names = ServingSuperPoint.conv_names(has_descriptor)
    out = {}
    for path in names:
        node = _node(folded["params"], path)["Conv_0"]
        out[path] = {"kernel": _t(node["kernel"]), "bias": _t(node["bias"])}
    return out


def serving_from_folded(folded: dict, act_scales: dict | None,
                        has_descriptor: bool = True, device="cuda", **kw):
    """A ``ServingSuperPoint`` built from flax-folded weights and flax
    activation scales (None for ``mode="bf16"``), so that a comparison
    with the JAX serving graph sees only the kernels' arithmetic. ``kw``:
    ``mode``, ``fused_mid``, ``fused_tail``."""
    scales = None if act_scales is None else {
        k: torch.tensor(np.float32(v)) for k, v in act_scales.items()}
    return ServingSuperPoint(folded_from_flax(folded, has_descriptor), scales,
                             has_descriptor, device=device, **kw)


def tiny_field_from_jax(params: dict, device="cuda",
                        dtype: torch.dtype = torch.float32) -> dict:
    """The tiny NeRF field's parameters (a dict of numpy ``w1``, ``w2``,
    ``w3``, ``wd``, as ``np.load`` of a saved field or ``np.asarray`` of
    the reference's ``init_params`` gives them) as the port's: tensors on
    ``device``, rounded from float32 to ``dtype`` (float32, or bfloat16 as
    the render benchmark serves them)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tiny_field_from_jax: dtype {dtype}")
    device = resolve_device(device)
    return {k: _t(params[k]).to(device=device, dtype=dtype)
            for k in ("w1", "w2", "w3", "wd")}


@torch.no_grad()
def _dense_from_flax(layer: torch.nn.Linear, node: dict) -> None:
    """A flax Dense's ``{kernel (in, out), bias}`` into an ``nn.Linear``."""
    layer.weight.copy_(_t(node["kernel"]).T)
    layer.bias.copy_(_t(node["bias"]))


def nerf_from_jax(variables: dict, config: NeRFConfig = NeRFConfig(),
                  device="cuda") -> NeRF:
    """The port's ``NeRF`` holding the reference's ``init_nerf`` variables
    (numpy tree ``{'params': {'coarse' | 'fine': {'layer<i>' | 'sigma' |
    'feature' | 'view1' | 'rgb': {'kernel', 'bias'}}}}``), on ``device``."""
    device = resolve_device(device)
    model = NeRF(config)
    for level in ("coarse", "fine"):
        node, mlp = variables["params"][level], getattr(model, level)
        for i, layer in enumerate(mlp.layers):
            _dense_from_flax(layer, node[f"layer{i}"])
        for name in ("sigma", "feature", "view1", "rgb"):
            _dense_from_flax(getattr(mlp, name), node[name])
    return model.to(device)


@torch.no_grad()
def hash_nerf_from_jax(variables: dict,
                       config: HashNeRFConfig = HashNeRFConfig(),
                       device="cuda") -> HashNeRF:
    """The port's ``HashNeRF`` holding the reference's ``init_hash_nerf``
    variables (``{'params': {'grid': {'table'}, 'sigma1', 'sigma2',
    'color1', 'color2'}}``), on ``device``."""
    device = resolve_device(device)
    model = HashNeRF(config)
    params = variables["params"]
    model.grid.table.copy_(_t(params["grid"]["table"]))
    for name in ("sigma1", "sigma2", "color1", "color2"):
        _dense_from_flax(getattr(model, name), params[name])
    return model.to(device)
