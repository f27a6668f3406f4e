"""The port's importer of reference-layout PyTorch state dicts
(``tools/import_torch_weights.py``) against the JAX package's
``torch_state_dict_to_flax``, carried into the port by
``tools.import_jax_weights.load_flax_variables``: the same tensors, and
``superpoint_inference`` outputs within 1e-6."""

import numpy as np
import pytest
import torch

from spnerf_tpu.tools.import_torch_weights import torch_state_dict_to_flax
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    init_superpoint,
    superpoint_inference,
)
from spnerf_tpu_torch.tasks.train_task import restore_pretrained
from spnerf_tpu_torch.tools import import_torch_weights as itw
from spnerf_tpu_torch.tools.import_jax_weights import load_flax_variables

_REF_BLOCKS = ([f"backbone.block_{i}" for i in range(1, 9)]
               + ["detector_head.convPa", "detector_head.convPb",
                  "descriptor_head.convDa", "descriptor_head.convDb"])


def _reference_state_dict(cfg, seed=0, descriptor=True) -> dict:
    """A seeded state dict in the reference's layout, with BatchNorm's
    ``num_batches_tracked`` as torch writes it."""
    gen = torch.Generator().manual_seed(seed)
    port = SuperPoint(cfg)
    blocks = dict(zip(_REF_BLOCKS, [b for _, b in sorted(
        ((k, v) for k, v in port.named_modules()
         if k.count(".") == 1 and hasattr(v, "Conv_0")),
        key=lambda kv: _port_order(kv[0]))]))
    sd = {}
    for ref, block in blocks.items():
        if ref.startswith("descriptor") and not descriptor:
            continue
        w = block.Conv_0.weight
        sd[f"{ref}.conv2d.weight"] = torch.randn(w.shape, generator=gen) * 0.1
        sd[f"{ref}.conv2d.bias"] = torch.randn(w.shape[0], generator=gen) * 0.1
        c = w.shape[0]
        sd[f"{ref}.norm.weight"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{ref}.norm.bias"] = torch.rand(c, generator=gen) - 0.5
        sd[f"{ref}.norm.running_mean"] = torch.rand(c, generator=gen) * 0.2
        sd[f"{ref}.norm.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{ref}.norm.num_batches_tracked"] = torch.tensor(123)
    return sd


def _port_order(path: str) -> int:
    order = [f"backbone.block{i}" for i in range(1, 9)] + [
        "detector.convPa", "detector.convPb", "descriptor.convDa",
        "descriptor.convDb"]
    return order.index(path)


@pytest.fixture(scope="module")
def cfg():
    return SuperPointConfig(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16),
                            detector_dim=(16, 32), descriptor_dim=(16, 32),
                            det_thresh=0.015)


def test_import_equals_jax_route(cfg):
    sd = _reference_state_dict(cfg)
    flax_vars = torch_state_dict_to_flax(sd)
    want = load_flax_variables(SuperPoint(cfg), flax_vars).eval()
    got = init_superpoint(5, cfg, device="cpu")
    restored = itw.import_into(got, itw.torch_state_dict_to_port(sd))
    assert len(restored) == 12 * 6  # conv w, b, BN w, b, mean, var
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    image = torch.rand((2, 32, 40, 1), generator=torch.Generator()
                       .manual_seed(1))
    a, b = superpoint_inference(got, image), superpoint_inference(want, image)
    for k in ("logits", "prob_heatmap", "prob_heatmap_nms", "desc"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6,
                                   rtol=0)


def test_magicpoint_dict_merges_partially(cfg):
    sd = _reference_state_dict(cfg, seed=2, descriptor=False)
    model = init_superpoint(5, cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    restored = itw.import_into(model, itw.torch_state_dict_to_port(sd))
    assert len(restored) == 10 * 6
    assert not any(p.startswith("descriptor.") for p in restored)
    for k, v in model.state_dict().items():
        if k.startswith("descriptor."):
            assert torch.equal(v, before[k]), k  # seeded weights kept
    assert torch.equal(model.detector.convPa.Conv_0.weight,
                       sd["detector_head.convPa.conv2d.weight"])
    # a narrower model takes only the tensors whose shape matches
    narrow = init_superpoint(5, SuperPointConfig(vgg_cn=(4,) * 8),
                             device="cpu")
    mapped = itw.torch_state_dict_to_port(sd)
    mapped = {**mapped["params"], **mapped["batch_stats"]}
    shapes = {k: v.shape for k, v in narrow.state_dict().items()}
    assert sorted(itw.import_into(narrow, itw.torch_state_dict_to_port(sd))) \
        == sorted(k for k, v in mapped.items() if shapes.get(k) == v.shape) \
        == ["detector.convPb.BatchNorm_0.bias",
            "detector.convPb.BatchNorm_0.running_mean",
            "detector.convPb.BatchNorm_0.running_var",
            "detector.convPb.BatchNorm_0.weight", "detector.convPb.Conv_0.bias"]


def test_main_round_trips_through_restore_pretrained(tmp_path, monkeypatch):
    full = SuperPointConfig(model_name="magicpoint")
    sd = _reference_state_dict(full, seed=3, descriptor=False)
    torch.save({"iteration": 7, "model_state_dict": sd}, tmp_path / "m.pth")
    itw.main([str(tmp_path / "m.pth"), str(tmp_path / "ck" / "m.ckpt"),
              "--model-name", "magicpoint"])
    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path)
    model = init_superpoint(9, full, device="cpu")
    assert restore_pretrained({"pretrained": "ck/m.ckpt"}, model) == 0
    want = load_flax_variables(SuperPoint(full), torch_state_dict_to_flax(sd))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    payload = torch.load(tmp_path / "ck" / "m.ckpt", weights_only=True)
    assert set(payload) == {"iteration", "params", "batch_stats",
                            "opt_state"}
    # a bare state dict, without the training wrapper, reads the same
    torch.save(sd, tmp_path / "bare.pth")
    bare = itw.load_torch_checkpoint(tmp_path / "bare.pth")
    wrapped = itw.load_torch_checkpoint(tmp_path / "m.pth")
    for group in ("params", "batch_stats"):
        assert bare[group].keys() == wrapped[group].keys()
