"""Checkpoints the JAX package wrote, read by the port.

``spnerf_tpu_torch.train.flax_msgpack`` decodes flax's msgpack in pure
Python: its tree must be leaf-equal (same paths, types, dtypes, shapes
and bits) to ``flax.serialization.msgpack_restore`` of the same bytes.
A MagicPoint restored from the committed demo checkpoint by
``restore_pretrained`` must give the JAX package's ``prob_heatmap``
within 1e-5 (float32 convs summed in another order by XLA and PyTorch;
measured 3.3e-7 at 2 x 64 x 80).
"""

from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from spnerf_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.models.superpoint import superpoint_inference as jax_inference
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.models.superpoint import (
    SuperPointConfig,
    init_superpoint,
    superpoint_inference,
)
from spnerf_tpu_torch.tasks.train_task import restore_pretrained
from spnerf_tpu_torch.train import flax_msgpack
from spnerf_tpu_torch.train.loop import (
    create_train_state,
    load_checkpoint,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo" / "pretrained" / "demo_mp_5000.ckpt"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def _assert_leaf_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for path in want:
        a, b = got[path], want[path]
        assert type(a) is type(b), path
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), path
        else:
            assert a == b, path


def test_demo_checkpoint_decodes_leaf_equal_to_flax():
    data = DEMO.read_bytes()
    got = load_checkpoint(DEMO)
    _assert_leaf_equal(got, serialization.msgpack_restore(data))
    assert int(got["iteration"]) == 5000


def test_decoder_covers_every_msgpack_type():
    """Every type flax's checkpoints can hold, at every width of msgpack's
    encodings, packed by flax and by msgpack itself."""
    rng = np.random.default_rng(0)
    tree = {
        "none": None, "yes": True, "no": False,
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63])},
        "float": 1.5, "nan": float("nan"), "neg": -2.5e-300,
        "strs": {"short": "a", "fix31": "x" * 31, "s8": "y" * 200,
                 "s16": "z" * 70000, "utf8": "été"},
        "arrays": {str(i): a for i, a in enumerate([
            rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-9, 9, (2, 3, 5)).astype(np.int64),
            np.arange(7, dtype=np.uint8), np.zeros((0, 3), np.float64),
            rng.standard_normal(20000).astype(np.float16),
            np.array(True), np.array(3, np.int32)])},
        "scalar": np.float32(2.25), "complex": 1.5 - 2j,
        "list": [1, "two", [3.0]],
        "empty": {},
    }
    encoded = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(encoded)
    got = flax_msgpack.msgpack_restore(encoded)
    assert got["list"] == want["list"] and got["complex"] == want["complex"]
    assert type(got["scalar"]) is type(want["scalar"])
    for key in ("list", "complex", "scalar"):
        got.pop(key), want.pop(key)
    _assert_leaf_equal(got, want)
    blobs = {"b8": b"\x01" * 10, "b16": b"\x02" * 300, "b32": b"\x03" * 70000,
             "f32": msgpack.ExtType(5, b"")}
    raw = msgpack.packb({k: v for k, v in blobs.items() if k != "f32"},
                        use_bin_type=True)
    assert flax_msgpack.unpackb(raw) == {k: v for k, v in blobs.items()
                                         if k != "f32"}
    assert flax_msgpack.unpackb(msgpack.packb(0.25, use_single_float=True)) \
        == 0.25
    with pytest.raises(ValueError, match="extension type 5"):
        flax_msgpack.unpackb(msgpack.packb(blobs["f32"]))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(encoded[:-3])


def test_decoder_unchunks_and_reads_bfloat16(monkeypatch):
    """Arrays above flax's chunk size come back whole; bfloat16, which
    numpy cannot hold, as a torch tensor of the same bits."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    bf = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32), jnp.bfloat16)
    encoded = serialization.msgpack_serialize({"big": big, "bf": np.asarray(bf)})
    got = flax_msgpack.msgpack_restore(encoded)
    np.testing.assert_array_equal(got["big"], big)
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16),
                       torch.from_numpy(np.array(bf).view(np.int16)))


def test_load_checkpoint_still_reads_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path)
    cfg = SuperPointConfig(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16),
                           detector_dim=(16, 32), descriptor_dim=(16, 32))
    state = create_train_state(init_superpoint(1, cfg, device="cpu"), 1e-3)
    state.iteration = 7
    path = save_checkpoint("own", state)
    assert not flax_msgpack.is_msgpack_map(path.read_bytes()[:1])
    data = load_checkpoint(path)
    assert data["iteration"] == 7 and "opt_state" in data
    model = init_superpoint(2, cfg, device="cpu")
    assert restore_pretrained({"pretrained": "own/own_7.ckpt",
                               "continue_training": True}, model) == 7
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[name])


def _demo_config(model_name, continue_training=False):
    return {"pretrained": "pretrained/demo_mp_5000.ckpt",
            "continue_training": continue_training,
            "model": {"model_name": model_name}}


def _shapes_image():
    """2 x 64 x 80: a white rectangle, and a cross of two bars, on faint
    noise."""
    x = np.zeros((2, 64, 80, 1), np.float32)
    x[0, 16:40, 20:60] = 1.0
    x[1, 10:50, 30:34] = 0.8
    x[1, 30:34, 10:70] = 0.6
    return x + np.random.default_rng(3).uniform(0, 0.05, x.shape).astype(
        np.float32)


def test_restored_magicpoint_matches_jax(monkeypatch):
    """The demo MagicPoint by the port and by the JAX package, same input:
    prob_heatmap within 1e-5, iteration carried over."""
    monkeypatch.setattr(settings, "CKPT_PATH", ROOT / "demo")
    cfg = SuperPointConfig(model_name="magicpoint", det_thresh=0.001,
                           top_k=1000)
    port = init_superpoint(5, cfg, device="cpu")
    assert restore_pretrained(_demo_config("magicpoint", True), port) == 5000
    x = _shapes_image()
    got = superpoint_inference(port, torch.from_numpy(x))
    data = serialization.msgpack_restore(DEMO.read_bytes())
    jcfg = JaxConfig(model_name="magicpoint", det_thresh=0.001, top_k=1000)
    want = jax_inference(JaxSuperPoint(jcfg),
                         {"params": data["params"],
                          "batch_stats": data["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(got["prob_heatmap"].numpy(),
                               np.asarray(want["prob_heatmap"]), atol=1e-5,
                               rtol=0)
    # trained weights: the rectangle's four corners, within 2 pixels
    corners = torch.nonzero(got["prob_heatmap_nms"][0] >= 0.015).tolist()
    assert len(corners) == 4
    for y, x in ((16, 20), (16, 59), (39, 20), (39, 59)):
        assert min(max(abs(y - a), abs(x - b)) for a, b in corners) <= 2


def test_partial_restore_of_magicpoint_into_superpoint(monkeypatch):
    """Backbone and detector from the demo checkpoint; the descriptor
    head, which it lacks, keeps its seeded weights; no iteration without
    continue_training."""
    monkeypatch.setattr(settings, "CKPT_PATH", ROOT / "demo")
    model = init_superpoint(0, SuperPointConfig(), device="cpu")
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    assert restore_pretrained(_demo_config("superpoint"), model) == 0
    data = load_checkpoint(DEMO)
    kernel = data["params"]["backbone"]["block3"]["Conv_0"]["kernel"]
    assert torch.equal(model.backbone["block3"].Conv_0.weight,
                       torch.from_numpy(np.array(kernel)).permute(3, 2, 0, 1))
    var = data["batch_stats"]["detector"]["convPb"]["BatchNorm_0"]["var"]
    assert torch.equal(model.detector["convPb"].BatchNorm_0.running_var,
                       torch.from_numpy(np.array(var)))
    for name, value in model.state_dict().items():
        if name.startswith("descriptor."):
            assert torch.equal(value, seeded[name]), name
        elif name.endswith(("weight", "running_var")):
            assert not torch.equal(value, seeded[name]), name
