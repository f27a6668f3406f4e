"""The HA pseudo-label export of the port sharded over ranks (gloo, CPU):
the counterparts of the JAX package's mesh tests
(``test_multichip.test_sharded_ha_export_matches_single_device``,
``test_sharded_ha_export_pad_invariant``,
``test_sharded_export_merges_bit_identical``).

Each rank adapts its contiguous rows of every batch
(``export_pseudo_labels(..., mesh=make_mesh())``); a batch that does not
split pads to a multiple of the ranks. The files equal, byte for byte,
those of the port's one-process export, which ``test_torch_ha_export.py``
holds against the JAX package. Through ``cli.main`` with ``data.shard:
auto`` each rank exports its block of a COCO-layout tree of PNGs, the
int8 serving graph calibrated on rank 0's first batch: the blocks merge
into the one-process run's files.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.models.superpoint import SuperPointConfig, init_superpoint
from spnerf_tpu_torch.tasks import export
from spnerf_tpu_torch.tools.smoke_dist import (
    export_model,
    files,
    same_files,
    save_weights,
    spawn_ranks,
    write_coco,
)

ROOT = Path(__file__).resolve().parents[1]
H = W = 32
MODEL = dict(model_name="magicpoint", vgg_cn=(4, 4, 8, 8, 8, 8, 8, 8),
             detector_dim=(8, 16))
CONFIG = {
    "data": {"experiment_name": "ha_mesh"},
    "model": {"detector_head": {"nms": 4, "det_thresh": 0.001, "top_k": 50}},
    "homography_adaptation": {"num": 4, "chunk": 2},
}
# the int8 serving graph takes the full-width model
CLI_SETS = {"model.detector_head.det_thresh": 0.001,
            "data.preprocessing.resize": [H, W], "data.batch_size": 2,
            "homography_adaptation.num": 4, "homography_adaptation.chunk": 2,
            "pretrained": "pretrained/mp.ckpt", "export.serving": "int8"}


@pytest.fixture(scope="module")
def model():
    return init_superpoint(0, SuperPointConfig(**MODEL, det_thresh=0.001),
                           device="cpu")


def _images(n, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (n, H // 4, W // 4))
    fine = 0.2 * rng.uniform(size=(n, H, W))
    return np.clip(np.kron(coarse, np.ones((4, 4))) + fine, 0, 1).astype(
        np.float32)[..., None]


def _payload(model, images, root, batch_size):
    return {"model": MODEL,
            "weights": {k: v for k, v in model.state_dict().items()},
            "config": dict(CONFIG, data=dict(CONFIG["data"],
                                             batch_size=batch_size)),
            "images": images, "seed": 7, "EXPER_PATH": str(root)}


def _one_process(payload, monkeypatch):
    """The files of the export of ``payload`` in this process, without a
    mesh."""
    monkeypatch.setattr(export, "EXPER_PATH", Path(payload["EXPER_PATH"]))
    data = [{"image": im, "name": f"img{i:04d}"}
            for i, im in enumerate(payload["images"])]
    loader = DataLoader(data, payload["config"]["data"]["batch_size"],
                        drop_last=False)
    return files(export.export_pseudo_labels(
        payload["config"], export_model(payload, "cpu"), loader, seed=7,
        device="cpu"))


def _points(files_: dict) -> int:
    return sum(len(np.load(io.BytesIO(v))) for v in files_.values())


def _cli_argv(shard: bool):
    argv = ["--config-path",
            str(ROOT / "spnerf_tpu_torch/configs/magicpoint_coco_export.yaml"),
            "--task", "export_pseudo_labels", "--device", "cpu"]
    sets = dict(CLI_SETS, **({"data.shard": "auto"} if shard else {}))
    for key, value in sets.items():
        argv += ["--set", f"{key}={value}"]
    return argv


def test_sharded_exports_equal_one_process(model, tmp_path, monkeypatch):
    """Two ranks: batches of 8 (4 a rank) and a batch of 5 (padded to 6)
    sharded by the mesh, and ``cli.main`` with ``data.shard: auto`` over
    five PNGs in batches of 2 (blocks of 3 and 2; the second rank's first
    batch is not the calibration batch). Three ranks: the batch of 5."""
    eight, five = _images(8, 3), _images(5, 4)
    write_coco(tmp_path, (five * 255).round() / 255)
    full = init_superpoint(1, SuperPointConfig(model_name="magicpoint"),
                           device="cpu")
    with torch.no_grad():  # spread the probabilities away from 1/65
        full.detector["convPb"].Conv_0.weight.mul_(10.0)
    save_weights(full, tmp_path / "ckpt" / "pretrained" / "mp.ckpt")
    paths = {"DATA_PATH": str(tmp_path / "data"),
             "CKPT_PATH": str(tmp_path / "ckpt")}
    jobs = [("export", _payload(model, eight, tmp_path / "mesh8", 8)),
            ("export", _payload(model, five, tmp_path / "mesh5", 5)),
            ("cli", dict(paths, EXPER_PATH=str(tmp_path / "cli"),
                         argv=_cli_argv(shard=True)))]
    two = spawn_ranks("multi", 2, {"jobs": jobs}, tmp_path / "two", threads=1)
    three = spawn_ranks("export", 3, _payload(model, five,
                                              tmp_path / "mesh5x3", 5),
                        tmp_path / "three", threads=1)

    want8 = _one_process(_payload(model, eight, tmp_path / "one8", 8),
                         monkeypatch)
    want5 = _one_process(_payload(model, five, tmp_path / "one5", 5),
                         monkeypatch)
    for name, value in paths.items():
        monkeypatch.setattr(settings, name, Path(value))
    monkeypatch.setattr(settings, "EXPER_PATH", tmp_path / "cli_one")
    monkeypatch.setattr(export, "EXPER_PATH", tmp_path / "cli_one")
    want_cli = files(cli.main(_cli_argv(shard=False)))

    assert len(want8) == 8 and len(want5) == 5 and len(want_cli) == 5
    assert _points(want8) > 8 and _points(want5) > 5 and _points(want_cli) > 5
    mesh8, mesh5, by_cli = two.wait()[0]
    same_files("2 ranks, batches of 8", files(mesh8["dir"]), want8)
    same_files("2 ranks, a batch of 5", files(mesh5["dir"]), want5)
    same_files("3 ranks, a batch of 5", files(three.wait()[0]["dir"]), want5)
    same_files("cli, data.shard: auto", files(by_cli["dir"]), want_cli)
