"""The port's task CLI (``spnerf_tpu_torch/cli.py``) and on-the-fly
evaluation against the JAX package's (``spnerf_tpu/cli.py``,
``spnerf_tpu/eval/on_the_fly.py``) on the CPU, over the shared
HPatches-layout tree (``tests/_hpatches_tree.py``) at 64 x 80 with one
narrow checkpoint that the JAX package writes and both read.

Tolerances as ``tests/test_torch_hpatches.py`` holds the HPatches
export: images and homographies equal, NMS'd heatmaps equal to 1e-5
where both keep a point (a point on one side only has a neighbour within
1e-5 of its score), descriptors within 1e-5. The on-the-fly metrics
within 1e-6 on the pairs whose keypoint sets agree.

The bootstrap's tasks (``train`` on ``magicpoint_syn.yaml`` and
``superpoint_coco_train.yaml``, ``export_pseudo_labels`` on
``magicpoint_coco_export.yaml``) run through the port's CLI alone on a
tiny tree (generated shapes, COCO-layout copies of the JPEG fixtures)
at narrow widths and 2 steps: their checkpoints and label files are
checked, not compared.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _hpatches_tree import NAMES, write_tree
from _jpeg_fixtures import DIR as JPEG_DIR
from _torch_port import flax_superpoint
from spnerf_tpu import cli as jcli
from spnerf_tpu.data import hpatches as jhp
from spnerf_tpu.eval import on_the_fly as jotf
from spnerf_tpu.models.superpoint import SuperPointConfig as JaxConfig
from spnerf_tpu.tasks import export as jexport
from spnerf_tpu.tasks import train_task as jtrain
from spnerf_tpu_torch import cli as tcli
from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import pnm
from spnerf_tpu_torch.eval import descriptor as tdesc
from spnerf_tpu_torch.eval import detector as tdet
from spnerf_tpu_torch.eval import on_the_fly as totf
from spnerf_tpu_torch.models.superpoint import superpoint_inference
from spnerf_tpu_torch.tasks import export as texport
from spnerf_tpu_torch.utils.config import apply_overrides, load_config
from test_torch_hpatches import _assert_nms_close

ROOT = Path(__file__).resolve().parents[1]
NARROW = {"model.vgg_cn": "[8,8,8,8,16,16,16,16]",
          "model.detector_head.detector_dim": "[16,32]",
          "model.descriptor_head.descriptor_dim": "[16,32]",
          "data.preprocessing.resize": "[64,80]",
          "pretrained": "narrow/narrow_0.ckpt"}
SETS = [a for k, v in NARROW.items() for a in ("--set", f"{k}={v}")]
TASKS = [("export_HPatches_Repeatability", "magicpoint_repeatability.yaml",
          "i"),
         ("export_HPatches_Descriptors", "superpoint_descriptors.yaml", "v")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The HPatches tree and the narrow checkpoint the JAX package
    wrote (a SuperPoint with perturbed BatchNorm statistics)."""
    from flax import serialization

    root = tmp_path_factory.mktemp("cli")
    write_tree(root / "data", pnm.write)
    _, variables = flax_superpoint(
        JaxConfig(vgg_cn=(8, 8, 8, 8, 16, 16, 16, 16), detector_dim=(16, 32),
                  descriptor_dim=(16, 32)), (1, 64, 80, 1), seed=44)
    ckpt = root / "ckpt" / "narrow" / "narrow_0.ckpt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(serialization.msgpack_serialize(
        {"iteration": np.asarray(0), **variables}))
    return root


@pytest.fixture
def roots(tree, monkeypatch):
    """Both packages' roots: data and checkpoints shared, exports apart."""
    for mod in (settings, jhp):
        monkeypatch.setattr(mod, "DATA_PATH", tree / "data")
    for mod in (settings, jtrain):
        monkeypatch.setattr(mod, "CKPT_PATH", tree / "ckpt")
    monkeypatch.setattr(jexport, "EXPER_PATH", tree / "jax")
    monkeypatch.setattr(texport, "EXPER_PATH", tree / "port")
    monkeypatch.setattr(settings, "EXPER_PATH", tree / "port")
    return tree


@pytest.mark.parametrize("task,config,alteration", TASKS)
def test_cli_hpatches_export_matches_jax(roots, task, config, alteration):
    args = ["--config-path", str(ROOT / "spnerf_tpu/configs" / config),
            "--task", task] + SETS
    jdir = jcli.main(args)
    tdir = tcli.main(args + ["--device", "cpu"])
    names = sorted(p.name for p in jdir.glob("*.npz"))
    assert names == sorted(p.name for p in tdir.glob("*.npz")) \
        == sorted(f"{n}.npz" for n in NAMES[alteration])
    cfg = apply_overrides(load_config(ROOT / "spnerf_tpu_torch/configs"
                                      / config), SETS[1::2])
    model = tcli.model_for_inference(cfg, torch.device("cpu"))
    for name in names:
        want, got = np.load(jdir / name), np.load(tdir / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
        for key in ("image", "warped_image", "homography"):
            np.testing.assert_array_equal(got[key], want[key])
        for key, img in (("prob", "image"), ("warped_prob", "warped_image")):
            dense = superpoint_inference(model, torch.from_numpy(
                want[img][None, ..., None]))["prob_heatmap"].numpy()
            _assert_nms_close(got[key][None], want[key][None], dense)
        if "desc" in want.files:
            for key in ("desc", "warped_desc"):
                np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                           rtol=0)
    if alteration == "i":
        assert tdet.compute_repeatability(cfg["data"]["experiment_name"]) \
            >= 0.0


def _keypoints(prob):
    return set(zip(*np.nonzero(prob)))


def _flips_are_near_ties(got, want, d1, d2, gap=1e-4):
    """Mutual matches (i, j) found on one side only sit where ``d1`` row
    i's or ``d2`` row j's nearest neighbour is within ``gap`` (squared
    distance) of its second nearest: descriptors within 1e-5 may order
    such a tie either way."""
    d = ((d1[:, None] - d2[None]) ** 2).sum(-1)
    rows, cols = np.sort(d, 1), np.sort(d, 0)
    for i, j in set(map(tuple, got)) ^ set(map(tuple, want)):
        assert min(rows[i, 1] - rows[i, 0], cols[1, j] - cols[0, j]) < gap


def test_on_the_fly_matches_jax(roots):
    """Both modes over the ``v`` pairs against the reference's inference
    and metrics: the same keypoint sets; repeatability within 1e-6; the
    same mutual matches but for near ties (so matching scores within one
    match a pair); on a pair whose matches are equal the RANSAC draws
    cv2's samples, so matching score, inliers and correctness equal and
    the corner distance within 1e-4 px (tests/test_torch_eval.py), else
    correctness equal away from the 3 px threshold; the aggregates and
    their bootstrap intervals as the reference's ``run_repeatability`` /
    ``run_descriptors`` form them."""
    from spnerf_tpu.eval import descriptor as jdesc
    from spnerf_tpu.eval import detector as jdet

    cfg = apply_overrides(load_config(
        ROOT / "spnerf_tpu_torch/configs/superpoint_descriptors.yaml"),
        SETS[1::2])
    infer, loader = jotf._build(cfg)
    reps, est = {"port": [], "jax": []}, {"port": [], "jax": []}
    same_matches = 0
    for (H, out1, out2), batch in zip(totf.pair_outputs(cfg, "cpu"),
                                      loader):
        w1, w2 = ({k: np.asarray(v[0]) for k, v in
                   infer(jax.numpy.asarray(batch[key])).items()}
                  for key in ("image", "warped_image"))
        np.testing.assert_array_equal(H, batch["homography"][0])
        for got, want in ((out1, w1), (out2, w2)):
            assert _keypoints(got["prob_heatmap_nms"]) == \
                _keypoints(want["prob_heatmap_nms"])
        reps["port"].append(tdet.repeatability_pair(
            out1["prob_heatmap_nms"], out2["prob_heatmap_nms"], H))
        reps["jax"].append(jdet.repeatability_pair(
            w1["prob_heatmap_nms"], w2["prob_heatmap_nms"], H))
        est["port"].append(tdesc.compute_homography_estimation(
            out1["prob_heatmap_nms"], out2["prob_heatmap_nms"],
            out1["desc"], out2["desc"], H))
        est["jax"].append(jdesc.compute_homography_estimation(
            w1["prob_heatmap_nms"], w2["prob_heatmap_nms"], w1["desc"],
            w2["desc"], H))
        g, w = est["port"][-1], est["jax"][-1]
        k1, k2 = w["keypoints1"], w["keypoints2"]
        np.testing.assert_array_equal(g["keypoints1"], k1)
        _flips_are_near_ties(g["matches"], w["matches"],
                             w1["desc"][k1[:, 0], k1[:, 1]],
                             w2["desc"][k2[:, 0], k2[:, 1]])
        assert abs(g["matching_score"] - w["matching_score"]) \
            <= 1.0 / len(k1) + 1e-12
        if np.array_equal(g["matches"], w["matches"]):
            # the same RANSAC input: cv2's draws, the same inliers
            assert g["matching_score"] == w["matching_score"]
            assert g["correctness"] == w["correctness"]
            np.testing.assert_array_equal(g["inliers"], w["inliers"])
            assert abs(g.get("mean_dist", 0.0) - w.get("mean_dist", 0.0)) \
                < 1e-4
            same_matches += 1
        elif abs(w.get("mean_dist", 0.0) - 3.0) > 0.5:
            assert g["correctness"] == w["correctness"]
    assert len(reps["jax"]) == len(NAMES["v"])
    assert same_matches >= 1
    for (r, n1, n2), (q, m1, m2) in zip(reps["port"], reps["jax"]):
        assert (n1, n2) == (m1, m2) and r == pytest.approx(q, abs=1e-6)

    got = totf.run_repeatability(cfg, device="cpu")
    vals = [r for r, _, _ in reps["jax"] if r is not None]
    assert got == {"repeatability": pytest.approx(np.mean(vals), abs=1e-6),
                   "repeatability_ci95": pytest.approx(
                       list(jotf.bootstrap_ci(vals)), abs=1e-6),
                   "pairs": len(vals)}
    got = totf.run_descriptors(cfg, device="cpu")
    assert got["pairs"] == len(est["jax"])
    for key in ("correctness", "matching_score"):
        mine = [e[key] for e in est["port"]]
        assert got[key] == pytest.approx(np.mean(mine), abs=1e-12)
        assert got[key] == pytest.approx(
            np.mean([e[key] for e in est["jax"]]),
            abs=np.mean([1.0 / len(e["keypoints1"]) for e in est["jax"]]))
        assert got[f"{key}_ci95"] == list(totf.bootstrap_ci(mine))


BOOT_NARROW = {"model.vgg_cn": [8, 8, 8, 8, 16, 16, 16, 16],
               "model.detector_head.detector_dim": [16, 32],
               "data.preprocessing.resize": [120, 160],
               "train.num_iters": 2, "save_or_validation_interval": 2}
BOOT_STEPS = [
    # README's bootstrap, cut: Synthetic Shapes generated at 120 x 160
    ("train", "magicpoint_syn.yaml", {
        "data.generation.split_sizes": {"training": 2, "validation": 2,
                                        "test": 1},
        "data.generation.image_size": [120, 160],
        "data.generation.params": {"generate_background": {
            "min_kernel_size": 5, "max_kernel_size": 30}},
        "data.preprocessing.blur_size": 5, "data.batch_size": 4}),
    ("export_pseudo_labels", "magicpoint_coco_export.yaml", {
        "pretrained": "magicpoint_syn_v1/magicpoint_syn_v1_2.ckpt",
        "homography_adaptation.num": 3, "homography_adaptation.chunk": 2}),
    ("train", "superpoint_coco_train.yaml", {
        "pretrained": "magicpoint_syn_v1/magicpoint_syn_v1_2.ckpt",
        "model.descriptor_head.descriptor_dim": [16, 32]}),
]


@pytest.fixture(scope="module")
def bootstrap(tmp_path_factory):
    """The bootstrap's tasks through ``cli.main --device cpu`` on a tiny
    tree: COCO/images/{training,validation} from the JPEG fixtures."""
    root = tmp_path_factory.mktemp("boot")
    for split, n in (("training", 4), ("validation", 2)):
        d = root / "data" / "COCO" / "images" / split
        d.mkdir(parents=True)
        for i, f in enumerate(sorted(JPEG_DIR.glob("*.jpg"))[:n]):
            shutil.copy(f, d / f"{i}_{f.name}")
    mp = pytest.MonkeyPatch()
    mp.setattr(settings, "DATA_PATH", root / "data")
    mp.setattr(settings, "CKPT_PATH", root / "ckpt_path")
    for mod in (settings, texport):
        mp.setattr(mod, "EXPER_PATH", root / "exper_path")
    results = []
    for task, config, cuts in BOOT_STEPS:
        argv = ["--config-path", str(ROOT / "spnerf_tpu_torch/configs"
                                     / config), "--task", task,
                "--device", "cpu"]
        if task == "export_pseudo_labels":
            outs = [tcli.main(argv + _sets(BOOT_NARROW, cuts)
                              + ["--split", split])
                    for split in ("training", "validation")]
        else:
            outs = tcli.main(argv + _sets(BOOT_NARROW, cuts))
        results.append(outs)
    yield root, results
    mp.undo()


def _sets(*cuts):
    merged = {k: v for c in cuts for k, v in c.items()}
    return [a for k, v in merged.items()
            for a in ("--set", f"{k}={json.dumps(v)}")]


@pytest.mark.parametrize("step", range(len(BOOT_STEPS)))
def test_unported_dataset_raises_before_weights(bootstrap, step):
    """The three tasks whose datasets raised before SyntheticShapes and
    COCO were ported now run through the CLI: checkpoints of both
    training runs and one (N, 2) int64 label file per COCO image."""
    root, results = bootstrap
    task, config, _ = BOOT_STEPS[step]
    if task == "train":
        state = results[step]
        name = load_config(ROOT / "spnerf_tpu_torch/configs" /
                           config)["ckpt_name"]
        assert state.iteration == 2
        assert (root / "ckpt_path" / name / f"{name}_2.ckpt").is_file()
        rows = (root / "ckpt_path" / name / "logs" / "metrics.jsonl"
                ).read_text().splitlines()
        assert rows
        if config == "magicpoint_syn.yaml":
            pngs = list((root / "data" / "synthetic_shapes").glob(
                "*/images/training/*.png"))
            assert len(pngs) == 2 * 9
    else:
        for split, out_dir in zip(("training", "validation"),
                                  results[step]):
            images = sorted((root / "data" / "COCO" / "images" / split)
                            .glob("*.jpg"))
            labels = sorted(out_dir.glob("*.npy"))
            assert [p.stem for p in labels] == [p.stem for p in images]
            for f in labels:
                pts = np.load(f)
                assert pts.dtype == np.int64 and pts.ndim == 2 \
                    and pts.shape[1] == 2


def test_coco_shard_auto_raises_naming_the_queue_item(bootstrap):
    """``data.shard: auto`` raised until the port had process groups; now
    it takes this process's block, and without a group (a one-process
    run) that is every image: the bootstrap's export again, file for
    file."""
    root, results = bootstrap
    task, config, cuts = BOOT_STEPS[1]
    argv = ["--config-path", str(ROOT / "spnerf_tpu_torch/configs" / config),
            "--task", task, "--device", "cpu", "--set", "data.shard=auto",
            "--set", "data.experiment_name=shard_auto"]
    out_dir = tcli.main(argv + _sets(BOOT_NARROW, cuts))
    want = sorted(results[1][0].glob("*.npy"))
    assert len(want) == 4
    assert [p.name for p in sorted(out_dir.glob("*.npy"))] == \
        [p.name for p in want]
    for f in want:
        assert (out_dir / f.name).read_bytes() == f.read_bytes()


def test_parser_takes_the_references_options_and_device():
    argv = ["--config-path", "x.yaml", "--task", "train",
            "--validate-training", "--no-include-mask-loss", "--nerf-loss",
            "--train-nerf", "--no-enable-homography-adaptation", "--split",
            "validation", "--seed", "3", "--set", "train.lr=2", "--set",
            "a.b=c"]
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert tcli.TASKS == jcli.TASKS
    assert tcli.build_parser().parse_args(
        argv + ["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(argv + ["--device", "tpu"])


def test_module_entry_point_runs_without_yaml(tmp_path):
    """``python -m spnerf_tpu_torch.cli`` with ``yaml`` unimportable: an
    HPatches export of an empty data root on the CPU."""
    probe = ("import runpy, sys; sys.modules['yaml'] = None; "
             "sys.argv = ['cli'] + sys.argv[1:]; "
             "runpy.run_module('spnerf_tpu_torch.cli', run_name='__main__')")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "SPNERF_ROOT": str(tmp_path), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", probe, "--config-path",
         "spnerf_tpu_torch/configs/magicpoint_repeatability.yaml", "--task",
         "export_HPatches_Repeatability", "--set", "pretrained=null",
         "--set", "model.vgg_cn=[8,8,8,8,16,16,16,16]", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = tmp_path / "outputs" / "repeatability" / \
        "magicpoint_COCO_v1_HA_nms_4"
    assert out.is_dir() and not any(out.iterdir())
