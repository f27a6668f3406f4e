"""The measurement tools of ``spnerf_tpu_torch/demo/`` against the
reference's ``tools/``: ``label_iou``, ``ha_rate`` and ``live_steps``
print the reference's JSON on one tree (the reference run as a
subprocess, with ``SPNERF_*`` pointing at the same tree);
``label_fidelity``'s shadow depth and agreement equal the reference's
``build_shadow`` and ``agreement`` (one child process with cv2, since
``demo/*.py`` read ``SPNERF_DATA_PATH`` at import), and one cut run of the
tool on the CPU (1 scene of 3 frames at 48 x 64) writes the reference's
rows; ``multiproc_export`` with two gloo ranks on the CPU (4 images,
120 x 160, 2 homographies) gives labels equal to one process's.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.demo import (ha_rate, label_fidelity, label_iou,
                                   live_steps, multiproc_export, nerf_scenes,
                                   standin_data)
from spnerf_tpu_torch.tasks import nerf_task

ROOT = Path(__file__).resolve().parents[1]
DEMO_MP = ROOT / "demo" / "pretrained" / "demo_mp_5000.ckpt"


def reference(tool: str, *args, env=None) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), **(env or {}))
    return subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           *map(str, args)], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=120)


def port_lines(capsys, fn, *args) -> list:
    capsys.readouterr()
    fn(list(map(str, args)))
    return capsys.readouterr().out.splitlines()


def write_labels(d: Path, labels: dict) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    for name, pts in labels.items():
        np.save(d / f"{name}.npy", np.asarray(pts, np.int64).reshape(-1, 2))
    return d


def test_label_iou_matches_reference(tmp_path, capsys):
    """Unequal sets, an empty side, both sides empty, points exactly 2 px
    and just over 2 px apart, a file on one side only."""
    ref = write_labels(tmp_path / "ref", {
        "a": [[10, 10], [20, 20], [30, 30]], "b": [[5, 5]], "c": [],
        "d": [], "e": [[0, 0], [7, 7]], "only_ref": [[1, 1]]})
    test = write_labels(tmp_path / "test", {
        "a": [[10, 10], [20, 22], [33, 32], [40, 40]], "b": [],
        "c": [[3, 3]], "d": [], "e": [[0, 2], [9, 8]], "only_test": [[2, 2]]})
    for extra in ([], ["--label", "int8_vs_bf16"]):
        want = reference("label_iou.py", ref, test, *extra)
        assert want.returncode == 0, want.stderr
        got = port_lines(capsys, label_iou.main, ref, test, *extra)
        assert got == want.stdout.splitlines()
    row = json.loads(got[0])
    assert row["n_images"] == 5 and 0 < row["within_2px"] < 1
    empty = write_labels(tmp_path / "none", {"x": [[1, 1]]})
    assert reference("label_iou.py", ref, empty).returncode != 0
    with pytest.raises(SystemExit):
        label_iou.main([str(ref), str(empty)])


@pytest.mark.parametrize("case", ["spread", "warmup", "zero_span"])
def test_ha_rate_matches_reference(tmp_path, capsys, case):
    """mtimes set by ``os.utime``: an even spread, another warm-up share,
    and every file at one time (a NaN rate)."""
    out = write_labels(tmp_path / "training",
                       {f"img{i:03d}": [[i, i]] for i in range(23)})
    rng = np.random.default_rng(1)
    stamps = 1.7e9 + np.cumsum(rng.uniform(0.05, 0.4, 23))
    for i, p in enumerate(sorted(out.glob("*.npy"))):
        t = 1.7e9 if case == "zero_span" else float(stamps[(i * 7) % 23])
        os.utime(p, (t, t))
    args = [out] + (["--warmup-frac", "0.35", "--label", "x"]
                    if case == "warmup" else [])
    want = reference("ha_rate.py", *args)
    assert want.returncode == 0, want.stderr
    assert port_lines(capsys, ha_rate.main, *args) == \
        want.stdout.splitlines()
    few = write_labels(tmp_path / "few", {f"f{i}": [[0, 0]] for i in range(9)})
    assert reference("ha_rate.py", few).returncode != 0
    with pytest.raises(SystemExit):
        ha_rate.main([str(few)])


def test_live_steps_matches_reference(tmp_path, capsys, monkeypatch):
    """Legs with many samples, exactly 3, 2 (no row), a broken line and
    other tags; a directory without a log."""
    ckpts = tmp_path / "ckpts"
    rng = np.random.default_rng(2)
    counts = {"demo_mp": 13, "demo_sp_ctl": 3, "demo_sp_nerf": 2,
              "demo_x": 40}
    for leg, n in counts.items():
        log = ckpts / leg / "logs" / "metrics.jsonl"
        log.parent.mkdir(parents=True)
        lines = []
        for i in range(n):
            lines.append(json.dumps({"tag": "perf/steps_per_sec", "value":
                                     float(rng.uniform(1, 30)), "step": i}))
            lines.append(json.dumps({"tag": "train/loss", "value": 0.5,
                                     "step": i}))
        lines.insert(3, "{not json")
        log.write_text("\n".join(lines) + "\n")
    (ckpts / "no_logs").mkdir()
    want_out, got_out = tmp_path / "want.jsonl", tmp_path / "got.jsonl"
    want = reference("live_steps.py", "--json-out", want_out,
                     env={"SPNERF_CKPT_PATH": str(ckpts)})
    assert want.returncode == 0, want.stderr
    monkeypatch.setattr(settings, "CKPT_PATH", ckpts)
    got = port_lines(capsys, live_steps.main, "--json-out", got_out)
    assert got == want.stdout.splitlines() and len(got) == 3
    assert got_out.read_text() == want_out.read_text()
    assert live_steps.short_legs(live_steps.samples_by_leg()) == {
        "demo_sp_nerf": 2}


SCENES = 2
FRAMES = 3
SHAPE = (48, 64)


@pytest.fixture(scope="module")
def fidelity_tree(tmp_path_factory):
    """DATA_PATH with 2 fabricated scenes of 3 views at 48 x 64 and, for
    scene 0, NeRF-rendered stand-ins: the GT views with their depth
    scaled by 1 + N(0, 0.02)."""
    data = tmp_path_factory.mktemp("fidelity") / "data"
    nerf_scenes.main(["--n-scenes", str(SCENES), "--n-views", str(FRAMES),
                      "--height", str(SHAPE[0]), "--width", str(SHAPE[1])],
                     root=data)
    scene = sorted(p.name for p in (data / "NeRF_gt").iterdir())[0]
    gt = data / "NeRF_gt" / scene
    rgb = np.stack([png.read_gray(gt / "images" / "training" / f"{i}.png")
                    for i in range(FRAMES)]).astype(np.float32) / 255.0
    depth = np.stack([np.load(gt / "depth" / "training" / f"{i}.npy")
                      for i in range(FRAMES)])
    depth = depth * (1 + 0.02 * np.random.default_rng(3).standard_normal(
        depth.shape))
    poses = np.load(gt / "poses.npy")[:FRAMES]
    old = settings.DATA_PATH
    settings.DATA_PATH = data
    try:
        out = nerf_task.write_scene(scene, np.repeat(rgb[..., None], 3, -1),
                                    depth.astype(np.float32), poses,
                                    {"training": list(range(FRAMES))})
    finally:
        settings.DATA_PATH = old
    np.save(out / "poses_train.npy", poses)
    return data, scene


REF_FIDELITY = """
import importlib.util, json, sys
from pathlib import Path
import cv2
spec = importlib.util.spec_from_file_location("lf", "tools/label_fidelity.py")
lf = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lf)
cv2.setRNGSeed(0)  # a fresh process's generator
rects = [lf.rebuild_rects(s) for s in range(int(sys.argv[1]))]
lf.build_shadow(sys.argv[2], rects[0])
print(json.dumps([lf.agreement(Path(a), Path(b))
                  for a, b in json.loads(sys.argv[3])]))
"""


def test_label_fidelity_matches_reference(fidelity_tree, tmp_path,
                                          monkeypatch):
    """The shadow scene (links and ray-traced depth) and ``agreement``
    against the reference's, then a cut run of the tool."""
    data, scene = fidelity_tree
    ref_data, port_data = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(data, ref_data, symlinks=True)
    shutil.copytree(data, port_data, symlinks=True)
    pairs = [({"a": [[1, 1], [5, 5]], "b": [], "c": [[2, 2]], "d": []},
              {"a": [[1, 3], [6, 6], [9, 9]], "b": [[4, 4]], "c": [],
               "d": []}),
             ({"e": []}, {"e": []})]
    dirs = []
    for i, (ref, test) in enumerate(pairs):
        dirs.append((str(write_labels(tmp_path / f"r{i}", ref)),
                     str(write_labels(tmp_path / f"t{i}", test))))
    proc = subprocess.run(
        [sys.executable, "-c", REF_FIDELITY, str(SCENES), scene,
         json.dumps(dirs)], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT),
                              SPNERF_DATA_PATH=str(ref_data)))
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.splitlines()[-1])
    got = [label_fidelity.agreement(Path(a), Path(b)) for a, b in dirs]
    assert got == [tuple(w) for w in want]
    assert got[1] == (1.0, None)

    monkeypatch.setattr(settings, "DATA_PATH", port_data)
    label_fidelity.fresh_cv_rng()
    rects = [label_fidelity.gt_test_views.rebuild_rects(s)
             for s in range(SCENES)]
    shadow = label_fidelity.build_shadow(scene, rects[0])
    ref_shadow = ref_data / "NeRF" / f"{scene}__gtdepth"
    for sub in ("images", "camera_transforms"):
        assert (shadow / sub).is_symlink()
        assert (shadow / sub).resolve() == (port_data / "NeRF" / scene
                                            / sub).resolve()
    names = sorted(p.name for p in (ref_shadow / "depth" /
                                    "training").iterdir())
    assert names == [f"{i}.npy" for i in range(FRAMES)]
    for name in names:
        np.testing.assert_array_equal(
            np.load(shadow / "depth" / "training" / name),
            np.load(ref_shadow / "depth" / "training" / name))
    np.testing.assert_array_equal(np.load(shadow / "poses_train.npy"),
                                  np.load(ref_shadow / "poses_train.npy"))

    ckpts, exper = tmp_path / "ckpts", tmp_path / "outputs"
    (ckpts / "demo_mp").mkdir(parents=True)
    shutil.copy(DEMO_MP, ckpts / "demo_mp")
    monkeypatch.setattr(settings, "CKPT_PATH", ckpts)
    monkeypatch.setattr(settings, "EXPER_PATH", exper)
    monkeypatch.setattr(settings, "EVIDENCE_PATH", tmp_path / "evidence")
    rows = label_fidelity.main(["--n-scenes", "1", "--device", "cpu",
                                "--set", "data.image_size=[48,64]"])
    assert [r["metric"] for r in rows] == [
        "nerf_depth_label_fidelity", "nerf_depth_label_fidelity_summary"]
    assert set(rows[0]) == {"metric", "scene", "pretrained", "exact_iou",
                            "within_2px", "ref", "test"}
    assert rows[0]["pretrained"] == "demo_mp/demo_mp_5000.ckpt"
    assert rows[0]["scene"] == scene and 0 <= rows[0]["exact_iou"] <= 1
    assert rows[1] == {"metric": "nerf_depth_label_fidelity_summary",
                       "n_scenes": 1,
                       "mean_exact_iou": rows[0]["exact_iou"],
                       "mean_within_2px": rows[0]["within_2px"]}
    written = [json.loads(line) for line in (
        tmp_path / "evidence" / "label_fidelity.jsonl").read_text()
        .splitlines()]
    assert written == rows
    for exp in (f"demo_export_NeRF_gtdepth/{scene}",
                f"demo_export_NeRF/{scene}"):
        labels = sorted((exper / "outputs" / exp / "training").glob("*.npy"))
        assert len(labels) == FRAMES
    _, seconds = label_fidelity.fidelity(1, rows[0]["pretrained"], "cpu")
    assert seconds == {scene: (0.0, 0.0)}  # the labels are reused


def test_multiproc_export_two_ranks_equal_one(tmp_path, monkeypatch):
    root = tmp_path / "root"
    monkeypatch.setenv("SPNERF_ROOT", str(root))
    # three processes beside the other test workers: two threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    for key in ("SPNERF_DATA_PATH", "SPNERF_CKPT_PATH", "SPNERF_EXPER_PATH"):
        monkeypatch.delenv(key, raising=False)
    for name, sub in (("DATA_PATH", "data"), ("CKPT_PATH", "ckpts"),
                      ("EXPER_PATH", "outputs"), ("EVIDENCE_PATH",
                                                  "evidence")):
        monkeypatch.setattr(settings, name, root / sub)
    standin_data.main(["--n-coco", "4", "--n-hpatches", "0"])
    (root / "ckpts" / "demo_mp").mkdir(parents=True)
    shutil.copy(DEMO_MP, root / "ckpts" / "demo_mp")
    rows = multiproc_export.main(["--truncate", "1.0", "--ha-num", "2",
                                  "--device", "cpu", "--timeout", "300"])
    assert [r.get("mode") for r in rows] == ["2proc_shard", "1proc", None]
    assert rows[2]["merged_equals_single"] is True
    assert rows[2]["n_images"] == rows[2]["n_byte_equal"] == 4
    assert all(r["images"] == 4 and r["ha_num"] == 2 for r in rows[:2])
    written = (root / "evidence" / "multiproc_export.jsonl").read_text()
    assert [json.loads(line) for line in written.splitlines()] == rows
    logs = root / "outputs" / "multiproc_export"
    assert {p.name for p in logs.glob("*/*.log")} == {"rank0.log",
                                                      "rank1.log"}
    assert len(list(logs.glob("*/*.log"))) == 3
