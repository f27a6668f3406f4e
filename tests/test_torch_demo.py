"""The demo through the port (``spnerf_tpu_torch/demo``) against the
reference scripts of ``demo/``: the fabricated files (stand-in COCO and
HPatches JPEGs and homographies, the scenes' PNG pixels, the pose-pair
text) of both packages equal each other and ``demo/digests.json`` at the
``[demo]`` phase's counts; ``build_scene`` / ``render_scene`` at a small
size, ``orbit_with_jitter`` and ``arc_poses``, the link names and the nine
config copies equal the reference's; ``run.py`` keeps the default chain
and builds the reference's arguments, resume arguments last.

The reference side is one child process (``tests/_demo_reference.py``):
the reference reads ``SPNERF_DATA_PATH`` at import.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.data import png
from spnerf_tpu_torch.demo import (gt_test_views, link_corpus, nerf_leg,
                                   nerf_scenes, run, standin_data)
from spnerf_tpu_torch.eval import cv_rng
from spnerf_tpu_torch.tools import smoke_demo

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _demo_reference as ref  # noqa: E402

CONFIGS = sorted((ROOT / "demo" / "configs").glob("*.yaml"))


@pytest.fixture(scope="module")
def ref_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_ref")
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "_demo_reference.py"),
                           str(root)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    """The port's fabricators at the reference run's counts, each from a
    worker thread whose OpenCV generator has drawn before (the
    fabricators restart it)."""
    root = tmp_path_factory.mktemp("demo_port")
    data = root / "data"
    c = ref.COUNTS
    jobs = [
        lambda: standin_data.main(["--n-coco", str(c["n_coco"]),
                                   "--n-hpatches", str(c["n_hpatches"])],
                                  root=data),
        lambda: nerf_scenes.main(["--n-scenes", str(c["n_scenes"]),
                                  "--n-views", str(c["n_views"])], root=data),
        lambda: gt_test_views.main(["--n-test-views",
                                    str(c["n_test_views"])], root=data)]
    errors = []
    for job in jobs:
        def work(job=job):
            try:
                cv_rng.randu(np.zeros(100, np.uint8), 0, 255)
                job()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert not errors, errors
    scenes = sorted(p.name for p in (data / "NeRF_gt").iterdir())
    test_poses = nerf_leg.test_arc(c["n_test_views"])
    for s in scenes:
        views = data / "NeRF" / s / "images" / "training"
        views.mkdir(parents=True)
        np.save(data / "NeRF" / s / "poses_test.npy", test_poses)
        for i in range(ref.LINKED_VIEWS):
            (views / f"{i}.png").write_bytes(b"")
    nerf_leg.write_pose_pairs(scenes, data / "nerf_pose_pairs.txt",
                              n_test=c["n_test_views"], min_gap=2,
                              max_gap=5, root=data)
    link_corpus.main(root=data)
    return root


def fixture() -> dict:
    return json.loads(smoke_demo.FIXTURE.read_text())


def cv2_gray(path):
    return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)


def test_fixture_counts_are_the_phase_counts():
    assert fixture()["counts"] == ref.COUNTS
    env = smoke_demo.ENV
    assert ref.COUNTS == {"n_coco": int(env["SPNERF_N_COCO"]),
                          "n_hpatches": int(env["SPNERF_N_HPATCHES"]),
                          "n_scenes": int(env["SPNERF_N_SCENES"]),
                          "n_views": int(env["SPNERF_N_VIEWS"]),
                          "n_test_views": run.N_TEST_VIEWS}


@pytest.mark.parametrize("side", ["reference", "port"])
def test_fabricated_files_match_digests(side, ref_root, port_root):
    root = ref_root if side == "reference" else port_root
    reader = cv2_gray if side == "reference" else png.read_gray
    got = smoke_demo.digests(root / "data", reader)
    want = fixture()["files"]
    assert len(want) == 112
    assert got == want


def test_orb_of_gt_test_views_matches_fixture(port_root):
    """The port's ORB on its GT test views carries the digests of cv2's
    ORB on the reference's (``digests.json["orb"]``), as ``[orb]`` checks
    on the card."""
    want = fixture()["orb"]
    assert len(want) == ref.COUNTS["n_scenes"] * ref.COUNTS["n_test_views"]
    assert len(smoke_demo.orb_ms(port_root / "data", want)) == len(want)


def test_fabricated_trees_equal(ref_root, port_root):
    """Every file either side wrote (depth and poses too): JPEG, text and
    .npy bytes equal, PNG pixels equal."""
    a, b = ref_root / "data", port_root / "data"
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for rel in names:
        if rel.suffix == ".png" and (a / rel).stat().st_size:
            np.testing.assert_array_equal(png.read_gray(b / rel),
                                          cv2_gray(a / rel), err_msg=str(rel))
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_link_names(ref_root, port_root):
    def links(root):
        d = root / "data" / "COCO_nerf_views" / "images" / "training"
        return {p.name: Path(p.readlink()).relative_to(root).as_posix()
                for p in d.iterdir()}
    assert links(port_root) == links(ref_root)
    assert len(links(port_root)) == ref.COUNTS["n_scenes"] * ref.LINKED_VIEWS


def test_small_scene_and_orbits(ref_root, tmp_path):
    extra = ref_root / "extra"
    rng = np.random.default_rng(1)
    np.savetxt(tmp_path / "orbit.txt",
               nerf_scenes.orbit_with_jitter(rng, 5).reshape(-1, 4))
    np.savetxt(tmp_path / "arc.txt", nerf_leg.arc_poses(
        7, radius=4.0, height=0.3, start_deg=0.0).reshape(-1, 4))
    for name in ("orbit.txt", "arc.txt"):
        assert (tmp_path / name).read_text() == (extra / name).read_text()
    standin_data.fresh_cv_rng()
    rects = nerf_scenes.build_scene(np.random.default_rng(2), n_rects=3)
    K = nerf_scenes.camera_intrinsics(ref.SMALL_SHAPE, 60.0)
    img, depth = nerf_scenes.render_scene(
        rects, K, nerf_scenes.pose_orbit(4)[1], ref.SMALL_SHAPE)
    np.testing.assert_array_equal(img, np.load(extra / "small_img.npy"))
    np.testing.assert_array_equal(depth, np.load(extra / "small_depth.npy"))


def test_rebuild_checks_the_generator(port_root):
    """gt_test_views rebuilds a scene only from OpenCV's generator in
    step: scene 1 rebuilt without scene 0 first does not reproduce its
    training view."""
    data = port_root / "data"
    scene = data / "NeRF_gt" / "demo_scene01"
    K = np.load(scene / "intrinsics.npy")
    standin_data.fresh_cv_rng()
    with pytest.raises(RuntimeError, match="out of step"):
        gt_test_views.verify_rebuild(scene, gt_test_views.rebuild_rects(1),
                                     K)
    standin_data.fresh_cv_rng()
    gt_test_views.rebuild_rects(0)
    gt_test_views.verify_rebuild(scene, gt_test_views.rebuild_rects(1), K)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_copies_load_equal(path):
    from spnerf_tpu_torch.utils.config import load_config

    assert load_config(run.CONFIGS / path.name) == yaml.safe_load(
        path.read_text())


def test_chain_is_run_demo_sh_default():
    text = (ROOT / "demo" / "run_demo.sh").read_text()
    body = text.split('if [ "$LEG" = all ]; then')[1].split("done")[0]
    chain = body.split("for l in")[1].split(";")[0].replace("\\", " ")
    assert run.CHAIN == tuple(chain.split())
    assert set(run.CHAIN) <= set(run.LEGS)
    assert {p.name for p in run.CONFIGS.glob("*.yaml")} == {
        p.name for p in CONFIGS}


@pytest.fixture
def ckpt_root(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path / "ckpts")
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path / "data")
    monkeypatch.setattr(settings, "EVIDENCE_PATH", tmp_path / "evidence")
    for name, its in (("demo_mp", (2000, 15000, 400)),
                      ("demo_sp_ctl", (2000,)), ("demo_sp_nerf", ())):
        d = tmp_path / "ckpts" / name
        d.mkdir(parents=True)
        for it in its:
            (d / f"{name}_{it}.ckpt").write_bytes(b"")
        (d / f"{name}_final.ckpt").write_bytes(b"")  # not an iteration
    return tmp_path


def test_resume_arguments(ckpt_root):
    assert run.latest_iter("demo_mp") == 15000
    assert run.latest_iter("demo_sp_nerf") is None
    assert run.latest_iter("missing") is None
    assert run.mp_seed() == "demo_mp/demo_mp_15000.ckpt"
    assert run.resume_args("demo_mp", 15000) is None
    assert run.resume_args("demo_sp_nerf", 12000) == []
    assert run.resume_args("demo_sp_ctl", 12000) == [
        "--set", "pretrained=demo_sp_ctl/demo_sp_ctl_2000.ckpt",
        "--set", "continue_training=True"]


def test_legs_build_the_reference_arguments(ckpt_root, monkeypatch):
    calls = []
    monkeypatch.setattr(run.cli, "main", lambda argv: calls.append(argv))
    monkeypatch.setenv("SPNERF_SP_TARGET", "4000")
    for s in ("demo_scene00", "demo_scene01"):
        (ckpt_root / "data" / "NeRF" / s).mkdir(parents=True)
        (ckpt_root / "data" / "NeRF_gt" / s).mkdir(parents=True)
    (ckpt_root / "data" / "NeRF" / "nerf_leg_report.json").write_text("{}")
    demo = run.Demo("cpu", run.parse_cuts(["ctl_sp:train.learning_rate=1e-4"]))
    demo.run("ctl_sp")
    demo.run("nerf_sp")
    demo.run("nerf_export")
    demo.run("mp")  # at its 15000 target: skipped
    ctl, nerf, *exports = calls
    assert ctl[-8:] == [
        "--set", "train.learning_rate=1e-4",
        "--set", "pretrained=demo_sp_ctl/demo_sp_ctl_2000.ckpt",
        "--set", "continue_training=True", "--device", "cpu"]
    assert ctl[:8] == [
        "--config-path", str(run.CONFIGS / "superpoint_ctl_demo.yaml"),
        "--task", "train", "--set", "train.num_iters=4000",
        "--set", "pretrained=demo_mp/demo_mp_15000.ckpt"]
    assert "data.all_data_dirs=['demo_scene00','demo_scene01']" in nerf
    assert ("data.all_label_dirs=['outputs/demo_export_NeRF/demo_scene00',"
            "'outputs/demo_export_NeRF/demo_scene01']") in nerf
    assert nerf[-3:] == ["--nerf-loss", "--device", "cpu"]
    assert [e[e.index("--set") + 3] for e in exports] == [
        "data.data_dir=demo_scene00", "data.data_dir=demo_scene01"]
    assert len(calls) == 4
    with pytest.raises(SystemExit):
        run.parse_cuts(["nowhere:key=1"])


def test_summary_without_evidence(ckpt_root):
    out = run.summary()
    assert out["pose"] == [] and out["quality"] == []
    assert "sift" not in out
    assert json.loads((ckpt_root / "evidence" / "summary.json").read_text()) \
        == out


def test_empty_training_loader_raises():
    """A training set smaller than its batch (the partial batch dropped)
    yields no batch: ``iter_forever`` raises where it spun without end
    (the demo's MagicPoint at batch 32 over 27 truncated samples)."""
    from spnerf_tpu_torch.data.loader import DataLoader
    from spnerf_tpu_torch.tasks.train_task import iter_forever

    loader = DataLoader([{"x": np.zeros(1)}] * 3, batch_size=4,
                        shuffle=True, drop_last=True)
    with pytest.raises(ValueError, match="no batch"):
        next(iter_forever(loader))
    full = iter_forever(DataLoader([{"x": np.zeros(1)}] * 4, batch_size=4,
                                   shuffle=False, drop_last=True))
    assert [len(next(full)["x"]) for _ in range(3)] == [4, 4, 4]


def test_pose_leg_makes_the_sift_row_once(port_root, tmp_path, monkeypatch):
    """The pose leg on the fabricated GT split (two of its pairs, through
    the leg's ``--set``): the SIFT calibration row is written first and
    once, a rerun keeps it single, and ``summary.json`` holds it as the
    ``baseline`` arm. No checkpoint exists, so no arm row is made."""
    data = port_root / "data"
    monkeypatch.setattr(settings, "DATA_PATH", data)
    monkeypatch.setattr(settings, "CKPT_PATH", tmp_path / "ckpts")
    monkeypatch.setattr(settings, "EVIDENCE_PATH", tmp_path / "evidence")
    pairs = tmp_path / "two_pairs.txt"
    pairs.write_text("\n".join((data / "gt_pose_pairs.txt").read_text()
                               .splitlines()[:2]) + "\n")
    demo = run.Demo("cpu", run.parse_cuts([f"pose:data.gt_pairs={pairs}"]))
    for _ in range(2):
        demo.run("pose")
    rows = run.read_jsonl(tmp_path / "evidence" / "pose_auc.jsonl")
    assert [r["pretrained"] for r in rows] == [run.SIFT_TAG]
    assert rows[0]["num_pairs"] == 2
    out = run.summary()
    assert [r["pretrained"] for r in out["pose"]] == [run.SIFT_TAG]
    assert [r["arm"] for r in out["stability"]] == ["baseline"]
    assert "sift" not in out and not hasattr(run, "SIFT_NOTE")
