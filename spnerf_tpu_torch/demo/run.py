"""The demo's chain (``demo/run_demo.sh``) through the port: stand-in
data -> MagicPoint -> fabricated 3-D scenes -> NeRF per scene -> rendered
views with depth -> multi-view labels -> the two SuperPoint arms on one
corpus (NeRF supervision with the 3-D reprojection loss, and the
homography control) -> relative-pose AUC on GT ray-traced test views,
HPatches repeatability and matching.

    python -m spnerf_tpu_torch.demo.run [leg] [--device cpu]
        [--set LEG:KEY=VALUE ...]

Legs: data, mp, export, sp, eval (the homography legs), nerf_data, nerf,
nerf_export, link, ctl_export, nerf_sp, ctl_sp, pose. Without a leg the
default chain runs, in ``CHAIN``'s order; a leg that fails stops it with
a non-zero exit. Training legs resume from their latest checkpoint under
``CKPT_PATH/<name>/`` (the resume arguments go last, so they win over
the leg's own ``--set pretrained=...``) and skip when it has reached the
leg's target. Downstream legs start from the latest MagicPoint checkpoint.
Everything runs in this process, on the card unless ``--device cpu``: the
task CLI, ``eval.on_the_fly`` and ``eval.pose`` through their
``main(argv)``, the fabricators through theirs.

Settings (environment, as the shell script reads them): ``SPNERF_ROOT``
(data, checkpoints, outputs and ``evidence/``), ``SPNERF_MP_TARGET``
(15000), ``SPNERF_MP_VALIDATE`` (1), ``SPNERF_N_SCENES`` (16),
``SPNERF_N_TRAIN_VIEWS`` (60), ``SPNERF_SP_TARGET`` (12000); and, for
cut runs, ``SPNERF_N_COCO`` (5000), ``SPNERF_N_HPATCHES`` (30),
``SPNERF_N_VIEWS`` (48 fabricated views a scene), ``SPNERF_NERF_ITERS``
(3000). ``--set LEG:KEY=VALUE`` adds a config override to the leg's
task calls (before the resume arguments).

Evidence goes to ``$SPNERF_ROOT/evidence/``: ``quality.jsonl`` (eval),
``pose_auc.jsonl`` and ``nerf_test_psnr.jsonl`` (pose), and
``summary.json``, written and printed after every run, in place of the
reference's markdown tables. The pose leg first makes the SIFT
calibration row (``baseline/sift``, OpenCV's SIFT through the same pose
protocol, ``pose_baseline_classical.py``), once per ``pose_auc.jsonl``,
then the arms' rows.

Departures from the shell script: the NeRF arm's scene list holds only
the directories under ``DATA_PATH/NeRF`` (the shell's ``ls`` also lists
the leg's report file there), and a leg whose MagicPoint or control
checkpoint is missing stops the chain (the shell passes an empty name
on).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

import torch

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.demo import (gt_test_views, link_corpus, nerf_leg,
                                   nerf_scenes, nerf_test_psnr,
                                   pose_baseline_classical, pose_stability,
                                   standin_data)
from spnerf_tpu_torch.eval import on_the_fly, pose

CONFIGS = Path(__file__).resolve().parent / "configs"
LEGS = ("data", "mp", "export", "sp", "eval", "nerf_data", "nerf",
        "nerf_export", "link", "ctl_export", "nerf_sp", "ctl_sp", "pose")
# run_demo.sh's default chain: the matched-corpus two-arm experiment
CHAIN = ("data", "mp", "nerf_data", "nerf", "nerf_export", "link",
         "ctl_export", "nerf_sp", "ctl_sp", "pose", "eval")
ARMS = ("demo_sp_nerf", "demo_sp_ctl")
N_TEST_VIEWS = 12  # the test arc of the nerf and pose legs
SIFT_TAG = "baseline/sift"


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def evidence(name: str) -> Path:
    return Path(settings.EVIDENCE_PATH, name)


def latest_iter(name: str) -> int | None:
    """The newest checkpoint iteration of ``name``, None if it has none."""
    its = [int(m.group(1)) for p in Path(settings.CKPT_PATH, name).glob(
        f"{name}_*.ckpt") if (m := re.fullmatch(rf"{re.escape(name)}_(\d+)"
                                                r"\.ckpt", p.name))]
    return max(its) if its else None


def resume_args(name: str, target: int) -> list | None:
    """The arguments that resume ``name`` from its latest checkpoint ([]
    when it has none), or None when it has reached ``target``."""
    it = latest_iter(name)
    if it is None:
        return []
    if it >= target:
        print(f"{name} already at {it} iters, skipping")
        return None
    print(f"{name} resuming from iteration {it}")
    return ["--set", f"pretrained={name}/{name}_{it}.ckpt",
            "--set", "continue_training=True"]


def mp_seed() -> str:
    """The latest MagicPoint checkpoint, the seed of every later leg."""
    it = latest_iter("demo_mp")
    if it is None:
        raise SystemExit("no demo_mp checkpoint - run the mp leg first")
    return f"demo_mp/demo_mp_{it}.ckpt"


def scene_dirs(sub: str) -> list:
    root = Path(settings.DATA_PATH, sub)
    return sorted(p.name for p in root.iterdir() if p.is_dir()) \
        if root.is_dir() else []


class Demo:
    """The legs, on ``device``, with ``cuts`` ({leg: ["KEY=VALUE", ...]})
    added to each leg's task calls."""

    def __init__(self, device: str = "cuda", cuts: dict | None = None):
        self.device = device
        self.cuts = cuts or {}

    def sets(self, leg: str) -> list:
        return [a for kv in self.cuts.get(leg, []) for a in ("--set", kv)]

    def task(self, leg: str, config: str, task: str, *args, resume=()):
        return cli.main(["--config-path", str(CONFIGS / config), "--task",
                         task, *args, *self.sets(leg), *resume, "--device",
                         self.device])

    def train(self, leg: str, config: str, name: str, target: int, *args):
        """run_demo.sh's ``train_leg``: the leg's arguments, then the
        resume arguments last."""
        resume = resume_args(name, target)
        if resume is None:
            return None
        return self.task(leg, config, "train", *args, resume=resume)

    def run(self, leg: str):
        if leg not in LEGS:
            raise SystemExit(f"unknown leg {leg!r}; legs: {', '.join(LEGS)}")
        return getattr(self, f"leg_{leg}")()

    def leg_data(self):
        standin_data.main(["--n-coco", str(env_int("SPNERF_N_COCO", 5000)),
                           "--n-hpatches",
                           str(env_int("SPNERF_N_HPATCHES", 30))])

    def leg_mp(self):
        target = env_int("SPNERF_MP_TARGET", 15000)
        validate = (["--validate-training"]
                    if os.environ.get("SPNERF_MP_VALIDATE", "1") == "1"
                    else [])
        return self.train("mp", "magicpoint_syn_demo.yaml", "demo_mp",
                          target, "--set", f"train.num_iters={target}",
                          *validate)

    def leg_export(self):
        return self.task("export", "coco_export_demo.yaml",
                         "export_pseudo_labels", "--split", "training")

    def leg_sp(self):
        return self.train("sp", "superpoint_demo.yaml", "demo_sp", 50000)

    def leg_eval(self):
        it = latest_iter("demo_sp_ctl")
        if it is None:
            raise SystemExit("no demo_sp_ctl checkpoint - run ctl_sp first")
        out = []
        for mode, k in (("repeatability", 300), ("descriptors", 1000)):
            out.append(on_the_fly.main([
                "--config-path", str(CONFIGS / "eval_demo.yaml"), "--set",
                f"pretrained=demo_sp_ctl/demo_sp_ctl_{it}.ckpt", "--mode",
                mode, "--k-points", str(k), "--json-out",
                str(evidence("quality.jsonl")), *self.sets("eval"),
                "--device", self.device]))
        return out

    def leg_nerf_data(self):
        nerf_scenes.main(["--n-scenes", str(env_int("SPNERF_N_SCENES", 16)),
                          "--n-views", str(env_int("SPNERF_N_VIEWS", 48))])

    def leg_nerf(self):
        return nerf_leg.main([
            "--n-train-views", str(env_int("SPNERF_N_TRAIN_VIEWS", 60)),
            "--n-test-views", str(N_TEST_VIEWS),
            "--iters", str(env_int("SPNERF_NERF_ITERS", 3000)),
            "--device", self.device])

    def leg_nerf_export(self):
        seed = mp_seed()
        for s in scene_dirs("NeRF_gt"):
            self.task("nerf_export", "nerf_export_demo.yaml",
                      "export_NeRF_labels", "--set", f"pretrained={seed}",
                      "--set", f"data.data_dir={s}", "--set",
                      f"data.experiment_name=demo_export_NeRF/{s}")

    def leg_nerf_sp(self):
        target = env_int("SPNERF_SP_TARGET", 12000)
        scenes = scene_dirs("NeRF")
        dirs = ",".join(f"'{s}'" for s in scenes)
        labels = ",".join(f"'outputs/demo_export_NeRF/{s}'" for s in scenes)
        return self.train("nerf_sp", "superpoint_nerf_demo.yaml",
                          "demo_sp_nerf", target,
                          "--set", f"train.num_iters={target}",
                          "--set", f"pretrained={mp_seed()}",
                          "--set", f"data.all_data_dirs=[{dirs}]",
                          "--set", f"data.all_label_dirs=[{labels}]",
                          "--train-nerf", "--nerf-loss")

    def leg_link(self):
        return link_corpus.main()

    def leg_ctl_export(self):
        # HA pseudo-labels over the same rendered views (the control arm)
        return self.task("ctl_export", "coco_export_ctl.yaml",
                         "export_pseudo_labels", "--split", "training",
                         "--set", f"pretrained={mp_seed()}")

    def leg_ctl_sp(self):
        target = env_int("SPNERF_SP_TARGET", 12000)
        return self.train("ctl_sp", "superpoint_ctl_demo.yaml",
                          "demo_sp_ctl", target,
                          "--set", f"train.num_iters={target}",
                          "--set", f"pretrained={mp_seed()}")

    def pose_row(self, arm: str, it) -> dict | None:
        """Pose AUC of one checkpoint, appended to pose_auc.jsonl; skipped
        when the checkpoint is missing or already has its row."""
        ckpt = f"{arm}/{arm}_{it}.ckpt"
        out = evidence("pose_auc.jsonl")
        if it is None or not Path(settings.CKPT_PATH, ckpt).is_file():
            return None
        if out.exists() and f'"{ckpt}"' in out.read_text():
            return None
        print(f"== pose AUC: {ckpt} ==")
        return pose.main(["--config-path", str(CONFIGS / "pose_demo.yaml"),
                          "--set", f"pretrained={ckpt}", "--json-out",
                          str(out), *self.sets("pose"), "--device",
                          self.device])

    def sift_row(self) -> dict | None:
        """The SIFT calibration row, appended to pose_auc.jsonl unless it
        holds one already."""
        out = evidence("pose_auc.jsonl")
        if out.exists() and SIFT_TAG in out.read_text():
            return None
        print(f"== pose AUC: {SIFT_TAG} ==")
        return pose_baseline_classical.main([
            "--feature", "sift", "--config-path",
            str(CONFIGS / "pose_demo.yaml"), "--json-out", str(out),
            *self.sets("pose")])

    def leg_pose(self):
        gt_test_views.main(["--n-test-views", str(N_TEST_VIEWS)])
        self.sift_row()
        for it in range(2000, 60001, 2000):
            for arm in ARMS:
                self.pose_row(arm, it)
        # later checkpoints (extended legs) get rows too
        for arm in ARMS:
            self.pose_row(arm, latest_iter(arm))
        # novel-view quality of the NeRF renders on the evaluation arc
        nerf_test_psnr.main(out=evidence("nerf_test_psnr.jsonl"))
        pose_stability.main()


def read_jsonl(path: Path) -> list:
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


def summary() -> dict:
    """The evidence files' newest rows: quality by (mode, checkpoint),
    pose by checkpoint (the SIFT row among them), each arm's stability
    (``baseline`` for the SIFT row), the NeRF test PSNR; written to
    ``evidence/summary.json``."""
    quality = {}
    for r in read_jsonl(evidence("quality.jsonl")):
        quality[f"{r['mode']}:{r.get('pretrained')}"] = r
    poses = {}
    for r in read_jsonl(evidence("pose_auc.jsonl")):
        poses[r.get("pretrained") or "?"] = r
    src = pose_stability.source()
    psnr = [r for r in read_jsonl(evidence("nerf_test_psnr.jsonl"))
            if r.get("scene") == "ALL"]
    out = {"quality": list(quality.values()), "pose": list(poses.values()),
           "stability": pose_stability.arm_rows(src) if src.exists() else [],
           "nerf_test_psnr": psnr[-1] if psnr else None}
    path = evidence("summary.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return out


def parse_cuts(items) -> dict:
    cuts = {}
    for item in items:
        leg, sep, kv = item.partition(":")
        if not sep or leg not in LEGS or "=" not in kv:
            raise SystemExit(f"--set takes LEG:KEY=VALUE with LEG one of "
                             f"{', '.join(LEGS)}; got {item!r}")
        cuts.setdefault(leg, []).append(kv)
    return cuts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("leg", nargs="?", default="all",
                   choices=("all",) + LEGS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--set", dest="cuts", action="append", default=[],
                   metavar="LEG:KEY=VALUE")
    args = p.parse_args(argv)
    demo = Demo(args.device, parse_cuts(args.cuts))
    for leg in CHAIN if args.leg == "all" else (args.leg,):
        demo.run(leg)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(summary()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
