"""A two-process sharded HA export against one process
(``tools/multiproc_export_demo.py``).

Two ranks (``tools/smoke_dist.spawn_ranks``' ``cli`` job: processes
started with ``torchrun``'s variables on localhost, joined by gloo) each
run ``export_pseudo_labels`` on the demo's ``coco_export_demo.yaml`` with
``data.shard=auto``: each exports its contiguous block of the stand-in
COCO images into one experiment directory. Then one process runs the
same export into a second directory, and the two sets of ``.npy`` files
are compared value for value: the homographies of an image are drawn
from (seed, its global index), and a shard carries its block's offset,
so the merged labels must equal the single run's. Both ranks run on the
one card (gloo lets two processes share it; NCCL does not) unless
``--device cpu``. The overrides are the reference's: ``data.truncate``,
images resized to 120 x 160, ``homography_adaptation.num`` and ``chunk``
= min(num, 4), the latest ``demo_mp`` checkpoint (``run.mp_seed``).

    python -m spnerf_tpu_torch.demo.multiproc_export [--truncate 0.1]
        [--ha-num 8] [--json-out FILE] [--device cpu] [--timeout S]

prints the reference's three rows (``2proc_shard`` and ``1proc`` with
images, img/s and seconds, each run's process starts included, then the
equality verdict) as JSON lines, appends them to ``--json-out`` (default
``EVIDENCE_PATH/multiproc_export.jsonl``) and exits non-zero when the
sets differ; ``main`` returns the rows. The processes' logs go to
``EXPER_PATH/multiproc_export/{shard,single}/rank<r>.log``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings
from spnerf_tpu_torch.demo import run
from spnerf_tpu_torch.tools import smoke_dist

CONFIG = run.CONFIGS / "coco_export_demo.yaml"
RANKS = 2


def cli_argv(exper: str, truncate: float, ha_num: int, device: str,
             extra=()) -> list:
    return ["--config-path", str(CONFIG), "--task", "export_pseudo_labels",
            "--split", "training",
            "--set", f"pretrained={run.mp_seed()}",
            "--set", f"data.truncate={truncate}",
            "--set", "data.preprocessing.resize=[120,160]",
            "--set", f"homography_adaptation.num={ha_num}",
            "--set", f"homography_adaptation.chunk={min(ha_num, 4)}",
            "--set", f"data.experiment_name={exper}", *extra,
            "--device", device]


def timed_ranks(world: int, argv: list, out: Path, device: str,
                timeout: float) -> float:
    """Seconds of ``world`` processes running ``cli.main(argv)`` in one
    gloo group (none for one), their starts included."""
    t0 = time.perf_counter()
    smoke_dist.spawn_ranks("cli", world, {"argv": argv}, out,
                           backend="gloo", device=device,
                           timeout=timeout).wait()
    return time.perf_counter() - t0


def compare(multi_dir: Path, single_dir: Path) -> tuple:
    """(same names, images value-equal, images of the single run)."""
    multi = {p.name: p for p in multi_dir.glob("*.npy")}
    single = {p.name: p for p in single_dir.glob("*.npy")}
    n_equal = sum(1 for n in multi if n in single
                  and np.array_equal(np.load(multi[n]), np.load(single[n])))
    return set(multi) == set(single), n_equal, len(single)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--truncate", type=float, default=0.1)
    ap.add_argument("--ha-num", type=int, default=8)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=5400.0)
    args = ap.parse_args(argv)

    logs = Path(settings.EXPER_PATH, "multiproc_export")
    t_multi = timed_ranks(RANKS, cli_argv(
        "mp2_shard", args.truncate, args.ha_num, args.device,
        ("--set", "data.shard=auto")), logs / "shard", args.device,
        args.timeout)
    t_single = timed_ranks(1, cli_argv(
        "mp2_single", args.truncate, args.ha_num, args.device),
        logs / "single", args.device, args.timeout)

    root = Path(settings.EXPER_PATH, "outputs")
    same_names, n_equal, n_single = compare(root / "mp2_shard" / "training",
                                            root / "mp2_single" / "training")
    ok = same_names and n_equal == n_single and n_single > 0
    rows = [{"metric": "multiproc_ha_export", "mode": label,
             "images": n_single, "ha_num": args.ha_num,
             "img_per_sec": round(n_single / secs, 3),
             "seconds": round(secs, 1)}
            for label, secs in (("2proc_shard", t_multi),
                                ("1proc", t_single))]
    rows.append({"metric": "multiproc_ha_export_equality",
                 "merged_equals_single": bool(ok),
                 "n_images": n_single, "n_byte_equal": n_equal,
                 "note": f"{RANKS} gloo ranks sharing one "
                         f"{'card' if args.device == 'cuda' else 'CPU'}: "
                         "equality (not speedup) is the claim"})
    out = Path(args.json_out or Path(settings.EVIDENCE_PATH,
                                     "multiproc_export.jsonl"))
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for row in rows:
            print(json.dumps(row))
            f.write(json.dumps(row) + "\n")
    if not ok:
        raise SystemExit("MERGED ARTIFACTS DIFFER FROM SINGLE-PROCESS EXPORT")
    return rows


if __name__ == "__main__":
    main()
