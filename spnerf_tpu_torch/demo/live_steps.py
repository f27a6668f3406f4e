"""Live training steps/s of the demo's legs from their metric logs
(``tools/live_steps.py``): every ``perf/steps_per_sec`` sample of
``CKPT_PATH/<leg>/logs/metrics.jsonl`` (the training loop's ``StepTimer``
windows), one row a leg with 3 samples or more: the median, 10th and 90th
percentiles of the tail after the first quarter (at least the first
sample dropped: it carries the compile and the first loads).

    python -m spnerf_tpu_torch.demo.live_steps [--json-out FILE]

prints the rows as JSON lines and appends them to ``--json-out``
(default ``EVIDENCE_PATH/train_live.jsonl``); ``main`` returns them. Legs
with fewer than 3 samples get no row; ``short_legs`` names them with
their counts.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from spnerf_tpu_torch import settings

TAG = "perf/steps_per_sec"


def samples(log: Path) -> list:
    vals = []
    for line in log.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if r.get("tag") == TAG:
            vals.append(float(r["value"]))
    return vals


def samples_by_leg() -> dict:
    """{leg: its samples} of every leg under ``CKPT_PATH`` with a log."""
    root = Path(settings.CKPT_PATH)
    if not root.is_dir():
        return {}
    return {d.name: samples(d / "logs" / "metrics.jsonl")
            for d in sorted(root.iterdir())
            if (d / "logs" / "metrics.jsonl").exists()}


def short_legs(by_leg: dict) -> dict:
    """{leg: sample count} of the legs with fewer than 3 samples."""
    return {leg: len(v) for leg, v in by_leg.items() if len(v) < 3}


def rows(by_leg: dict) -> list:
    out = []
    for leg, vals in by_leg.items():
        if len(vals) < 3:
            continue
        tail = vals[max(1, len(vals) // 4):]
        out.append({"metric": "train_live_steps_per_sec", "leg": leg,
                    "median": round(float(np.median(tail)), 2),
                    "p10": round(float(np.percentile(tail, 10)), 2),
                    "p90": round(float(np.percentile(tail, 90)), 2),
                    "n_samples": len(vals)})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    found = rows(samples_by_leg())
    for r in found:
        print(json.dumps(r))
    if found:
        out = Path(args.json_out or Path(settings.EVIDENCE_PATH,
                                         "train_live.jsonl"))
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            for r in found:
                f.write(json.dumps(r) + "\n")
    return found


if __name__ == "__main__":
    main()
