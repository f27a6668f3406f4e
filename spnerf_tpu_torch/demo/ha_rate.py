"""Steady-state HA export rate from the output files' mtimes
(``tools/ha_rate.py``): the first ``--warmup-frac`` of the files by mtime
(at least one) are the warm-up, and the rate is the files after it over
the span from the last warm-up file's mtime to the last file's.

    python -m spnerf_tpu_torch.demo.ha_rate OUTPUT_DIR [--warmup-frac 0.2]
        [--label NAME]

prints one JSON line (``metric`` ha_export_imgs_per_sec, ``label``,
``value`` rounded to 2 places (NaN for a zero span), ``unit``,
``n_total``, ``n_measured``, ``span_s`` rounded to 0.1 s) and returns it
from ``main``; fewer than 10 outputs stop it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def rate(output_dir: Path, warmup_frac: float = 0.2) -> dict:
    files = sorted(Path(output_dir).glob("*.npy"),
                   key=lambda p: p.stat().st_mtime)
    if len(files) < 10:
        raise SystemExit(f"only {len(files)} outputs in {output_dir}")
    k = max(1, int(len(files) * warmup_frac))
    t0 = files[k - 1].stat().st_mtime
    t1 = files[-1].stat().st_mtime
    n = len(files) - k
    return {"value": n / (t1 - t0) if t1 > t0 else float("nan"),
            "n_total": len(files), "n_measured": n, "span_s": t1 - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("output_dir")
    ap.add_argument("--warmup-frac", type=float, default=0.2)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    r = rate(Path(args.output_dir), args.warmup_frac)
    row = {"metric": "ha_export_imgs_per_sec",
           "label": args.label or Path(args.output_dir).name,
           "value": round(r["value"], 2), "unit": "imgs/sec",
           "n_total": r["n_total"], "n_measured": r["n_measured"],
           "span_s": round(r["span_s"], 1)}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
