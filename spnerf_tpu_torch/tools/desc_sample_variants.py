"""Design variants of the ring instance of the fused descriptor sampler
(kernel-table row 8), timed on the card.

    python -m spnerf_tpu_torch.tools.desc_sample_variants [--variants NAMES]
        [--bands N,...] [--points request|uniform] [--sass] [--out PATH]

Each variant is an edited copy of ``kernels/csrc/desc_sample.cu`` built
into ``build/desc_sample_variants/<name>/`` by one nvcc each, all at once.
Each library is then put in place of the sampler's library and
``sample_descriptors_fused`` is called on a request's sampling operands
(``kernel_times``' row 8 case: batch 64, a 60 x 80 x 256 bf16 map, 1,024
seeded points spread as a request's candidates, or evenly with
``--points uniform``), normalized and raw, at the default band count and
at each of ``--bands``. Per variant: ``desc_sample_ring_kernel``'s
device time by ``torch.profiler`` (20 calls), in rounds v1 .. vn, vn ..
v1, and the largest error against the plain version (cuts compute wrong
rows: their time is the cost of what is left, not a result). ptxas's
registers and stack are printed; ``--sass`` also counts the ring
kernel's instructions by opcode (``cuobjdump -sass``). Without a card it
exits non-zero.

Variants of the kernel as committed (24 consumer warps, taps read 4 at a
time, each row one cp.async.bulk):
* ``c8``: 8 consumer warps reading all 16 taps at once; ``c16_b8``: 16
  reading 8 at a time; ``c20``: 20;
* ``shuffle``: each of the 16 weights formed on one lane and shuffled to
  the warp (every lane forms all 16 as committed);
* ``mul_grid``: the raw coordinate by a multiply by 1 / grid in place of
  the IEEE division (the same bits at a power-of-two grid);
* ``row_cost0``, ``row_cost4``, ``row_cost64``: the band split weighing a
  row as 0, 4 or 64 points besides its own (16 as committed);
  ``equal_rows``: bands of equal rows whatever the points;
* cuts: ``no_math`` (the consumers wait on and release every row but
  sample no point: the row stream alone), ``no_copy`` (no row is copied:
  the bucketing and the sampling from shared memory alone, on whatever
  the ring holds; the slow path of a division on non-finite values can
  inflate it), ``coalesced_store`` (a lane's 8 outputs stored as
  channels 4 l .. 4 l + 3 and 128 + 4 l .. so that each store
  instruction covers 512 contiguous bytes: rows permuted), ``no_store``
  (no output stored).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "desc_sample_variants"
SYMBOL = "desc_sample_ring_kernel"

# name -> edits (old text, new text) of desc_sample.cu
_SHUFFLE = ("    for (int j = 0; j < 4; ++j) t.w[4 * i + j] = round_bf16(__fmul_rn(wy[i], wx[j]));",
            "    for (int j = 0; j < 4; ++j)\n"
            "      t.w[4 * i + j] = __shfl_sync(0xffffffffu, round_bf16(__fmul_rn(\n"
            "          wy[(threadIdx.x >> 2) & 3], wx[threadIdx.x & 3])), 4 * i + j);")
_MUL_GRID = ("  return __fsub_rn(__fdiv_rn(__fadd_rn(coord, 0.5f), static_cast<float>(grid)), 0.5f);",
             "  return __fsub_rn(__fmul_rn(__fadd_rn(coord, 0.5f), 1.f / grid), 0.5f);")


def _consumers(n):
    return ("constexpr int kConsumers = 24;", f"constexpr int kConsumers = {n};")


def _batch(n):
    return ("  static constexpr int kBatch = 4;  // taps loaded before their multiply-adds",
            f"  static constexpr int kBatch = {n};")


def _row_cost(n):
    return ("constexpr int kRowCost = 16;", f"constexpr int kRowCost = {n};")


_STORE = ("    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);\n"
          "    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);")

VARIANTS = {
    "base": [],
    "c8": [_consumers(8), _batch(16)],
    "c16_b8": [_consumers(16), _batch(8)],
    "c20": [_consumers(20)],
    "shuffle": [_SHUFFLE],
    "mul_grid": [_MUL_GRID],
    "row_cost0": [_row_cost(0)],
    "row_cost4": [_row_cost(4)],
    "row_cost64": [_row_cost(64)],
    "equal_rows": [_row_cost(1 << 20)],
    "no_math": [("p < end; p += kConsumers) {", "p < end && r < 0; p += kConsumers) {")],
    "no_copy": [("        if (a <= z && start[z + 1] > start[a]) {", "        if (false) {")],
    "coalesced_store": [(_STORE, "    float* q = p - 4 * (threadIdx.x & 31);\n"
                         "    reinterpret_cast<float4*>(q)[0] = make_float4(v[0], v[1], v[2], v[3]);\n"
                         "    reinterpret_cast<float4*>(q + 128)[0] = make_float4(v[4], v[5], v[6], v[7]);")],
    "no_store": [(_STORE, "    if (v[0] != 12345.f) return;\n" + _STORE)],
}


def write_variant(name: str, csrc: Path) -> Path:
    """The variant's source in OUT_DIR / name; raises if an edit's old
    text is not in the source once."""
    out = OUT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    text = (csrc / "desc_sample.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in desc_sample.cu once")
        text = text.replace(old, new)
    (out / "desc_sample.cu").write_text(text)
    return out


def build(names) -> dict:
    """One nvcc per variant, all at once: {name: (library, ptxas lines of
    the ring kernel)}; raises with nvcc's output on a failed build."""
    from spnerf_tpu_torch.kernels import _build

    procs = {}
    for name in names:
        out = write_variant(name, _build.CSRC)
        cmd = _build._nvcc_cmd("desc_sample", out / "libdesc_sample.so")
        cmd[-1] = str(out / "desc_sample.cu")
        procs[name] = (out / "libdesc_sample.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    built = {}
    for name, (lib, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{reports[name]}")
        lines = reports[name].splitlines()
        ptxas = [f"{lines[i + 1].strip()}; {lines[i + 2].strip()}"
                 for i, line in enumerate(lines)
                 if "Compiling entry" in line and SYMBOL in line]
        built[name] = (lib, ptxas)
    return built


def sass_counts(lib: Path) -> dict:
    """{opcode: count} of the ring kernel's SASS (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = SYMBOL in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


def operands(spread: str):
    """kernel_times' row 8 case at a request's shapes, bf16, K 1,024, the
    points spread as ``kernel_times.desc_sample_points`` draws them."""
    from spnerf_tpu_torch.tools.kernel_times import (
        DESC_SAMPLE_KS,
        DESC_SAMPLE_SHAPE,
        desc_sample_points,
    )

    rng = np.random.default_rng(17)
    B, Hc, Wc, C = DESC_SAMPLE_SHAPE
    desc = torch.from_numpy(rng.standard_normal((B, Hc, Wc, C)).astype(np.float32))
    pts = desc_sample_points(rng, B, Hc, Wc, DESC_SAMPLE_KS[0], spread)
    return desc.cuda().bfloat16(), torch.from_numpy(pts).cuda()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--bands", default="",
                        help="comma-separated band counts besides the default")
    parser.add_argument("--points", default="request", choices=("request", "uniform"),
                        help="how the points spread (kernel_times.desc_sample_points)")
    parser.add_argument("--sass", action="store_true",
                        help="count the ring kernel's SASS by opcode")
    parser.add_argument("--out", help="write the results here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("desc_sample_variants: no CUDA device", file=sys.stderr)
        return 1
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import desc_sample as ds
    from spnerf_tpu_torch.tools.kernel_times import device_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in args.variants.split(",") if n]
    built = build(names)
    sass = {}
    for name in names:
        for line in built[name][1]:
            print(f"{name}: {line}", flush=True)
        if args.sass:
            sass[name] = sass_counts(built[name][0])
            print(f"{name} SASS: {json.dumps(sass[name])}", flush=True)
    desc, pts = operands(args.points)
    want = {n: ds.sample_descriptors_fused_plain(desc, pts, 8, n) for n in (True, False)}
    results = {}
    for bands in [None] + [int(b) for b in args.bands.split(",") if b]:
        for rnd, name in enumerate(names + names[::-1]):
            _build._libs["desc_sample"] = ctypes.CDLL(str(built[name][0].resolve()))
            _build._fns.pop(("desc_sample", "desc_sample_launch"), None)

            for normalize in (True, False):
                def fn():
                    return ds.sample_descriptors_fused(desc, pts, 8, normalize, bands)

                err = float((fn() - want[normalize]).abs().max())
                ms, how = device_ms(fn, SYMBOL)
                key = f"{name} bands {bands or 'default'}{'' if normalize else ' raw'}"
                results.setdefault(key, []).append(ms)
                print(f"{key:34s} round {rnd}: {ms:.4f} ms ({how}), max_abs_err {err:.3e}",
                      flush=True)
    _build._libs.pop("desc_sample", None)
    _build._fns.pop(("desc_sample", "desc_sample_launch"), None)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "device_ms": results, "sass": sass}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
