"""Design variants of the float32 render kernel, timed on the card.

    python -m spnerf_tpu_torch.tools.render_variants [--widths 128,64,32]
        [--dense] [--variants NAMES] [--out PATH]

Each variant is an edited copy of ``kernels/csrc/render.cu`` (and of the
headers it names) built into ``build/render_variants/<name>/`` by one
nvcc each, all at once. Each library is then put in place of the render
library and ``render_fused`` / ``render_fused_packed`` is called on the
render drive's operands (``kernel_times.render_drive``: the committed
sphere fields, their bf16 weights as float32, 131,072 orbit rays x 32
samples, early stop on, or off with ``--dense``). Per variant and width:
``render_f32_kernel``'s device time by ``torch.profiler`` (20 calls), in
rounds v1 .. vn, vn .. v1, and the largest rgb and depth error against
the plain version (variants that cut work give wrong images: their time
is the cost of what they cut, not a result). ptxas's registers and stack
of each instance are printed. Without a card it exits non-zero.

Variants of the kernel as committed:
* ``base``: as committed;
* ``sine_branch``: the encoding by ``sine()`` with its Payne-Hanek branch
  in each of the 64 sines of a thread's M-tile, instead of ``sine_fast``
  and the fix-up after them;
* ``lo_w1_made``: lo(w1) made per chunk too at width 128 (no resident
  lo(w1)), in 8 KB chunks of two k-steps;
* ``two_warpgroups``: two warpgroups a block at width 64 (four as
  committed);
* cuts, for the cost of a phase: ``no_lo_w2`` (width 128 reads raw w2 in
  place of the lo(w2) it would make), ``no_sine`` (the encoding's
  argument in place of its sine), ``head_one_pass`` (the head's product
  by x.w alone).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "render_variants"

# name -> edits (file under csrc/, old text, new text)
VARIANTS = {
    "base": [],
    "sine_branch": [
        ("render.cu", "            const float y = sine_fast(x);",
         "            const float y = sine(x);")],
    "lo_w1_made": [
        ("render.cu", "constexpr int kCK = 1;", "constexpr int kCK = 2;"),
        ("render.cu", "constexpr int kRes128 = 1;", "constexpr int kRes128 = 0;")],
    "two_warpgroups": [
        ("render.cu", "static constexpr int NWG = W == 128 ? 2 : 4;",
         "static constexpr int NWG = W >= 64 ? 2 : 4;")],
    "no_lo_w2": [
        ("render.cu", "        make_lo_chunk<W>(", "        if (false) make_lo_chunk<W>("),
        ("render.cu", "        return smem_desc(sbase + T::OFF_RING + (kSlots * wg + c % kSlots) * "
         "T::SLOT + e * 256,\n                         128, 128 * kKG);",
         "        return smem_desc(sbase + L * T::MAT + (kCK * c + e) * 256, 128, T::SBO);")],
    "no_sine": [
        ("render.cu", "            const float y = sine_fast(x);", "            const float y = x;")],
    "head_one_pass": [
        ("render.cu", "  for (int c = 0; c < KS / kCK; ++c) {",
         "  for (int c = 0; c < (N == 8 ? 0 : KS / kCK); ++c) {")],
}


def write_variant(name: str, csrc: Path) -> Path:
    """The variant's sources in OUT_DIR / name; raises if an edit's old
    text is not in its file once."""
    out = OUT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    files = {"render.cu": (csrc / "render.cu").read_text()}
    for fname, old, new in VARIANTS[name]:
        text = files.get(fname) or (csrc / fname).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in {fname} once")
        files[fname] = text.replace(old, new)
    for fname, text in files.items():
        (out / fname).write_text(text)
    return out


def build(names) -> dict:
    """One nvcc per variant, all at once: {name: (library, ptxas lines of
    render_f32_kernel)}; raises with nvcc's output on a failed build."""
    from spnerf_tpu_torch.kernels import _build

    procs = {}
    for name in names:
        out = write_variant(name, _build.CSRC)
        cmd = _build._nvcc_cmd("render", out / "librender.so")
        cmd[-1] = str(out / "render.cu")
        cmd[cmd.index("-I") + 1:cmd.index("-I") + 1] = [str(out), "-I"]
        procs[name] = (out / "librender.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    built = {}
    for name, (lib, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{reports[name]}")
        lines = reports[name].splitlines()
        ptxas = [f"{line.split('render_f32_kernel')[1][:12]}: {lines[i + 1].strip()}; "
                 f"{lines[i + 2].strip()}"
                 for i, line in enumerate(lines)
                 if "Compiling entry" in line and "render_f32_kernel" in line]
        built[name] = (lib, ptxas)
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--widths", default="128,64,32")
    parser.add_argument("--dense", action="store_true",
                        help="early stop off (the same work for every variant)")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--out", help="write the results here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("render_variants: no CUDA device", file=sys.stderr)
        return 1
    from spnerf_tpu_torch.kernels import _build
    from spnerf_tpu_torch.kernels import render as R
    from spnerf_tpu_torch.tools.kernel_times import device_ms, render_drive

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in args.variants.split(",") if n]
    built = build(names)
    for name in names:
        for line in built[name][1]:
            print(f"{name} {line}", flush=True)
    fields = render_drive()[2]
    results = {}
    for width in (int(w) for w in args.widths.split(",")):
        f = fields[width]
        ws = [w.float() for w in f.ws]
        kw = dict(f.kw, early_stop_eps=0.0) if args.dense else dict(f.kw)
        if width == 128:
            fn, plain = R.render_fused, R.render_fused_plain
        else:
            fn, plain = R.render_fused_packed, R.render_fused_packed_plain
            kw["width"] = width
        want = plain(f.oe, f.de, *ws, f.df, **kw)
        for rnd, name in enumerate(names + names[::-1]):
            _build._libs["render"] = ctypes.CDLL(str(built[name][0].resolve()))
            _build._fns.pop(("render", "render_f32_launch"), None)
            got = fn(f.oe, f.de, *ws, f.df, **kw)
            err = (float((got[0] - want[0]).abs().max()),
                   float((got[1] - want[1]).abs().max()))
            ms, how = device_ms(lambda: fn(f.oe, f.de, *ws, f.df, **kw),
                                "render_f32_kernel")
            results.setdefault(f"w{width} {name}", []).append(ms)
            print(f"w{width} {name:15s} round {rnd}: {ms:.4f} ms ({how}), "
                  f"max_abs_err rgb {err[0]:.3e} depth {err[1]:.3e}", flush=True)
    _build._libs.pop("render", None)
    _build._fns.pop(("render", "render_f32_launch"), None)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "dense": args.dense, "device_ms": results}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
