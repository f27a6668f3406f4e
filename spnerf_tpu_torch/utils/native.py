"""Host libraries of the port built from its own C++ sources at first use.

``load("name")`` builds ``spnerf_tpu_torch/native/<name>.cpp`` with g++
into the git-ignored ``build/spnerf_tpu_torch/native/lib<name>.so`` (again
whenever the source is newer) and returns it loaded by ctypes. A failed
build raises with the compiler's output: there is no slower fallback to
hide it. No library contracts a product and a sum into one fused
multiply-add unless its source calls ``fmaf`` (``-ffp-contract=off``), so
float sums keep the order the source states, as the copies of cv2's
arithmetic need; ``-mfma``, where the CPU has FMA, makes such a call one
instruction.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" / "spnerf_tpu_torch"
             / "native")
_lock = threading.Lock()
_libs: dict = {}


def float_flags() -> list:
    """g++ flags of every library: contraction off, FMA where the CPU
    has it."""
    flags = ["-ffp-contract=off"]
    try:
        cpu = Path("/proc/cpuinfo").read_text()
    except OSError:
        cpu = ""
    if " fma " in cpu.replace("\n", " "):
        flags.append("-mfma")
    return flags


def build(source: Path, target: Path) -> None:
    """g++ ``source`` into the shared library ``target``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found; it builds {source} at first use")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", *float_flags(),
         "-o", str(tmp), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    tmp.replace(target)  # atomic: a concurrent loader never sees half


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built if missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            source = SOURCE_DIR / f"{name}.cpp"
            target = BUILD_DIR / f"lib{name}.so"
            if (not target.exists()
                    or target.stat().st_mtime < source.stat().st_mtime):
                build(source, target)
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib
