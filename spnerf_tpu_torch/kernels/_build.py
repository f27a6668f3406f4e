"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` becomes ``build/spnerf_tpu_torch/lib<name>.so``
(git-ignored) at first use, compiled for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -I csrc -o build/spnerf_tpu_torch/lib<name>.so \
         csrc/<name>.cu

No ``--use_fast_math``: the int8 epilogues rely on IEEE rounding. The
sources expose plain C launch functions that take raw pointers and the
CUDA stream and return a ``cudaError_t``; ``launch`` raises on a non-zero
code. ``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spnerf_tpu_torch"
SOURCES = ("conv12_fused", "double_conv3x3", "head", "conv3x3",
           "dot_bias_act", "warp", "descriptor_loss", "render", "desc_sample")

# launches per kernel, counted by the wrappers where they launch
launch_counts: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("spnerf_tpu_torch: nvcc not found (needs the CUDA "
                           "toolkit to build the kernels)")
    return nvcc


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _nvcc_cmd(name: str, out: Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict:
    """Compile every stale source in parallel; returns {name: ptxas
    report} for the ones built. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            procs[name] = (tmp, subprocess.Popen(
                _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    # wait for every nvcc before raising, so that none is left running
    reports = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{reports[name]}")
        os.replace(tmp, _lib_path(name))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def launch(lib_name: str, fn_name: str, *args) -> None:
    """Call C launch function ``fn_name`` on the current stream: tensors
    pass as device pointers (None as a null pointer), Python floats as C
    floats, anything else as a C int. Raises on a CUDA error."""
    fn = getattr(load(lib_name), fn_name)
    argtypes, values = [], []
    for a in args:
        if a is None or isinstance(a, torch.Tensor):
            argtypes.append(ctypes.c_void_p)
            values.append(None if a is None else a.data_ptr())
        elif isinstance(a, float):
            argtypes.append(ctypes.c_float)
            values.append(a)
        else:
            argtypes.append(ctypes.c_int)
            values.append(int(a))
    argtypes.append(ctypes.c_void_p)
    values.append(torch.cuda.current_stream().cuda_stream)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*values)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")


def pack_words(w: torch.Tensor, cout_pad: int | None = None,
               cin_pad: int | None = None) -> torch.Tensor:
    """int8, bf16 or float32 (..., cin, cout) weights -> int32 words
    (taps, cin/per_word, cout_pad): each word holds per_word = 4, 2 or 1
    consecutive input channels of one output channel, the operand layout
    of the kernels' dot (``__dp4a`` for int8). Input and output channels
    are zero-padded to ``cin_pad`` and ``cout_pad``."""
    cin, cout = w.shape[-2:]
    per = 4 // w.element_size()
    w = w.reshape(-1, cin, cout)
    pad_in = (cin_pad or cin) - cin
    pad_out = (cout_pad or cout) - cout
    if pad_in > 0 or pad_out > 0:
        w = torch.nn.functional.pad(w, (0, max(pad_out, 0), 0, max(pad_in, 0)))
    taps, cinp, coutp = w.shape
    w = w.reshape(taps, cinp // per, per, coutp).permute(0, 1, 3, 2)
    return w.contiguous().view(torch.int32)[..., 0]


def pack_slabs(w: torch.Tensor) -> torch.Tensor:
    """bf16 (3, 3, cin, cout) weights -> the tensor-core layout of
    ``csrc/conv_tc.cuh``: (9, cout/8, cin/8, 8, 8), one tap's slab of
    cin x cout after another, each K-major in 8 x 8 core matrices of 128
    contiguous bytes. Element (tap, n, k) lies at
    ``((n // 8) * (cin // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8`` of its
    slab: the wgmma descriptor's leading byte offset (K) is 128, its
    stride byte offset (N) cin * 16. cin and cout must be multiples of
    8."""
    cin, cout = w.shape[-2:]
    if w.dtype != torch.bfloat16 or cin % 8 or cout % 8:
        raise ValueError(f"pack_slabs: bf16 weights with C_in and C_out "
                         f"multiples of 8, not {tuple(w.shape)} {w.dtype}")
    w = w.reshape(-1, cin // 8, 8, cout // 8, 8)  # [tap][kb][k][nb][n]
    return w.permute(0, 3, 1, 4, 2).contiguous()  # [tap][nb][kb][n][k]


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on a 16-byte
    boundary (the kernels read 16-byte vectors)."""
    for key, t in tensors.items():
        if not (t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: {key} must be a contiguous CUDA "
                             "tensor aligned to 16 bytes")

