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
_fns: dict = {}  # (library, function) -> ctypes function with its argtypes
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


def _current_stream() -> int:
    """The current CUDA stream's handle (the raw query where this
    PyTorch has it: the public one builds a Stream object per call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


def launch(lib_name: str, fn_name: str, *args) -> None:
    """Call C launch function ``fn_name`` on the current stream: tensors
    pass as device pointers (None as a null pointer), Python floats as C
    floats, anything else as a C int. Raises on a CUDA error.

    The C function and its ``argtypes`` (from the first call's arguments)
    are kept per (library, function), so that a call only converts its
    values."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = [ctypes.c_void_p if a is None or isinstance(a, torch.Tensor)
                       else ctypes.c_float if isinstance(a, float)
                       else ctypes.c_int for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    values = [a.data_ptr() if isinstance(a, torch.Tensor)
              else a if a is None or isinstance(a, float) else int(a)
              for a in args]
    err = fn(*values, _current_stream())
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
    8. Any leading shape packs as slabs; f16 weights pack as bf16 do,
    int8 weights the same way with core matrices of 8 x 16 values (e = 16
    bytes of K: element at ``((n // 8) * (cin // e) + k // e) * 8 e +
    (n % 8) * e + k % e``)."""
    cin, cout = w.shape[-2:]
    e = 16 // w.element_size()
    if w.dtype not in (torch.bfloat16, torch.float16, torch.int8) \
            or cin % e or cout % 8:
        raise ValueError(f"pack_slabs: bf16, f16 or int8 weights with C_in "
                         f"and C_out multiples of 8 (C_in of 16 for int8), "
                         f"not {tuple(w.shape)} {w.dtype}")
    w = w.reshape(-1, cin // e, e, cout // 8, 8)  # [tap][kb][k][nb][n]
    return w.permute(0, 3, 1, 4, 2).contiguous()  # [tap][nb][kb][n][k]


def pack_head_1x1(w: torch.Tensor, coutp: int) -> torch.Tensor:
    """bf16 or int8 (256, cout) 1x1 weights of a head -> the ring slabs of
    ``csrc/head.cu``'s tensor-core instances: zero-padded to ``coutp``
    output channels (bf16: 72 or 256; int8: 80 or 256) and cut into ``kc``
    K-chunks (1 at 72 or 80, 2 at 256), each a ``pack_slabs`` slab of
    (256 / kc) x coutp. With e = 16 bytes of K (8 bf16 or 16 int8 values)
    element (k, n) lies at ``((n // 8) * (K // e) + (k % K) // e) * 8 e +
    (n % 8) * e + k % e`` of slab ``k // K``, K = 256 / kc."""
    cin, cout = w.shape
    widths = {torch.bfloat16: (72, 256), torch.int8: (80, 256)}
    if w.dtype not in widths or cin != 256 or coutp not in widths[w.dtype] \
            or cout > coutp:
        raise ValueError(f"pack_head_1x1: bf16 or int8 (256, <= {coutp}) "
                         f"weights, not {tuple(w.shape)} {w.dtype}")
    kc = 2 if coutp == 256 else 1
    w = torch.nn.functional.pad(w, (0, coutp - cout))
    return pack_slabs(w.reshape(kc, cin // kc, coutp))


def pack_rows(w: torch.Tensor, cout_pad: int) -> torch.Tensor:
    """(cin, cout) weights of any dtype -> (cout_pad, cin): one row of
    cin contiguous values per output channel, rows past cout zero. The
    B operand layout of ``csrc/dot_bias_act.cu``'s N 72 instances
    (``ldmatrix`` reads 8 rows x 16 bytes, an n8 x k16 or k32
    fragment)."""
    cin, cout = w.shape
    return torch.nn.functional.pad(w.t(), (0, 0, 0, cout_pad - cout)).contiguous()


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on a 16-byte
    boundary (the kernels read 16-byte vectors)."""
    for key, t in tensors.items():
        if not (t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: {key} must be a contiguous CUDA "
                             "tensor aligned to 16 bytes")

