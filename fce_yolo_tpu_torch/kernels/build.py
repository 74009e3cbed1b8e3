"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All ``fce_yolo_tpu_torch/csrc/*.cu`` files compile into ONE shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/libfce_kernels.so csrc/*.cu

``<hash>`` covers the sources and the flags, so an edited kernel rebuilds
and an unchanged one loads at once. The build runs at first use, inside the
checkout (``build/`` is git-ignored). Every C entry point takes its pointers
and the CUDA stream as ``void*`` and returns ``cudaGetLastError()``; the
Python wrappers raise on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point (all return cudaError_t as int)
SIGNATURES = {
    # x_u8, weights (packed bf16), out, B, H, W, c0, c1, c2, ch, n, c3k, stream
    "fce_fused_stem": [_P, _P, _P] + [_I] * 9 + [_P],
    # boxes, scores, valid, idx, ok, B, K, max_det, iou_thres, stream
    "fce_pick_suppress": [_P] * 5 + [_I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfce_kernels.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet. Returns (path, seconds
    spent compiling, nvcc's report: registers and shared memory per kernel)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, time.perf_counter() - t0, res.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with typed entry points."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
