"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``fce_yolo_tpu_torch/csrc/<name>.cu`` compiles into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds); the nvcc processes of all sources start together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

``<hash>`` covers the sources and the flags, so an edited kernel rebuilds
and an unchanged one loads at once. The build runs at first use, inside the
checkout (``build/`` is git-ignored). Every C entry point takes its pointers
and the CUDA stream as ``void*`` and returns ``cudaGetLastError()`` (the
JPEG ones also a negative code for a file they refuse); the Python wrappers
raise on a non-zero code.
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
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of each entry point (all return cudaError_t as int)
SIGNATURES = {
    # x_u8, weights (packed bf16), out, B, H, W, c0, c1, c2, ch, n, c3k, stream
    "fce_fused_stem": [_P, _P, _P] + [_I] * 9 + [_P],
    # boxes, scores, valid, idx, ok, sboxes, order, count, mask, B, K, max_det, iou_thres, stream
    "fce_pick_suppress": [_P] * 9 + [_I, _I, _I, _F, _P],
    # JPEG (csrc/jpeg.cu); the int32 info record's layout: data/jpeg.py INFO_LEN
    # buf, len, coef (host int16), its capacity, qt (host int32 3 x 64), info
    "fce_jpeg_coefficients": [_P, _L, _P, _L, _P, _P],
    # coef (device), qt (host), planes (device), info, stream
    "fce_jpeg_idct": [_P] * 5,
    # planes (device), out (device), info, stream
    "fce_jpeg_color": [_P] * 4,
    # buf, len, info, h_coef (pinned), d_coef, d_plane, their capacity, d_out, h_out (pinned), its capacity,
    # times (host float[5] or null), stream
    "fce_jpeg_decode": [_P, _L, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P],
    # img (device), coef (device), H, W, components, quality, stream
    "fce_jpeg_fdct": [_P, _P, _I, _I, _I, _I, _P],
    # coef (host), H, W, components, quality, out (host), its capacity, size (host int64)
    "fce_jpeg_entropy": [_P, _I, _I, _I, _I, _P, _L, _P],
    # mask (host uint8), H, W, row stride, points (host int32 pairs), their capacity, counts (host int32), their
    # capacity, sizes (host int64 [2]); host code only (csrc/contours.cu)
    "fce_find_contours": [_P, _I, _I, _L, _P, _L, _P, _L, _P],
    # compression (5 LZW, 32773 PackBits), src (host), its length, dst (host), the bytes to decode; host code
    # only (csrc/imgcodecs.cu)
    "fce_tiff_decode": [_I, _P, _L, _P, _L],
    # src (host), its length, dst (host), its room, info (host int64 [2]: size, error offset), message, its
    # length; host code only (csrc/zstd.cu)
    "fce_zstd_decompress": [_P, _L, _P, _L, _P, ctypes.c_char_p, _I],
    # WebP (csrc/webp.cu); the int32 info record's layout: data/webp.py INFO_LEN
    # buf, len, info, planes (host), their room; host code only
    "fce_webp_planes": [_P, _L, _P, _P, _L],
    # planes (device Y, U, V), out (device BGR), w, h, out row width, x0, y0, stream
    "fce_webp_color": [_P, _P] + [_I] * 5 + [_P],
    # buf, len, info, h_planes (pinned), d_planes, their room, d_out, h_out (pinned), its room,
    # times (host float[4] or null), stream
    "fce_webp_decode": [_P, _L, _P, _P, _P, _L, _P, _P, _L, _P, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_paths() -> dict[Path, Path]:
    """Each source and the library it builds into."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return {src: BUILD_ROOT / h.hexdigest()[:16] / f"lib{src.stem}.so" for src in sources}


def build() -> tuple[list[Path], float, str]:
    """Compile the libraries not built yet, one nvcc per source, all at
    once. Returns (paths, seconds spent compiling, nvcc's report: registers
    and shared memory per kernel)."""
    paths = library_paths()
    todo = {src: lib for src, lib in paths.items() if not lib.exists()}
    if not todo:
        return list(paths.values()), 0.0, ""
    t0 = time.perf_counter()
    jobs = []
    for src, lib in todo.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(src, lib, tmp, proc.communicate()[1], proc.returncode) for src, lib, tmp, proc in jobs]
    for src, _, _, err, rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({rc}):\n{err[-4000:]}")
    for _, lib, tmp, _, _ in done:
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return list(paths.values()), time.perf_counter() - t0, "".join(err for _, _, _, err, _ in done)


@functools.lru_cache(maxsize=1)
def library() -> SimpleNamespace:
    """The typed entry points of the kernel libraries (built on first call)."""
    paths, _, _ = build()
    libs = [ctypes.CDLL(str(path)) for path in paths]
    entry = {}
    for name, argtypes in SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entry[name] = fn
    return SimpleNamespace(**entry)


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
