"""Build a CUDA kernel source of the port for the CPU stand-in in this
directory: rewrite the parts g++ cannot take (inline PTX, dynamic shared
memory, launches) and compile it with its driver and ``runtime.cpp``.
Used by ``tests/test_torch_*_emulated.py``."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

EMU = Path(__file__).resolve().parent
CSRC = EMU.parent.parent / "fce_yolo_tpu_torch" / "csrc"
SHARED_DECL = "extern __shared__ __align__(16) unsigned char smem[];"


def swap_body(src: str, name: str, new: str) -> str:
    """Replace the body of the ``__device__ __forceinline__`` helper ``name``."""
    m = re.search(r"__device__ __forceinline__ \w+ " + name + r"\([^)]*\)[^{]*\{", src)
    assert m, f"no helper {name}"
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    return src[:m.end()] + new + "\n}" + src[i:]


def emulated(src: str, helpers: dict[str, str]) -> str:
    """``src`` with the helpers' bodies swapped, inline asm dropped and the
    dynamic shared memory pointed at the stand-in's."""
    for name, body in helpers.items():
        src = swap_body(src, name, body)
    src = src.replace("asm volatile(", "EMU_ASM(")
    return src.replace(SHARED_DECL, "unsigned char* smem = g_smem;")


def build(tmp: Path, driver: str, name: str, src: str) -> Path:
    """Write ``src`` as ``<name>_emu.cu`` and compile it with ``driver``;
    skips without g++. Returns the executable."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    assert "asm(" not in src and "<<<" not in src
    (tmp / f"{name}_emu.cu").write_text(src)
    exe = tmp / name
    res = subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread", "-w", f"-I{EMU}", f"-I{tmp}",
                          "-o", str(exe), str(EMU / driver), str(EMU / "runtime.cpp")],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return exe
