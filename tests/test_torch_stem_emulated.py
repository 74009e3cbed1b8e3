"""The CUDA stem kernel's own source (``csrc/stem.cu``) run on the CPU: g++
compiles it against a stand-in for the CUDA runtime (``tests/cuda_emu``)
that runs one thread per CUDA thread and emulates ``ldmatrix`` and
``mma.sync`` lane by lane, so the kernel's index math (line buffers, strips,
bands, layouts, padding) is held against ``stem_reference`` without a card.
The inline-PTX helpers and the fast-math intrinsics of the SiLU are swapped
for the emulation. Same bounds as the card tests: 0.02 * max|ref| and a uniform
per-row error.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_emu.emulate import CSRC, build, emulated
from fce_yolo_tpu_torch.ops import stem as S

# (H, W, c0, c1, c2, ch, n, c3k, batch): the small forms of the card tests,
# widths that are no multiple of a strip, an image shorter than one step,
# B = 3, and the s and m channel counts (line buffers, resident or global
# weights) at a small size
CASES = [
    (64, 64, 16, 32, 64, 16, 1, False, 1),
    (64, 64, 16, 32, 64, 16, 1, True, 1),
    (128, 192, 16, 32, 64, 16, 2, False, 1),
    (128, 128, 16, 32, 64, 16, 2, True, 1),
    (64, 200, 16, 32, 64, 16, 1, False, 3),
    (4, 96, 16, 32, 64, 16, 1, False, 3),
    (96, 128, 32, 64, 128, 32, 1, False, 2),
    (64, 96, 64, 128, 256, 64, 1, True, 1),
]


def _emulated_source() -> str:
    src = emulated((CSRC / "stem.cu").read_text(), {
        "ldsm_x4": "uint32_t r[4]; emu_ldmatrix(addr, 4, r); r0 = r[0]; r1 = r[1]; r2 = r[2]; r3 = r[3];",
        "ldsm_x2": "uint32_t r[2]; emu_ldmatrix(addr, 2, r); r0 = r[0]; r1 = r[1];",
        "mma_bf16": "emu_mma(c, a, b0, b1);",
        "cp_async4": "std::memcpy(g_smem + dst, src, 4);",
        "cp_async16": "std::memcpy(g_smem + dst, src, 16);",
        "silu": "return v / (1.0f + std::exp(-v));",
    })
    src = re.sub(r"stem_kernel<<<.*?>>>\(a\);", "emu_launch(grid, bytes, a);", src)
    entry = 'extern "C" int fce_fused_stem'
    return src.replace(entry, "void emu_launch(int, int, const StemArgs&);\n" + entry)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return build(tmp_path_factory.mktemp("stem_emu"), "stem_main.cpp", "stem", _emulated_source())


def _run(exe: Path, spec: S.StemSpec, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    folded = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(torch.bfloat16)
              for s in S.folded_shapes(spec)]
    x = torch.from_numpy(rng.randint(0, 256, (batch, spec.H, spec.W, 3)).astype(np.uint8))
    weights = S.stem_weights(folded, spec)
    d = exe.parent
    x.numpy().tofile(d / "x.bin")
    weights.packed.view(torch.int16).numpy().tofile(d / "w.bin")
    args = [batch, spec.H, spec.W, spec.c0, spec.c1, spec.c2, spec.ch, spec.n, int(spec.c3k), 4]
    res = subprocess.run([str(exe), *map(str, args), str(d / "x.bin"), str(d / "w.bin"), str(d / "out.bin")],
                         capture_output=True, text=True, timeout=600)
    return res, x, weights


@pytest.mark.parametrize("H,W,c0,c1,c2,ch,n,c3k,batch", CASES)
def test_emulated_kernel_matches_reference(emulator, H, W, c0, c1, c2, ch, n, c3k, batch):
    spec = S.StemSpec(H=H, W=W, c0=c0, c1=c1, c2=c2, ch=ch, n=n, c3k=c3k)
    res, x, weights = _run(emulator, spec, batch)
    assert res.returncode == 0, res.stderr[-3000:]
    out = torch.from_numpy(np.fromfile(emulator.parent / "out.bin", np.int16)).view(torch.bfloat16)
    out = out.float().reshape(batch, spec.h4, spec.w4, spec.c2).numpy()
    ref = S.stem_reference(x, weights.arrays, spec).numpy()
    assert np.isfinite(out).all()
    d = np.abs(out - ref)
    scale = np.abs(ref).max()
    assert d.max() / scale < 0.02
    per_row = d.max(axis=(0, 2, 3)) / scale
    assert per_row.max() < 3 * max(np.median(per_row), 1e-6)


def test_emulated_kernel_refuses_the_l_form(emulator):
    """Two C3k repeats (halo 8) fit no line-buffer layout: the entry point
    returns an error before any launch."""
    spec = S.StemSpec(H=64, W=64, c0=64, c1=128, c2=256, ch=64, n=2, c3k=True)
    res, _, _ = _run(emulator, spec, 1)
    assert res.returncode == 3 and "plan" not in res.stderr
