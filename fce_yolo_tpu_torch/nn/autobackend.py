"""AutoBackend: inference over exported artifacts (reference
``fce_yolo_tpu/nn/autobackend.py``), so that ``YOLO(path).predict/val``
and ``benchmark`` work on what ``YOLO.export`` writes:

  suffix   runtime
  -------  ----------------------------------------------------------------
  .pt2     ``torch.export.load``, moved to the session's device (the card
           unless the caller names the CPU); NMS inside it runs as the custom
           op ``fce_yolo_tpu_torch::pick_suppress``, the kernel on the card
  .fyir    the repo's C++ interpreter ``native/infer/fy_infer.cpp`` in raw
           mode, built with g++ on first use into ``build/native/<hash>/``

``self(images)`` takes (B, H, W, 3) images, uint8 or float32 in [0, 255] or
[0, 1], as numpy arrays or tensors, and returns tensors on the backend's
device: the raw preds (B, A, 4 + nc ...), or the ``boxes``/``scores``/
``classes``/``valid`` dict when NMS is inside the artifact (a program keeps
its outputs' names, so the JAX backend's ``_pack``, which names a
TensorFlow model's outputs by rank, has nothing to do here). A program has
a static batch: other batch sizes go through in chunks, the last one
padded with its last image and the padding cut off.

The ``.fyir`` graph takes [0, 1] pixels (the JAX exporter traces it so, and
``fy_infer``'s letterbox makes them), so a uint8 batch is divided by 255
here. The JAX backend writes 0-255 values to it (ROADMAP queue 3, item 31).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["AutoBackend", "is_exported_artifact", "fy_infer_binary"]

ROOT = Path(__file__).resolve().parents[2]
FY_INFER_SRC = ROOT / "native" / "infer" / "fy_infer.cpp"
FY_INFER_FLAGS = ["-O2", "-std=c++17"]


def is_exported_artifact(path) -> bool:
    """Whether ``path`` names an artifact the port reads (``.pt2``, ``.fyir``)."""
    return isinstance(path, (str, Path)) and Path(path).suffix in (".pt2", ".fyir")


def fy_infer_binary() -> Path:
    """The interpreter built from the checkout's source with g++, at
    ``build/native/<hash of source and flags>/fy_infer``; built once (a
    temporary name renamed into place, so concurrent builds do not collide)."""
    src = FY_INFER_SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(FY_INFER_FLAGS).encode()).hexdigest()[:16]
    exe = ROOT / "build" / "native" / key / "fy_infer"
    if exe.exists():
        return exe
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the native runtime needs g++ to build native/infer/fy_infer.cpp")
    exe.parent.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"fy_infer.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *FY_INFER_FLAGS, "-o", str(tmp), str(FY_INFER_SRC)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {FY_INFER_SRC}:\n{res.stderr[-3000:]}")
    os.replace(tmp, exe)
    return exe


def _fyir_header(path: Path) -> dict[str, Any]:
    """The ``meta`` key=values, the input shape and each output's shape of a ``.fyir``."""
    meta: dict[str, Any] = {}
    shapes: dict[int, tuple[int, ...]] = {}
    outputs: list[int] = []
    for line in path.read_text().splitlines():
        kind, _, rest = line.partition(" ")
        parts = rest.split()
        if kind == "meta":
            meta.update(p.split("=", 1) for p in parts if "=" in p)
        elif kind == "input":
            meta["input_shape"] = tuple(int(d) for d in parts[2].split(","))
        elif kind == "shape":
            shapes[int(parts[0])] = tuple(int(d) for d in parts[2].split(",")) if int(parts[1]) else ()
        elif kind == "output":
            outputs.append(int(parts[0]))
    meta["output_shapes"] = [shapes[o] for o in outputs]
    return meta


class AutoBackend:
    """Load an exported artifact and its metadata; callable on image batches."""

    def __init__(self, path: str | Path, device: torch.device | str = "cuda"):
        p = Path(path)
        self.path = str(p)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the artifact on the CPU")
        if p.suffix == ".pt2":
            self.fmt = "torch_export"
            self._meta_from(p.with_suffix(".json"))
            self._init_torch_export(p)
        elif p.suffix == ".fyir":
            self.fmt = "fyir"
            self._meta_from(p.with_suffix(".json"), optional=True)
            self._init_fyir(p)
        else:
            raise ValueError(f"not an exported artifact: {path}")

    # ------------------------------------------------------------- metadata
    def _meta_from(self, path: Path, optional: bool = False) -> None:
        meta: dict[str, Any] = {}
        if path.exists():
            meta = json.loads(path.read_text())
        elif not optional:
            raise FileNotFoundError(f"metadata sidecar missing: {path}")
        self.meta = meta
        self.nc = int(meta.get("nc", 80))
        self.names = {int(k): v for k, v in (meta.get("names") or {}).items()} or {
            i: f"class_{i}" for i in range(self.nc)}
        self.imgsz = int(meta.get("imgsz", 640))
        self.batch = int(meta.get("batch", 1))
        self.strides = tuple(meta.get("strides", (8, 16, 32)))
        self.nms_baked = bool(meta.get("nms", False))

    # ------------------------------------------------------------- backends
    def _init_torch_export(self, p: Path) -> None:
        import fce_yolo_tpu_torch.ops.nms  # noqa: F401  registers fce_yolo_tpu_torch::pick_suppress
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(torch.export.load(str(p)), self.device).module()

        def run(x: torch.Tensor):
            with torch.no_grad():
                return program(x)

        self._run = run

    def _init_fyir(self, p: Path) -> None:
        header = _fyir_header(p)
        if "nc" in header and "nc" not in self.meta:  # no sidecar: the class count from the graph
            self.nc = int(header["nc"])
            self.names = {i: f"class_{i}" for i in range(self.nc)}
        self.meta = {**header, **self.meta}
        _, size, _, _ = header["input_shape"]
        self.imgsz, self.batch = int(size), 1
        binary = fy_infer_binary()
        weights = p.with_suffix(".fybin")
        out_shape = header["output_shapes"][0]

        def run(x: torch.Tensor) -> torch.Tensor:
            outs = []
            with tempfile.TemporaryDirectory() as td:
                for i, img in enumerate(x.cpu().numpy()):
                    fin, fout = Path(td) / f"in{i}.bin", Path(td) / f"out{i}.bin"
                    fin.write_bytes(np.ascontiguousarray(img, np.float32).tobytes())
                    subprocess.run([str(binary), str(p), str(weights), "--raw", str(fin), str(fout)], check=True,
                                   capture_output=True)
                    outs.append(np.fromfile(fout, np.float32).reshape(out_shape))
            return torch.from_numpy(np.concatenate(outs, 0)).to(self.device)

        self._run = run

    # ----------------------------------------------------------------- call
    def __call__(self, images):
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(images))
        u8 = x.dtype == torch.uint8
        x = x.to(self.device, torch.float32)
        if self.fmt == "fyir" and u8:
            x = x / 255.0  # the graph takes [0, 1] pixels
        b, eb = x.shape[0], self.batch
        if b == eb:
            return self._run(x)
        outs = []
        for i in range(0, b, eb):  # a static batch: chunk, pad the last chunk, trim
            chunk = x[i: i + eb]
            if chunk.shape[0] < eb:
                chunk = torch.cat([chunk, chunk[-1:].expand(eb - chunk.shape[0], *chunk.shape[1:])])
            outs.append(self._run(chunk))
        if isinstance(outs[0], dict):
            return {k: torch.cat([o[k] for o in outs], 0)[:b] for k in outs[0]}
        return torch.cat(outs, 0)[:b]

    def warmup(self) -> "AutoBackend":
        """One call on zeros (reference ``AutoBackend.warmup``)."""
        self(np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.float32))
        return self
