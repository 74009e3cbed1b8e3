"""Inference benchmarking (reference ``fce_yolo_tpu/utils/benchmarks.py:17-370``).

``profile_inference`` times the port's predictor path (uint8 batch -> stem
kernel where the gate allows -> model -> NMS kernel) of a bfloat16 copy of
the model; ``benchmark`` gives the ``torch (native)`` row, with mAP50-95
from ``YOLO.val`` when ``data`` is given, then a row per JAX export format:
``stablehlo``'s is the port's counterpart, ``torch_export``, exported,
loaded through ``AutoBackend`` and timed by ``_bench_backend``;
``saved_model`` and ``tflite`` need TensorFlow and are ``FAILED`` rows.
``ProfileModels`` times each model's forward, or an artifact's backend.
The reference's ``RF100Benchmark`` is not ported (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fce_yolo_tpu_torch.utils.autobatch import _tensors

__all__ = ["benchmark", "profile_inference", "ProfileModels", "EXPORT_FORMATS"]

EXPORT_FORMATS = ("stablehlo", "saved_model", "tflite")  # the JAX table's rows
PORT_FORMAT = {"stablehlo": "torch_export"}  # a JAX format -> the port's counterpart, where there is one


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bf16_predictor(yolo, imgsz: int, batch: int, bf16: bool):
    """A ``DetectionPredictor`` over a folded copy of the facade's model, in
    bfloat16 when ``bf16`` (so the stem kernel runs where its gate allows);
    the facade's own model is left as it is."""
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor

    model = copy.deepcopy(yolo._inference_model())
    if bf16:
        model.to(torch.bfloat16)
    return DetectionPredictor(model, yolo.names, imgsz=imgsz, conf=0.25, iou=0.7, max_det=300, batch_size=batch)


def profile_inference(
    yolo, imgsz: int = 640, batch: int = 16, iters: int = 20, warmup: int = 3, bf16: bool = True
) -> dict[str, float]:
    """Images/sec through the predictor path on the model's device (the
    reference's warmup, iterations, the four random uint8 batches from
    ``RandomState(0)`` and returned keys). The time of one round trip to the
    device (a scalar op read back) is taken off, as in the reference."""
    device = yolo.device
    pred = _bf16_predictor(yolo, imgsz, batch, bf16)

    def predict(img_u8: torch.Tensor) -> torch.Tensor:
        out = pred.infer(img_u8)
        return out["boxes"].sum() + out["scores"].sum()  # a scalar, read back at the end

    def tiny() -> float:
        return float(torch.zeros((), device=device) + 1.0)

    tiny()
    t0 = time.perf_counter()
    for _ in range(10):
        tiny()
    rt = (time.perf_counter() - t0) / 10

    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randint(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)).to(device)
            for _ in range(4)]
    for i in range(warmup):
        _ = float(predict(imgs[i % 4]))
    _sync(device)
    t0 = time.perf_counter()
    outs = [predict(imgs[i % 4]) for i in range(iters)]
    _ = float(sum(outs))
    dt = max(time.perf_counter() - t0 - rt, 1e-9) / iters
    return {
        "images_per_sec": batch / dt,
        "ms_per_image": dt / batch * 1000,
        "ms_per_batch": dt * 1000,
        "batch": batch,
        "imgsz": imgsz,
    }


def _bench_backend(backend, imgsz: int, iters: int = 8, warmup: int = 2) -> float:
    """ms an image through an ``AutoBackend`` (reference ``_bench_backend``):
    a batch of the backend's size of uint8-range float32 images, warmed up,
    then ``iters`` calls, each read back to the host."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (backend.batch, imgsz, imgsz, 3)).astype(np.float32)

    def call():
        out = backend(x)
        return [t.cpu() for t in (out.values() if isinstance(out, dict) else [out])]

    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters / backend.batch * 1000


def benchmark(
    yolo,
    data: str | None = None,
    imgsz: int = 640,
    batch: int = 16,
    formats: tuple[str, ...] | None = None,
    export_dir: str | Path | None = None,
    verbose: bool = True,
) -> list[dict[str, Any]]:
    """The reference's benchmark table (``utils/benchmarks.py:88``): the
    native row first (``profile_inference``, and mAP50-95 of ``YOLO.val``
    on ``data`` when given), then one row per export format: the artifact
    written to ``export_dir`` (a temporary directory by default), read back
    by ``YOLO(path)`` on the model's device, timed by ``_bench_backend``
    and validated on ``data``; a format that fails gets a ``FAILED`` row.
    ``stablehlo`` runs as the port's ``torch_export``; ``saved_model`` and
    ``tflite`` raise (TensorFlow). ``yolo`` is a facade or a model name
    (built on the card). Returns the rows as dicts."""
    import tempfile

    from fce_yolo_tpu_torch.api import YOLO

    if isinstance(yolo, (str, Path)):
        yolo = YOLO(yolo)
    rows = []
    prof = profile_inference(yolo, imgsz=imgsz, batch=batch)
    row = {
        "format": "torch (native)",
        "status": "OK",
        "imgsz": imgsz,
        "batch": batch,
        "ms/img": round(prof["ms_per_image"], 2),
        "images/sec": round(prof["images_per_sec"], 1),
        "mAP50-95": None,
    }
    if data:
        res = yolo.val(data=data, imgsz=imgsz, batch=batch, verbose=False)
        row["mAP50-95"] = round(res["metrics/mAP50-95(B)"], 4)
    rows.append(row)

    tmp = tempfile.mkdtemp(prefix="fy_bench_") if export_dir is None else export_dir
    for fmt in formats if formats is not None else EXPORT_FORMATS:
        row = {"format": PORT_FORMAT.get(fmt, fmt), "status": "OK", "imgsz": imgsz, "batch": 1,
               "ms/img": None, "images/sec": None, "mAP50-95": None}
        try:
            path = yolo.export(format=PORT_FORMAT.get(fmt, fmt), imgsz=imgsz, out_dir=tmp)
            m = YOLO(path, device=yolo.device)  # through AutoBackend
            ms = _bench_backend(m.backend, imgsz)
            row["ms/img"] = round(ms, 2)
            row["images/sec"] = round(1000.0 / ms, 1)
            if data:
                res = m.val(data=data, imgsz=imgsz, batch=batch, verbose=False)
                row["mAP50-95"] = round(res["metrics/mAP50-95(B)"], 4)
        except Exception as e:  # keep the matrix going (reference try_export)
            row["status"] = f"FAILED: {type(e).__name__}: {e}"[:60]
        rows.append(row)

    if verbose:
        keys = list(rows[0].keys())
        print(" | ".join(f"{k:>12}" for k in keys))
        for r in rows:
            print(" | ".join(f"{str(v):>12}" for v in r.values()))
    return rows


class ProfileModels:
    """Profile a set of models for speed, parameters and FLOPs (reference
    ``ProfileModels``, ``fce_yolo_tpu/utils/benchmarks.py:152``): each model
    YAML or checkpoint directory is built on ``device`` and its forward
    (bfloat16 when ``half``, the stem kernel where its gate allows) timed on
    a random uint8 image, warmup first, then until both ``num_timed_runs``
    and ``min_time`` are met; the times are sigma-clipped before the
    mean and deviation are printed. An exported artifact (``.pt2``,
    ``.fyir``) is read by ``AutoBackend`` on ``device`` and a batch of its
    size timed through it; other artifacts (``.tflite``, ``.stablehlo``)
    need TensorFlow or JAX and get a ``FAILED`` row.

    Examples:
        >>> ProfileModels(["yolo11n.yaml"], imgsz=640).run()
    """

    ARTIFACTS = ("*.pt2", "*.fyir", "*.tflite", "*.stablehlo")

    def __init__(
        self,
        paths: list[str],
        num_timed_runs: int = 100,
        num_warmup_runs: int = 10,
        min_time: float = 10.0,
        imgsz: int = 640,
        half: bool = True,
        verbose: bool = True,
        device: torch.device | str = "cuda",
    ):
        self.paths = list(paths)
        self.num_timed_runs = num_timed_runs
        self.num_warmup_runs = num_warmup_runs
        self.min_time = min_time
        self.imgsz = imgsz
        self.half = half
        self.verbose = verbose
        self.device = torch.device(device)

    def get_files(self) -> list[Path]:
        """Directories that are not checkpoints yield the model YAMLs and
        exported artifacts in them; other paths pass through."""
        files: list[Path] = []
        for p in self.paths:
            p = Path(p)
            if p.is_dir() and not (p / "meta.json").exists():
                for ext in ("*.yaml", "*.yml", *self.ARTIFACTS):
                    files += sorted(p.glob(ext))
            else:
                files.append(p)
        return files

    @staticmethod
    def iterative_sigma_clipping(data: np.ndarray, sigma: float = 2.0, max_iters: int = 3) -> np.ndarray:
        """Drop samples beyond ``sigma`` standard deviations of the mean,
        repeated up to ``max_iters`` times or until stable (reference
        iterative_sigma_clipping)."""
        data = np.asarray(data, np.float64)
        for _ in range(max_iters):
            mean, std = data.mean(), data.std()
            clipped = data[(data > mean - sigma * std) & (data < mean + sigma * std)]
            if len(clipped) == len(data) or len(clipped) == 0:
                break
            data = clipped
        return data

    def _sample_times(self, call) -> np.ndarray:
        """Per-call seconds: warmup, then run until both num_timed_runs and
        min_time are satisfied (reference's min_time extension rule)."""
        for _ in range(self.num_warmup_runs):
            call()
        times: list[float] = []
        total = 0.0
        while len(times) < self.num_timed_runs or total < self.min_time:
            t0 = time.perf_counter()
            call()
            dt = time.perf_counter() - t0
            times.append(dt)
            total += dt
            if len(times) >= 10 * self.num_timed_runs:  # hard cap
                break
        return np.asarray(times)

    def _profile_one(self, path: Path) -> dict[str, Any]:
        from fce_yolo_tpu_torch.api import YOLO

        if path.suffix in (".tflite", ".stablehlo"):
            raise NotImplementedError(f"{path.name}: a {path.suffix} artifact needs TensorFlow or JAX; the port "
                                      "reads .pt2 and .fyir")
        m = YOLO(str(path), device=self.device)
        if m.backend is not None:
            return self._profile_backend(path, m.backend)
        imgsz, batch = self.imgsz, 1
        pred = _bf16_predictor(m, imgsz, batch, self.half)
        img = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (batch, imgsz, imgsz, 3),
                                                                  dtype=np.uint8)).to(self.device)

        def call() -> float:
            out = pred.forward(img)
            return float(sum(t.float().sum() for t in _tensors(out)))

        info = m.info(flops=True, imgsz=imgsz)
        ms = self.iterative_sigma_clipping(self._sample_times(call) * 1000.0 / batch)
        return {
            "name": path.stem,
            "runtime": "torch (native)",
            "imgsz": imgsz,
            "ms/img": round(float(ms.mean()), 2),
            "ms_std": round(float(ms.std()), 2),
            "params(M)": round(info["params"] / 1e6, 2),
            "FLOPs(B)": round(info.get("gflops", 0.0), 2),
        }

    def _profile_backend(self, path: Path, backend) -> dict[str, Any]:
        """An artifact's row: a batch of its size of random uint8 images
        through the backend, each call read back to the host."""
        imgsz, batch = backend.imgsz, backend.batch
        x = np.random.RandomState(0).randint(0, 255, (batch, imgsz, imgsz, 3)).astype(np.float32)

        def call() -> float:
            out = backend(x)
            return float(sum(t.float().sum() for t in (out.values() if isinstance(out, dict) else [out])))

        ms = self.iterative_sigma_clipping(self._sample_times(call) * 1000.0 / batch)
        return {
            "name": path.stem,
            "runtime": backend.fmt,
            "imgsz": imgsz,
            "ms/img": round(float(ms.mean()), 2),
            "ms_std": round(float(ms.std()), 2),
            "params(M)": round(int(backend.meta.get("params", 0)) / 1e6, 2),
            "FLOPs(B)": round(float(backend.meta.get("gflops", 0.0)), 2),
        }

    def run(self) -> list[dict[str, Any]]:
        """Profile every resolved file; print the reference-style markdown
        table; return the result rows."""
        files = self.get_files()
        if not files:
            print("No matching model files found to profile.")
            return []
        rows = []
        for f in files:
            try:
                rows.append(self._profile_one(f))
            except Exception as e:  # keep the table going, like try_export
                rows.append({"name": f.stem, "runtime": "FAILED",
                             "imgsz": self.imgsz, "ms/img": None, "ms_std": None,
                             "params(M)": None, "FLOPs(B)": None,
                             "error": f"{type(e).__name__}: {e}"[:80]})
        if self.verbose:
            print(f"| {'Model':<24} | {'runtime':<12} | {'imgsz':>5} | "
                  f"{'Speed (ms/im)':>16} | {'params (M)':>10} | {'FLOPs (B)':>9} |")
            print("|" + "-" * 26 + "|" + "-" * 14 + "|" + "-" * 7 + "|" + "-" * 18 + "|" + "-" * 12 + "|" + "-" * 11 + "|")
            for r in rows:
                spd = f"{r['ms/img']} ± {r['ms_std']}" if r["ms/img"] is not None else "FAILED"
                print(f"| {r['name']:<24} | {r['runtime']:<12} | {r['imgsz']:>5} | "
                      f"{spd:>16} | {str(r['params(M)']):>10} | {str(r['FLOPs(B)']):>9} |")
        return rows

