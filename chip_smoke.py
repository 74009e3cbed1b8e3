"""Smoke run of the PyTorch + CUDA port on one GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, then drives
``YOLO("yolo11s-fce.yaml", device="cuda").predict`` at full width (640 px,
random weights from a seed) and checks that the main path went through both
kernels.

    python3 chip_smoke.py

Exits non-zero, printing no result, without CUDA or without the package.
The last stdout line is ``{"ok": true, "device": {...}}``; the line before
the card line is the per-kernel JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
NMS_BATCH, NMS_K, MAX_DET = 16, 1024, 300
E2E_BATCH, E2E_BATCHES = 16, 3  # the stem kernel is also checked at this batch, the main path's
IMGSZ = 640


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call between CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nms_candidates(rng: np.random.RandomState, b: int, k: int):
    """tests/test_pallas_nms.py's generator: random boxes, sorted scores, valid > 0.3."""
    centers = rng.uniform(50, 500, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, scores, scores > 0.3


def check_stem(x: torch.Tensor, weights, spec, what: str) -> tuple[float, float, float]:
    """The stem kernel against its f32 plain version on ``x``: max error
    within 0.02 * max|ref| and a uniform per-row error (max <= 3x median;
    a halo or padding fault spikes the edge rows), the JAX kernel test's
    bounds (tests/test_pallas_stem.py:59-63). Returns (max|d|,
    max|d|/max|ref|, per-row max/median)."""
    from fce_yolo_tpu_torch.ops.stem import fused_stem, stem_reference

    out = fused_stem(x, weights, spec)
    ref = stem_reference(x, weights.arrays, spec)
    torch.cuda.synchronize()
    out_np, ref_np = out.float().cpu().numpy(), ref.cpu().numpy()
    check(tuple(out.shape) == (x.shape[0], spec.h4, spec.w4, spec.c2), f"{what}: stem shape {tuple(out.shape)}")
    check(bool(np.isfinite(out_np).all()), f"{what}: stem output not finite")
    scale = float(np.abs(ref_np).max())
    d = np.abs(out_np - ref_np)
    rel = float(d.max()) / scale
    per_row = d.max(axis=(0, 2, 3)) / scale
    spread = float(per_row.max()) / max(float(np.median(per_row)), 1e-6)
    check(rel <= 0.02, f"{what}: stem kernel disagrees with the plain version: {rel:.3e} > 0.02")
    check(spread < 3, f"{what}: stem per-row error not uniform (halo/padding fault): {per_row}")
    return float(d.max()), rel, spread


def phase_stem(model, spec, card: str) -> dict:
    from fce_yolo_tpu_torch.ops.stem import fold_stem_params, fused_stem, stem_reference, stem_weights

    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randint(0, 256, (E2E_BATCH, spec.H, spec.W, 3), np.uint8)).cuda()
    weights = stem_weights(fold_stem_params(model, spec), spec)
    dmax, rel, spread = check_stem(x, weights, spec, "phase stem")
    # the unfused bf16 graph for layers 0..2, as the predictor runs it without the kernel
    x_nchw = (x.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    stem_layers = torch.nn.Sequential(*model.model[:3])
    with torch.inference_mode():
        ms = cuda_ms(lambda: fused_stem(x, weights, spec))
        plain_ms = cuda_ms(lambda: stem_reference(x, weights.arrays, spec))
        layers_ms = cuda_ms(lambda: stem_layers(x_nchw))
    print(f"phase stem: {spec} B={E2E_BATCH} max|d|/max|ref|={rel:.3e} (limit 0.02) "
          f"per-row max/median={spread:.2f} (limit 3) kernel {ms:.3f} ms, plain f32 {plain_ms:.3f} ms, "
          f"unfused bf16 layers 0-2 {layers_ms:.3f} ms [{card}]", flush=True)
    return {"max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms, "layers_ms": layers_ms}


def phase_nms(card: str) -> dict:
    from fce_yolo_tpu_torch.ops.nms import pick_suppress, pick_suppress_reference

    rng = np.random.RandomState(SEED)
    cases = []
    for thr in (0.45, 0.7):
        cases.append((f"random iou={thr}", *nms_candidates(rng, NMS_BATCH, NMS_K), thr))
    z = np.zeros((2, NMS_K), np.float32)
    cases.append(("no valid", np.zeros((2, NMS_K, 4), np.float32), z, z > 0, 0.45))
    b, s, v = nms_candidates(rng, 4, NMS_K)
    b[:, 1::2] = b[:, 0::2]  # duplicate boxes with equal scores
    s[:, 1::2] = s[:, 0::2]
    cases.append(("duplicates+ties", b, s, s > 0.3, 0.45))
    cases.append(("K=1000", *nms_candidates(rng, 4, 1000), 0.45))
    worst = 0
    timing = None
    for name, boxes, scores, valid, thr in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (boxes, scores, valid)]
        ref_idx, ref_ok = pick_suppress_reference(*args, thr, MAX_DET)
        cu = [a.cuda() for a in args]
        idx, ok = pick_suppress(*cu, iou_thres=thr, max_det=MAX_DET)
        idx, ok = idx.cpu(), ok.cpu()
        mism = int((idx != ref_idx).sum() + (ok != ref_ok).sum())
        worst = max(worst, mism)
        print(f"phase nms: {name} B={boxes.shape[0]} K={boxes.shape[1]} kept={int(ok.sum())} "
              f"mismatches={mism}", flush=True)
        check(mism == 0, f"NMS kernel differs from the plain version on {name!r}")
        if name == "random iou=0.7":
            timing = (cu, thr)
    cu, thr = timing
    ms = cuda_ms(lambda: pick_suppress(*cu, iou_thres=thr, max_det=MAX_DET))
    plain_ms = cuda_ms(lambda: pick_suppress_reference(*cu, thr, MAX_DET), iters=3, warmup=1)
    print(f"phase nms: B={NMS_BATCH} K={NMS_K} max_det={MAX_DET} iou=0.7 kernel {ms:.3f} ms, "
          f"plain (torch ops on the card) {plain_ms:.3f} ms [{card}]", flush=True)
    return {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms}


def phase_e2e(yolo, spec, card: str) -> dict:
    from fce_yolo_tpu_torch.data.augment import letterbox
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.ops.nms import batched_nms, pick_suppress
    from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, fused_stem, stem_weights

    rng = np.random.RandomState(SEED + 1)
    imgs = [rng.randint(0, 256, (IMGSZ, IMGSZ, 3), np.uint8) for _ in range(E2E_BATCHES * E2E_BATCH)]
    imgs.append(rng.randint(0, 256, (IMGSZ * 3 // 4, IMGSZ, 3), np.uint8))  # letterboxed
    yolo.predict(imgs[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    fused_stem.launches = pick_suppress.launches = 0
    t0 = time.perf_counter()
    results = yolo.predict(imgs, imgsz=IMGSZ, batch=E2E_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_stem": fused_stem.launches, "pick_suppress": pick_suppress.launches}

    check(len(results) == len(imgs), f"{len(results)} results for {len(imgs)} images")
    for r, img in zip(results, imgs):
        check(len(r) <= MAX_DET, f"{len(r)} > max_det detections")
        check(bool(np.isfinite(r.boxes.data).all()), "non-finite boxes")
        h, w = img.shape[:2]
        xyxy = r.boxes.xyxy
        check(bool(((xyxy >= 0) & (xyxy <= np.array([w, h, w, h]))).all()), "boxes outside the image")
    check(launches["fused_stem"] > 0 and launches["pick_suppress"] > 0,
          f"main path skipped a kernel: {launches}")

    # the first batch as the predictor built it (letterbox, BGR -> RGB), on the same folded bf16 model
    model = yolo.model
    batch = torch.from_numpy(np.stack([np.ascontiguousarray(letterbox(im, IMGSZ, scaleup=False)[0][..., ::-1])
                                       for im in imgs[:E2E_BATCH]])).cuda()
    weights = stem_weights(fold_stem_params(model, spec), spec)
    _, stem_rel, stem_spread = check_stem(batch, weights, spec, "phase e2e")
    # kernel path vs plain path: a smoke check of the resumed graph (the decoded
    # preds are dominated by the anchor grid, so the stem check above is the strict one)
    x = (batch.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    with torch.inference_mode():
        fused = apply_with_fused_stem(model, batch, spec, weights)["preds"].float().cpu().numpy()
        plain = model(x)["preds"].float().cpu().numpy()
    dmax = float(np.abs(fused - plain).max())
    bound = 0.02 * max(float(np.abs(plain).max()), 1.0)
    corr = float(np.corrcoef(fused.ravel(), plain.ravel())[0, 1])
    check(dmax <= bound and corr > 0.9999, f"kernel path preds differ: max|d|={dmax} (<= {bound}), corr={corr}")

    predictor = DetectionPredictor(model, yolo.names, imgsz=IMGSZ, batch_size=E2E_BATCH)
    with torch.inference_mode():
        ms_kernel = cuda_ms(lambda: predictor.infer(batch), iters=5)
        ms_plain = cuda_ms(lambda: batched_nms(model(x)["preds"], conf_thres=0.25, iou_thres=0.7,
                                               multi_label=False), iters=5)
    n_det = sum(len(r) for r in results)
    print(f"phase e2e: yolo11s-fce {IMGSZ} bf16 B={E2E_BATCH}, {len(imgs)} images, {n_det} detections, "
          f"launches {launches}; stem on the fed batch max|d|/max|ref|={stem_rel:.3e} (limit 0.02), "
          f"per-row max/median={stem_spread:.2f} (limit 3); "
          f"preds kernel vs plain path max|d|={dmax:.3e} (limit {bound:.3e}) "
          f"corr={corr:.6f}; {len(imgs) / wall:.1f} img/s through YOLO.predict (host clock, incl. "
          f"letterbox); {ms_kernel:.2f} ms/batch stem kernel+model+NMS vs {ms_plain:.2f} ms/batch "
          f"plain stem (CUDA events) [{card}]", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script only runs on a GPU")
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.kernels import build as kbuild
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    _, build_s, report = kbuild.build()
    kbuild.library()
    print(f"phase env: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel build {build_s:.1f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "), flush=True)

    yolo = YOLO("yolo11s-fce.yaml", device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()  # the predictor would fold on first use
    spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
    check(spec is not None, "yolo11s-fce must take the fused stem")

    stem = phase_stem(yolo.model, spec, card)
    nms = phase_nms(card)
    launches = phase_e2e(yolo, spec, card)

    kernels = [
        {"name": "fused_stem", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/stem.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_stem.py:309", "launches": launches["fused_stem"],
         "max_abs_err": stem["max_abs_err"], "ms": stem["ms"], "plain_ms": stem["plain_ms"]},
        {"name": "pick_suppress", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_nms.py:33", "launches": launches["pick_suppress"],
         "max_abs_err": nms["max_abs_err"], "ms": nms["ms"], "plain_ms": nms["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
