"""Smoke run of the PyTorch + CUDA port on one GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, then drives
the port's entry points at full width (yolo11s-fce, 640 px, random weights
from a seed) and checks that each path went through its kernels:

- ``YOLO.predict`` (bf16, B=16): the stem kernel and the NMS kernel;
- ``YOLO.val`` (f32, B=16) on 64 PNG images written here: the NMS kernel at
  the validator's K=4096 over 80 classes, once per batch, bit-equal to the
  plain version on every batch and giving the same P, R and mAP;
- ``detection_loss`` (train mode, f32, B=16) with CIoU and with WIoU v3 over
  three steps: finite parts and gradients, equal to the loss on the CPU;
- ``YOLO.train`` (bf16, AdamW, B=16, 2 epochs on those 64 images as both
  splits): finite losses, checkpoints, the NMS kernel once per val batch of
  each epoch and bit-equal to the plain version on the last epoch's, the
  reloaded ``best`` giving the run's mAP; the train step timed in bf16 and
  f32; one f32 SGD step on the card against the CPU and a float64 step;
- the experiment layer: first the fold repair (``predict`` leaves the
  facade's model unfolded, so it saves, reloads and trains with its
  BatchNorm; ``fuse`` saves and reloads folded), then ``run_ablation`` of
  the four variants (baseline, bifpn, fce, fce_wiou) at s, 640 px, B=16,
  stage 1 and stage 2 of one epoch each with the recipe's lr0 and cos_lr,
  on those 64 images as both splits: stage 2 starting bit-equal from stage
  1's best, ``validate_run`` clean, the NMS kernel once per val batch of
  every stage and bit-equal to the plain version on each, ``inspect``,
  ``YOLO.info`` and the report's tables.

The stem is also timed at B=16 and B=64 and on the m form (yolo11m-fce)
beside cuDNN's unfused bf16 layers 0-2; the NMS kernels at B=1, 16 and 64
(K=1024), with few valid candidates, at K=4096 and with scores out of
order. Every kernel's time stands beside its bound (the least time the card
could take).

    python3 chip_smoke.py

Exits non-zero, printing no result, without CUDA or without the package.
The last stdout line is ``{"ok": true, "device": {...}}``; the line before
the card line is the per-kernel JSON record.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

SEED = 0
NMS_BATCH, NMS_K, MAX_DET = 16, 1024, 300
NMS_K_VAL = 4096  # the validator's candidate pool (pre_nms_topk at conf 0.001)
E2E_BATCH, E2E_BATCHES = 16, 3  # the stem kernel is also checked at this batch, the main path's
BIG_BATCH = 64  # the stem and the device path again where the device is busy
IMGSZ = 640
VAL_IMAGES, VAL_BATCH, VAL_NC = 64, 16, 80  # 4 val batches; 80 class names, labels in classes 0-2
LOSS_STEPS = 3  # phase loss: one step on each of the first val batches
LOSS_TOL = 1e-3  # card vs CPU loss parts, relative: float32 in both, sums in another order
TRAIN_EPOCHS = 2  # phase train: YOLO.train on the 64 val images as both splits
TRAIN_TOL = 1e-3  # phase train (a), card vs CPU: loss parts, relative; updates, of the largest update
ABLATION_SCALE = "s"  # phase experiments: every variant at full width and depth
# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, f32 on the CUDA cores, HBM
BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``, from CUDA-event timed
    replays of one CUDA graph of ``iters`` calls: the host's Python and launch
    cost is left out, so a kernel shorter than its launch is timed as such."""
    fn()  # build, cache and set kernel attributes before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nms_candidates(rng: np.random.RandomState, b: int, k: int, conf: float = 0.3):
    """tests/test_pallas_nms.py's generator: random boxes, sorted scores, valid > conf."""
    centers = rng.uniform(50, 500, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, scores, scores > conf


def nms_few_valid(rng: np.random.RandomState, b: int, k: int):
    """Only the 32 highest scores valid: a trained model's predict at conf 0.25."""
    boxes, scores, valid = nms_candidates(rng, b, k)
    valid[:, 32:] = False
    return boxes, scores, valid


def nms_timed_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray]]:
    """The NMS kernel's timed cases at iou 0.7, max_det 300: the main path's
    shape (B=16, K=1024) first, then B=1 (streaming) and B=64, few valid, the
    validator's pool (K=4096, every score above 0.001 valid), and B=16 with
    the candidates shuffled (scores out of order, as a caller other than the
    top-K may give them)."""
    def rng(i):
        return np.random.RandomState(SEED + 10 + i)
    boxes, scores, valid = nms_candidates(rng(5), NMS_BATCH, NMS_K)
    perm = rng(6).permutation(NMS_K)
    return [
        ("B=16 K=1024", *nms_candidates(rng(0), NMS_BATCH, NMS_K)),
        ("B=1 K=1024", *nms_candidates(rng(1), 1, NMS_K)),
        ("B=64 K=1024", *nms_candidates(rng(2), 64, NMS_K)),
        ("B=16 K=1024 few valid", *nms_few_valid(rng(3), NMS_BATCH, NMS_K)),
        (f"B=16 K={NMS_K_VAL}", *nms_candidates(rng(4), NMS_BATCH, NMS_K_VAL, conf=0.001)),
        ("B=16 K=1024 unsorted", boxes[:, perm].copy(), scores[:, perm].copy(), valid[:, perm].copy()),
    ]


def nms_bound(b: int, k: int, kept: int) -> tuple[float, str]:
    """Least ms for greedy NMS on this data: the inputs read and the outputs
    written once, against each pick (this run's kept boxes) computing ~16 f32
    operations with each of the K candidates. Returns (ms, what bounds it)."""
    nbytes = b * k * (16 + 4 + 1) + b * MAX_DET * (4 + 1)
    ops_ms, bytes_ms = 1e3 * 16 * k * kept / F32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_stem(x: torch.Tensor, weights, spec, what: str, out: torch.Tensor | None = None) -> tuple[float, float, float]:
    """The stem kernel against its f32 plain version on ``x``: max error
    within 0.02 * max|ref| and a uniform per-row error (max <= 3x median;
    a halo or padding fault spikes the edge rows), the JAX kernel test's
    bounds (tests/test_pallas_stem.py:59-63). ``out`` is the kernel's
    output when the caller ran it. Returns (max|d|, max|d|/max|ref|, per-row
    max/median)."""
    from fce_yolo_tpu_torch.ops.stem import fused_stem, stem_reference

    if out is None:
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


def stem_bound(spec, batch: int) -> tuple[float, str]:
    """Least ms for the stem's work: the useful multiply-adds of its convs
    (L0 at H/2 x W/2, the rest at H/4 x W/4, from the spec's shapes) at the
    bf16 tensor rate, against the uint8 image read and the bf16 output
    written once. Returns (ms, what bounds it)."""
    from fce_yolo_tpu_torch.ops.stem import _conv_shapes

    macs = sum((spec.H // 2) * (spec.W // 2) * cout * k * k * cin if i == 0 else spec.h4 * spec.w4 * cout * k * k * cin
               for i, (k, cin, cout) in enumerate(_conv_shapes(spec)))
    ops_ms = 1e3 * 2 * macs * batch / BF16_FLOPS
    bytes_ms = 1e3 * batch * (spec.H * spec.W * 3 + spec.h4 * spec.w4 * spec.c2 * 2) / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_stem(model, spec, batch: int, card: str, what: str) -> dict:
    """Check the kernel on a seeded batch, then time it beside its plain
    version and the unfused bf16 layers 0-2 (cuDNN, what the predictor runs
    without the kernel) on the same batch."""
    from fce_yolo_tpu_torch.ops.stem import fold_stem_params, fused_stem, stem_reference, stem_weights

    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randint(0, 256, (batch, spec.H, spec.W, 3), np.uint8)).cuda()
    weights = stem_weights(fold_stem_params(model, spec), spec)
    dmax, rel, spread = check_stem(x, weights, spec, f"phase stem {what} B={batch}")
    x_nchw = (x.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    stem_layers = torch.nn.Sequential(*model.model[:3])
    with torch.inference_mode():
        ms = cuda_ms(lambda: fused_stem(x, weights, spec))
        plain_ms = cuda_ms(lambda: stem_reference(x, weights.arrays, spec), iters=3, warmup=1)
        layers_ms = cuda_ms(lambda: stem_layers(x_nchw))
        ms2 = cuda_ms(lambda: fused_stem(x, weights, spec))  # kernel, cuDNN, kernel: one spread
    bound_ms, bound_by = stem_bound(spec, batch)
    print(f"phase stem: {what} {spec} B={batch} max|d|/max|ref|={rel:.3e} (limit 0.02) "
          f"per-row max/median={spread:.2f} (limit 3) kernel {ms:.3f} / {ms2:.3f} ms, plain f32 {plain_ms:.3f} ms, "
          f"unfused bf16 layers 0-2 {layers_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    return {"max_abs_err": dmax, "ms": min(ms, ms2), "plain_ms": plain_ms, "library_ms": layers_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_stem(model, spec, model_m, spec_m, card: str) -> dict:
    """The s form at the main path's batch (its numbers go into the kernel
    record) and at B=64, then the m form at B=16."""
    main = time_stem(model, spec, E2E_BATCH, card, "s")
    big = time_stem(model, spec, BIG_BATCH, card, "s")
    m = time_stem(model_m, spec_m, E2E_BATCH, card, "m")
    print("phase stem: kernel / cuDNN layers 0-2: " + ", ".join(
        f"{name} {r['ms'] / r['library_ms']:.2f}" for name, r in (("s B=16", main), ("s B=64", big), ("m B=16", m))),
        flush=True)
    return main


def phase_nms(card: str) -> dict:
    """The kernel bit for bit against its plain version on every case, then
    timed on the cases of ``nms_timed_cases``; the first (the main path's
    shape) goes into the kernel record."""
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
    cases.append(("few valid", *nms_few_valid(rng, NMS_BATCH, NMS_K), 0.7))
    cases.append((f"K={NMS_K_VAL}", *nms_candidates(rng, NMS_BATCH, NMS_K_VAL, conf=0.001), 0.7))
    worst = 0
    for name, boxes, scores, valid, thr in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (boxes, scores, valid)]
        ref_idx, ref_ok = pick_suppress_reference(*args, thr, MAX_DET)
        idx, ok = pick_suppress(*(a.cuda() for a in args), iou_thres=thr, max_det=MAX_DET)
        idx, ok = idx.cpu(), ok.cpu()
        mism = int((idx != ref_idx).sum() + (ok != ref_ok).sum())
        worst = max(worst, mism)
        print(f"phase nms: {name} B={boxes.shape[0]} K={boxes.shape[1]} kept={int(ok.sum())} "
              f"mismatches={mism}", flush=True)
        check(mism == 0, f"NMS kernel differs from the plain version on {name!r}")

    record = None
    for name, boxes, scores, valid in nms_timed_cases():
        cu = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
        ref_idx, ref_ok = pick_suppress_reference(*(a.cpu() for a in cu), 0.7, MAX_DET)
        idx, ok = pick_suppress(*cu, iou_thres=0.7, max_det=MAX_DET)
        check(bool((idx.cpu() == ref_idx).all() and (ok.cpu() == ref_ok).all()),
              f"NMS kernel differs from the plain version on the timed case {name!r}")
        kept = int(ref_ok.sum())
        ms = graph_ms(lambda: pick_suppress(*cu, iou_thres=0.7, max_det=MAX_DET))
        eager_ms = cuda_ms(lambda: pick_suppress(*cu, iou_thres=0.7, max_det=MAX_DET))
        bound_ms, bound_by = nms_bound(boxes.shape[0], boxes.shape[1], kept)
        line = (f"phase nms: {name} max_det={MAX_DET} iou=0.7 {kept} picks: kernel {ms:.4f} ms on the device "
                f"(CUDA graph), {eager_ms:.4f} ms a call from Python (CUDA events), "
                f"bound {bound_ms:.4f} ms ({bound_by})")
        if record is None:  # the main path's shape: the plain version too
            plain_ms = cuda_ms(lambda: pick_suppress_reference(*cu, 0.7, MAX_DET), iters=3, warmup=1)
            line += f", plain (torch ops on the card) {plain_ms:.3f} ms"
            record = {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{line} [{card}]", flush=True)
    return record


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
    # the device path again at B=64, where the device is busy
    rng = np.random.RandomState(SEED + 2)
    big = torch.from_numpy(rng.randint(0, 256, (BIG_BATCH, IMGSZ, IMGSZ, 3), np.uint8)).cuda()
    x_big = (big.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    predictor_big = DetectionPredictor(model, yolo.names, imgsz=IMGSZ, batch_size=BIG_BATCH)
    with torch.inference_mode():
        big_kernel = cuda_ms(lambda: predictor_big.infer(big), iters=5)
        big_plain = cuda_ms(lambda: batched_nms(model(x_big)["preds"], conf_thres=0.25, iou_thres=0.7,
                                                multi_label=False), iters=5)
    n_det = sum(len(r) for r in results)
    print(f"phase e2e: yolo11s-fce {IMGSZ} bf16 B={E2E_BATCH}, {len(imgs)} images, {n_det} detections, "
          f"launches {launches}; stem on the fed batch max|d|/max|ref|={stem_rel:.3e} (limit 0.02), "
          f"per-row max/median={stem_spread:.2f} (limit 3); "
          f"preds kernel vs plain path max|d|={dmax:.3e} (limit {bound:.3e}) "
          f"corr={corr:.6f}; {len(imgs) / wall:.1f} img/s through YOLO.predict (host clock, incl. "
          f"letterbox); {ms_kernel:.2f} ms/batch stem kernel+model+NMS vs {ms_plain:.2f} ms/batch "
          f"plain stem (CUDA events); B={BIG_BATCH}: {big_kernel:.2f} ms/batch stem kernel+model+NMS vs "
          f"{big_plain:.2f} ms/batch plain stem [{card}]", flush=True)
    return launches


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) written with zlib; row r takes
    filter r % 5 (None, Sub, Up, Average, Paeth), so the reader meets all five."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])  # (5, H, W*3)
    kind = np.arange(h) % 5
    rows = (x - preds[kind, np.arange(h)]) & 255
    raw = np.concatenate([kind[:, None], rows], 1).astype(np.uint8).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_val_dataset(root: Path) -> str:
    """tests/conftest.py's tiny dataset at full size: VAL_IMAGES PNG images of
    480-800 px a side, grey with 1-3 solid rectangles of classes 0-2 at the
    labelled positions; the data YAML names VAL_NC classes."""
    rng = np.random.RandomState(SEED + 3)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i in range(VAL_IMAGES):
        h, w = rng.randint(480, 801, 2)
        img = np.full((h, w, 3), 60, np.uint8)
        lines = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randint(0, 3)
            bw, bh = rng.uniform(0.2, 0.4), rng.uniform(0.2, 0.4)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            x1, y1, x2, y2 = int((cx - bw / 2) * w), int((cy - bh / 2) * h), int((cx + bw / 2) * w), int((cy + bh / 2) * h)
            img[y1: y2 + 1, x1: x2 + 1] = [(80, 80, 255), (80, 255, 80), (255, 80, 80)][k]  # RGB
            lines.append(f"{k} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (root / "images" / "val" / f"{i:03d}.png").write_bytes(png_bytes(img))
        (root / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n{names}")
    return str(root / "data.yaml")


def matching_model(yolo):
    """Seed-0 weights without the class prior, then so that some detections
    match the labels (mAP above zero): DFL bin 8 of every side up by 6 (boxes
    ~16 strides wide) and the labels' classes 0-2 up by 1 (scores ~0.73, the
    rest ~0.5)."""
    from fce_yolo_tpu_torch.nn.model import init_weights

    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    with torch.no_grad():
        for branch in yolo.model.detect.cv2:
            branch[-1].bias[8::16] += 6.0
        for branch in yolo.model.detect.cv3:
            branch[-1].bias[:3] += 1.0
    return yolo


def nms_kernel_vs_plain(val, preds: torch.Tensor, calls: list) -> dict:
    """``val.nms(preds)`` with the NMS kernel, then again with its plain
    version swapped into ``ops.nms``; the kernel then runs on the candidates
    the plain pass saw, once the swap is undone (inside it, the kernel's
    wrapper would count on the swapped-in function). Checks idx/ok and the
    ``batched_nms`` outputs equal; appends (candidates, plain (idx, ok)) to
    ``calls``; returns both passes' outputs as numpy."""
    from fce_yolo_tpu_torch.ops import nms as nms_ops

    real = nms_ops.pick_suppress

    def plain(boxes, scores, valid, iou_thres, max_det):
        out = nms_ops.pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)
        calls.append(((boxes.clone(), scores.clone(), valid.clone()), out))
        return out

    outs = {"kernel": {k: v.cpu().numpy() for k, v in val.nms(preds).items()}}
    try:
        nms_ops.pick_suppress = plain
        outs["plain"] = {k: v.cpu().numpy() for k, v in val.nms(preds).items()}
    finally:
        nms_ops.pick_suppress = real
    args, (ip, op) = calls[-1]
    ik, ok = real(*args, iou_thres=val.iou, max_det=val.max_det)
    check(args[0].shape[1] == NMS_K_VAL, f"val NMS ran at K={args[0].shape[1]}, not {NMS_K_VAL}")
    mism = int((ik != ip).sum() + (ok != op).sum())
    check(mism == 0, f"val batch {len(calls)}: NMS kernel differs from the plain version ({mism})")
    check(all((outs["kernel"][k] == outs["plain"][k]).all() for k in outs["kernel"]),
          f"val batch {len(calls)}: batched_nms outputs differ between the kernel and the plain version")
    return outs


def phase_val(data: str, card: str) -> tuple[dict, dict, dict]:
    """``YOLO.val`` with the counts at 0, then each batch again with the NMS
    kernel and with its plain version on the same candidates: idx/ok equal,
    and P, R, mAP (above zero: the random head's boxes are widened and the
    labels' classes raised) equal through the same ``_update_metrics``. Returns (the
    val path's launches, the NMS kernel's val-path record, and the model
    with the first LOSS_STEPS batches for phase loss)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.ops import nms as nms_ops
    from fce_yolo_tpu_torch.ops.boxes import xywh2xyxy
    from fce_yolo_tpu_torch.ops.stem import fused_stem
    from fce_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics

    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))  # float32, the plain graph (as the JAX validator)
    with torch.inference_mode():  # cuDNN's first-call set-up, outside the timed run
        yolo.model.eval()(torch.zeros(VAL_BATCH, 3, IMGSZ, IMGSZ, device="cuda"))
    torch.cuda.synchronize()

    fused_stem.launches = nms_ops.pick_suppress.launches = 0
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_stem": fused_stem.launches, "pick_suppress": nms_ops.pick_suppress.launches}
    n_batches = -(-VAL_IMAGES // VAL_BATCH)
    check(launches["pick_suppress"] == n_batches, f"val path: {launches} NMS launches for {n_batches} batches")
    check(len(res["metrics"].stats["conf"]) == VAL_IMAGES, "val path scored the wrong number of images")

    val = DetectionValidator(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=VAL_BATCH)
    loader = val.get_dataloader(data)
    real = nms_ops.pick_suppress
    calls: list[tuple] = []  # per batch: the candidates and the plain version's (idx, ok)
    sets = {k: (DetMetrics(names=yolo.names), ConfusionMatrix(names=yolo.names)) for k in ("kernel", "plain")}
    metrics_s, kept_batches, n_images = 0.0, [], 0
    yolo.model.eval()
    for batch in loader:
        img = torch.from_numpy(batch["img"]).cuda()
        preds = val.forward(img)
        outs = nms_kernel_vs_plain(val, preds, calls)
        for name, (m, cm) in sets.items():
            t0 = time.perf_counter()
            val._update_metrics(outs[name], batch, m, cm, None, n_images)
            metrics_s += (time.perf_counter() - t0) / 2
        n_images += batch["n_valid"]
        if len(kept_batches) < LOSS_STEPS:
            kept_batches.append((batch, img, preds))
    for m, _ in sets.values():
        m.process(nc=val.nc)
    mk, mp = sets["kernel"][0].mean_results(), sets["plain"][0].mean_results()
    check(mk == mp, f"P, R, mAP50, mAP50-95 from the kernel {mk} != from the plain version {mp}")
    check(mk[2] > 0, f"val path: mAP50 is 0, so the comparison above shows nothing: {mk}")
    check(bool((sets["kernel"][1].matrix == sets["plain"][1].matrix).all()), "confusion matrices differ")

    batch, img, preds = kept_batches[0]
    args, (_, ok0) = calls[0]
    kept = int(ok0.sum())
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: val.nms(val.forward(img)), iters=5)
        boxes, scores = xywh2xyxy(preds[..., :4].float()), preds[..., 4: 4 + val.nc].float()
        select_ms = cuda_ms(lambda: nms_ops._select_candidates(boxes, scores, val.pre_nms_topk, True), iters=5)
        kernel_ms = graph_ms(lambda: real(*args, iou_thres=val.iou, max_det=val.max_det))
        plain_ms = cuda_ms(lambda: nms_ops.pick_suppress_reference(*args, val.iou, val.max_det), iters=2, warmup=1)
    ds = loader.dataset
    t0 = time.perf_counter()
    for i in range(VAL_BATCH):
        ds[i]
    host_ms = (time.perf_counter() - t0) * 1e3  # decode + letterbox of one batch, one thread
    t0 = time.perf_counter()
    for f in ds.im_files[:VAL_BATCH]:
        imread(f)
    png_ms = (time.perf_counter() - t0) * 1e3 / VAL_BATCH
    bound_ms, bound_by = nms_bound(args[0].shape[0], args[0].shape[1], kept)
    speed = res["metrics"].speed
    print(f"phase val: yolo11s-fce {IMGSZ} f32 B={VAL_BATCH}, {VAL_IMAGES} PNG images in {n_batches} batches, "
          f"launches {launches}; NMS kernel idx/ok equal to the plain version on every batch (K=4096, "
          f"nc={val.nc}); P/R/mAP50/mAP50-95 {tuple(round(v, 6) for v in mk)} equal from both; "
          f"YOLO.val {VAL_IMAGES / wall:.1f} img/s (host clock, incl. dataset scan and PNG decode); "
          f"device {device_ms:.2f} ms/batch forward + NMS (CUDA events), of it candidate selection "
          f"{select_ms:.3f} ms and the NMS kernel {kernel_ms:.4f} ms ({kept} picks; CUDA graph; bound "
          f"{bound_ms:.4f} ms, {bound_by}; plain {plain_ms:.2f} ms); host {host_ms:.1f} ms/batch decode + "
          f"letterbox on one thread ({png_ms:.1f} ms per PNG decode, 480-800 px, all five filters), "
          f"{metrics_s * 1e3 / n_batches:.1f} ms/batch metrics; YOLO.val's own split per image: "
          f"loader wait {speed['preprocess']:.2f} ms, inference {speed['inference']:.2f} ms, "
          f"metrics {speed['postprocess']:.2f} ms [{card}]", flush=True)
    record = {"val_ms": kernel_ms, "val_plain_ms": plain_ms, "val_bound_ms": bound_ms, "val_bound_by": bound_by}
    return launches, record, {"yolo": yolo, "batches": [(b, im) for b, im, _ in kept_batches]}


def phase_loss(val_out: dict, card: str) -> None:
    """yolo11s-fce in train mode (f32, 640 px, B=16), three steps on the val
    dataset's first three batches with CIoU and with WIoU v3, the WIoU state
    carried from step to step. Each step: finite parts, fg_count > 0, a
    finite gradient for every parameter, and the parts (with float32
    assigner storage) and the WIoU running mean equal to the CPU's on the
    same feats within LOSS_TOL relative."""
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState, detection_loss

    yolo = val_out["yolo"]
    model = yolo.model.train()
    steps = [((img.permute(0, 3, 1, 2).float() / 255.0),
              {k: torch.from_numpy(batch[k]).cuda() for k in ("cls", "bboxes", "mask")})
             for batch, img in val_out["batches"]]
    params = [p for p in model.parameters() if p.requires_grad]
    worst = 0.0
    for iou_type in ("CIoU", "WIoU"):
        cfg = DetectionLossCfg(nc=yolo.spec.nc, strides=tuple(yolo.strides), iou_type=iou_type)
        cfg32 = cfg._replace(tal_dtype="float32")
        state, card32, cpu32 = LossState.init("cuda"), LossState.init("cuda"), LossState.init("cpu")
        for step, (x, targets) in enumerate(steps):
            targets_cpu = {k: v.cpu() for k, v in targets.items()}
            model.zero_grad(set_to_none=True)
            feats = model(x)["feats"]
            total, parts, state = detection_loss(feats, targets, cfg, state)
            total.backward()
            vals = {k: float(v.detach()) for k, v in parts.items()}
            check(all(np.isfinite(v) for v in vals.values()) and vals["fg_count"] > 0, f"{iou_type} loss parts {vals}")
            bad = [i for i, p in enumerate(params) if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            check(not bad, f"{iou_type}: {len(bad)} parameters without a finite gradient")
            with torch.no_grad():
                _, on_card, card32 = detection_loss([f.detach() for f in feats], targets, cfg32, card32)
                _, on_cpu, cpu32 = detection_loss([f.detach().cpu() for f in feats], targets_cpu, cfg32, cpu32)
            rel = {k: abs(float(on_card[k]) - float(on_cpu[k])) / max(abs(float(on_cpu[k])), 1e-12) for k in on_cpu}
            rel["wiou_mean"] = abs(float(card32.wiou_loss_mean) - float(cpu32.wiou_loss_mean)) / abs(
                float(cpu32.wiou_loss_mean))
            worst = max(worst, *rel.values())
            check(max(rel.values()) <= LOSS_TOL, f"{iou_type} step {step}: card vs CPU loss parts differ {rel}")
            print(f"phase loss: {iou_type} step {step}: box {vals['box']:.5f} cls {vals['cls']:.5f} "
                  f"dfl {vals['dfl']:.5f} fg {vals['fg_count']:.0f}; card vs CPU (float32 assigner) max rel "
                  f"{max(rel.values()):.2e} (limit {LOSS_TOL}), WIoU mean card {float(card32.wiou_loss_mean):.6f} "
                  f"cpu {float(cpu32.wiou_loss_mean):.6f}", flush=True)
        x, targets = steps[0]

        def step_fn():
            model.zero_grad(set_to_none=True)
            detection_loss(model(x)["feats"], targets, cfg, state)[0].backward()

        ms = cuda_ms(step_fn, iters=3, warmup=1)
        print(f"phase loss: {iou_type} yolo11s-fce {IMGSZ} f32 B={VAL_BATCH}: {ms:.1f} ms forward + loss + "
              f"backward (CUDA events; TF32 off) [{card}]", flush=True)
    model.eval()
    print(f"phase loss: every check passed; worst card vs CPU relative difference {worst:.2e}", flush=True)


def train_data(root: Path) -> dict:
    """The val images as the train split too (phase train's data), 80 names."""
    return {"path": str(root), "train": "images/val", "val": "images/val", "names": [f"class{i}" for i in range(VAL_NC)]}


def step_delta_check(data: dict, card: str) -> float:
    """Phase train (a): one SGD step (no warmup and nbs = the batch, so the
    step fires and every parameter moves; training BN; float32, TF32 off;
    the assigner's overlaps stored in float32, as in phase loss) of the
    port's train step on the card and on the CPU, from the same weights and
    the same mosaic batch.

    Checks, card against CPU: the loss parts within TRAIN_TOL relative; the
    parameter updates within TRAIN_TOL of the CPU's largest update; the BN
    running variances within 1e-4 relative and the running means within
    1e-4 of the channel's running standard deviation. The same step in
    float64 on the card is printed beside them, as a witness of which side
    strays if the check fails. Returns the update difference."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState, detection_loss
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    d = check_det_dataset(data)
    batch = next(iter(DataLoader(YOLODataset(d["train"], imgsz=IMGSZ, mode="train", nc=VAL_NC),
                                 batch_size=VAL_BATCH, workers=8)))
    cfg = OptimCfg(optimizer="SGD", batch_size=VAL_BATCH, nbs=VAL_BATCH, epochs=TRAIN_EPOCHS,
                   steps_per_epoch=VAL_IMAGES // VAL_BATCH, nc=VAL_NC, warmup_epochs=0.0)
    keys = ("img", "cls", "bboxes", "mask")
    sd0 = YOLO("yolo11s-fce.yaml", device="cpu").model.state_dict()
    after, parts = {}, {}
    for side, device in (("card", "cuda"), ("CPU", "cpu")):  # the port's train step in float32
        yolo = YOLO("yolo11s-fce.yaml", device=device)
        yolo.model.load_state_dict(sd0)
        opt = Optimizer(cfg, yolo.model)
        state = create_train_state(yolo.model, opt)
        step = make_train_step(yolo.model, opt, DetectionLossCfg(nc=VAL_NC, strides=tuple(yolo.strides),
                                                                 tal_dtype="float32"))
        state, m = step(state, {k: torch.from_numpy(batch[k]).to(device) for k in keys})
        check(m["finite"] and opt.count == 1, f"phase train (a): the {side} step did not update ({m['finite']})")
        parts[side] = {k: float(m[k]) for k in ("box", "cls", "dfl", "fg_count")}
        after[side] = {k: v.detach().cpu().double() for k, v in yolo.model.state_dict().items()}
        del yolo, opt, state, step
    yolo = YOLO("yolo11s-fce.yaml", device="cuda")  # the same step in float64: forward, loss, backward, SGD
    yolo.model.load_state_dict(sd0)
    model = yolo.model.double().train()
    t = {k: torch.from_numpy(batch[k]).cuda() for k in keys}
    t["bboxes"] = t["bboxes"].double()
    feats = model(t["img"].permute(0, 3, 1, 2).double() / 255.0)["feats"]
    total, p64, _ = detection_loss(feats, t, DetectionLossCfg(nc=VAL_NC, strides=tuple(yolo.strides),
                                                             tal_dtype="float32"), LossState.init("cuda"))
    total.backward()
    params = [q for _, q in model.named_parameters()]
    Optimizer(cfg, model).step(params, [q.grad for q in params])
    after["float64"] = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    parts["float64"] = {k: float(v) for k, v in p64.items()}
    del yolo, model, feats, total, params
    torch.cuda.empty_cache()

    weights = [k for k in sd0 if "running" not in k and "num_batches" not in k]

    def distance(a: dict, ref: dict) -> tuple[float, float, float]:
        """Loss parts (relative), updates (of ref's largest update), BN statistics."""
        rel = max(abs(parts[a][k] - parts[ref][k]) / max(abs(parts[ref][k]), 1e-12) for k in parts[ref])
        x, r = after[a], after[ref]
        dp_max = max(float((r[k] - sd0[k].double()).abs().max()) for k in weights)
        du = max(float((x[k] - r[k]).abs().max()) for k in weights) / dp_max
        bn = 0.0
        for k in r:
            if k.endswith("running_mean"):
                bn = max(bn, float((x[k] - r[k]).abs().max() / r[k.replace("mean", "var")].sqrt().min()))
            elif k.endswith("running_var"):
                bn = max(bn, float(((x[k] - r[k]).abs() / r[k]).max()))
        return rel, du, bn

    rel_parts, du, bn = distance("card", "CPU")
    wit = {side: distance(side, "float64") for side in ("card", "CPU")}
    print(f"phase train (a): yolo11s-fce {IMGSZ} B={VAL_BATCH}, one SGD step, training BN, float32 (TF32 off), on "
          f"one mosaic batch, card vs CPU: loss parts max rel {rel_parts:.2e} (limit {TRAIN_TOL}), updates "
          f"{du:.2e} of the CPU's largest (limit {TRAIN_TOL}), BN statistics {bn:.2e} (limit 1e-4); parts: card "
          f"{parts['card']}, CPU {parts['CPU']}, float64 {parts['float64']}; witness, each against the float64 step "
          f"on the card (parts, updates, BN): card {wit['card'][0]:.2e} {wit['card'][1]:.2e} {wit['card'][2]:.2e}, "
          f"CPU {wit['CPU'][0]:.2e} {wit['CPU'][1]:.2e} {wit['CPU'][2]:.2e} [{card}]", flush=True)
    check(rel_parts <= TRAIN_TOL, f"phase train (a): loss parts card vs CPU {parts}")
    check(du <= TRAIN_TOL, f"phase train (a): the updates card vs CPU differ by {du:.3e} of the largest")
    check(bn <= 1e-4, f"phase train (a): the BN running statistics card vs CPU differ by {bn:.3e}")
    return du


def train_step_times(bdev: dict, nc: int) -> dict:
    """The train step (forward + loss + backward + clip + AdamW + EMA, with
    its one host sync) of yolo11s-fce on a batch already on the card: CUDA
    events over 5 steps after 2, in bf16 autocast and in float32 (TF32 off),
    with the peak memory of each; then AdamW + EMA alone on the float32
    model (10 calls after 2)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    batch = int(bdev["img"].shape[0])
    out = {}
    for bf16 in (True, False):
        yolo = YOLO("yolo11s-fce.yaml", device="cuda")
        opt = Optimizer(OptimCfg(optimizer="AdamW", batch_size=batch, nbs=batch, nc=nc), yolo.model)
        state = create_train_state(yolo.model, opt)
        step = make_train_step(yolo.model, opt, DetectionLossCfg(nc=nc, strides=tuple(yolo.strides)), bf16=bf16)
        step(state, bdev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tag = "bf16" if bf16 else "f32"
        out[f"step_ms_{tag}"] = cuda_ms(lambda: step(state, bdev), iters=5, warmup=2)
        out[f"peak_gib_{tag}"] = torch.cuda.max_memory_allocated() / 2**30
        if not bf16:
            params = state.params
            grads = [torch.full_like(p, 1e-3) for p in params]
            out["optimizer_ema_ms"] = cuda_ms(lambda: (opt.step(params, grads), state.ema.update(params)))
        del yolo, opt, state, step
        torch.cuda.empty_cache()
    return out


def time_train_step(data: dict, card: str) -> dict:
    """Phase train (c): ``train_step_times`` on a mosaic batch, and one
    mosaic item's host time on one thread."""
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader

    d = check_det_dataset(data)
    ds = YOLODataset(d["train"], imgsz=IMGSZ, mode="train", nc=VAL_NC)
    batch = next(iter(DataLoader(ds, batch_size=VAL_BATCH, workers=8)))
    out = train_step_times({k: torch.from_numpy(batch[k]).cuda() for k in ("img", "cls", "bboxes", "mask")}, VAL_NC)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for i in range(4):
        ds.get(i, rng)
    out["item_ms"] = (time.perf_counter() - t0) * 1e3 / 4
    print(f"phase train (c): train step yolo11s-fce {IMGSZ} B={VAL_BATCH} AdamW on a batch on the card (forward + "
          f"loss + backward + clip + optimizer + EMA, CUDA events): bf16 {out['step_ms_bf16']:.1f} ms "
          f"(peak {out['peak_gib_bf16']:.2f} GiB), f32 TF32 off {out['step_ms_f32']:.1f} ms (peak "
          f"{out['peak_gib_f32']:.2f} GiB); AdamW + EMA alone {out['optimizer_ema_ms']:.2f} ms; host: one mosaic "
          f"item (4 PNG decodes, resizes, warp, HSV, flip) {out['item_ms']:.1f} ms on one thread [{card}]", flush=True)
    return out


def phase_train(root: Path, card: str) -> dict:
    """(b) ``YOLO.train`` for TRAIN_EPOCHS epochs
    with the defaults (bf16, AdamW from "auto") on 64 PNG images as both
    splits, starting from phase val's matching weights: finite losses, one
    results.csv row an epoch, last and best written, the NMS kernel launched
    once per val batch of every epoch and equal to the plain version on the
    last epoch's batches, and ``best`` reloaded in a fresh YOLO giving the
    run's best mAP50-95 within 1e-6; (c) times; (a) one step card vs CPU.
    Returns the train path's launches."""
    import csv as _csv

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.ops import nms as nms_ops
    from fce_yolo_tpu_torch.ops.stem import fused_stem

    data = train_data(root)
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))
    captured: list[torch.Tensor] = []
    real_nms = DetectionValidator.nms

    def capturing_nms(self, preds):  # keeps each val batch's preds for the check after the run
        captured.append(preds.detach().clone())
        return real_nms(self, preds)

    n_val = -(-VAL_IMAGES // VAL_BATCH)
    DetectionValidator.nms = capturing_nms
    try:
        fused_stem.launches = nms_ops.pick_suppress.launches = 0
        t0 = time.perf_counter()
        res = yolo.train(data, epochs=TRAIN_EPOCHS, batch=VAL_BATCH, imgsz=IMGSZ, project=str(root / "runs"),
                         verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_stem": fused_stem.launches, "pick_suppress": nms_ops.pick_suppress.launches}
    finally:
        DetectionValidator.nms = real_nms
    check(launches == {"fused_stem": 0, "pick_suppress": n_val * TRAIN_EPOCHS},
          f"train path: launches {launches}, expected no stem and {n_val} NMS an epoch")
    rows = res["results"]
    check(res["epochs_run"] == len(rows) == TRAIN_EPOCHS, f"train path ran {res['epochs_run']} epochs")
    check(all(np.isfinite(r[k]) for r in rows for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")),
          f"train path: a logged loss is not finite {rows}")
    save_dir = Path(res["save_dir"])
    with open(save_dir / "results.csv") as f:
        check(len(list(_csv.DictReader(f))) == TRAIN_EPOCHS, "results.csv does not hold one row an epoch")
    for w in ("last", "best"):
        check((save_dir / "weights" / w / "meta.json").exists(), f"weights/{w} missing")

    val = DetectionValidator(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=VAL_BATCH)  # nms settings of the run
    calls: list = []
    check(len(captured) == n_val * TRAIN_EPOCHS, f"{len(captured)} val batches seen")
    for preds in captured[-n_val:]:  # the last epoch's val
        nms_kernel_vs_plain(val, preds, calls)
    del captured

    best = max(rows, key=lambda r: r["fitness"])
    check(best["metrics/mAP50(B)"] > 0, f"train path: mAP50 is 0, so the reload comparison shows nothing: {best}")
    again = YOLO(str(save_dir / "weights" / "best"), device="cuda").val(data, imgsz=IMGSZ, batch=VAL_BATCH,
                                                                           verbose=False)
    d_map = abs(again["metrics/mAP50-95(B)"] - best["metrics/mAP50-95(B)"])
    check(d_map <= 1e-6, f"best reloaded: mAP50-95 {again['metrics/mAP50-95(B)']} vs the run's {best}")
    for e, (r, sp) in enumerate(zip(rows, res["speed"])):
        print(f"phase train (b): epoch {e + 1}/{TRAIN_EPOCHS}: loss box/cls/dfl {r['train/box_loss']:.4f}/"
              f"{r['train/cls_loss']:.4f}/{r['train/dfl_loss']:.4f}, mAP50 {r['metrics/mAP50(B)']:.6f} mAP50-95 "
              f"{r['metrics/mAP50-95(B)']:.6f}; {sp['img_per_s']:.2f} img/s; per step: loader wait "
              f"{sp['loader_wait_ms']:.1f} ms, step {sp['step_ms']:.1f} ms of which the host sync "
              f"{sp['sync_ms']:.1f} ms; val {sp['val_s']:.2f} s [{card}]", flush=True)
    times = time_train_step(data, card)
    step_delta_check(data, card)
    print(f"phase train: YOLO.train yolo11s-fce {IMGSZ} bf16 B={VAL_BATCH} AdamW, {TRAIN_EPOCHS} epochs of "
          f"{VAL_IMAGES // VAL_BATCH} steps on {VAL_IMAGES} PNG images, launches {launches}; NMS kernel idx/ok equal to "
          f"the plain version on the last epoch's {n_val} val batches; best reloaded: mAP50-95 "
          f"{again['metrics/mAP50-95(B)']:.6f} vs {best['metrics/mAP50-95(B)']:.6f} (|d| {d_map:.1e}, limit 1e-6); "
          f"{wall:.1f} s in all; step {times['step_ms_bf16']:.1f} ms bf16 / {times['step_ms_f32']:.1f} ms f32 "
          f"[{card}]", flush=True)
    return launches


def phase_repair(root: Path, card: str) -> None:
    """The facade's model is never folded by ``predict`` (yolo11s-fce, f32,
    640 px): after a predict its state_dict keeps every BatchNorm key, it
    saves and ``YOLO(ckpt)`` loads it and predicts the same; a later
    ``YOLO.train`` (one epoch, no val) trains the graph with BatchNorm (the
    running statistics move, the checkpoint holds them); ``fuse`` then
    ``save`` then a load gives a folded model with the same predictions."""
    from fce_yolo_tpu_torch import YOLO

    rng = np.random.RandomState(SEED + 4)
    imgs = [rng.randint(0, 256, (IMGSZ, IMGSZ * 3 // 4, 3), np.uint8) for _ in range(4)]

    def same(a: list, b: list, what: str) -> float:
        check(len(a) == len(b) and all(len(x) == len(y) for x, y in zip(a, b)), f"{what}: detection counts differ")
        d = max((float(np.abs(x.boxes.data - y.boxes.data).max()) for x, y in zip(a, b) if len(x)), default=0.0)
        check(d <= 1e-3, f"{what}: predictions differ by {d}")
        return d

    yolo = YOLO("yolo11s-fce.yaml", device="cuda")
    keys = set(yolo.model.state_dict())
    t0 = time.perf_counter()
    ref = yolo.predict(imgs, imgsz=IMGSZ, batch=4)
    predict_s = time.perf_counter() - t0
    check(set(yolo.model.state_dict()) == keys and not yolo.folded, "predict folded the facade's model")
    again = YOLO(yolo.save(root / "repair" / "after_predict"), device="cuda")
    check(set(again.model.state_dict()) == keys and not again.folded, "the checkpoint after predict lost BatchNorm")
    d_reload = same(again.predict(imgs, imgsz=IMGSZ, batch=4), ref, "predict -> save -> load")
    t0 = time.perf_counter()
    yolo.predict(imgs, imgsz=IMGSZ, batch=4)  # the folded copy is reused: no fold this time
    predict2_s = time.perf_counter() - t0

    var0 = yolo.model.model[0].bn.running_var.clone()
    res = yolo.train(train_data(root), epochs=1, batch=VAL_BATCH, imgsz=IMGSZ, val=False, project=str(root / "repair"),
                     name="train", verbose=False)
    check(isinstance(yolo.model.model[0].bn, torch.nn.BatchNorm2d) and not torch.equal(
        yolo.model.model[0].bn.running_var, var0), "predict -> train did not train the BatchNorm graph")
    last = YOLO(str(Path(res["save_dir"]) / "weights" / "last"), device="cuda")
    check(not last.folded and set(last.model.state_dict()) == keys, "the trained checkpoint lost BatchNorm")

    ref = yolo.fuse().predict(imgs, imgsz=IMGSZ, batch=4)
    folded = YOLO(yolo.save(root / "repair" / "fused"), device="cuda")
    check(folded.folded and not any(".bn." in k for k in folded.model.state_dict()), "fuse -> save -> load unfolded")
    d_fused = same(folded.predict(imgs, imgsz=IMGSZ, batch=4), ref, "fuse -> save -> load")
    print(f"phase experiments: fold repair: predict leaves the {len(keys)} state_dict keys (BatchNorm included); "
          f"save -> YOLO(ckpt) predicts the same (max|d| {d_reload:.1e}); predict -> train trains BatchNorm; fuse -> "
          f"save -> load folded predicts the same (max|d| {d_fused:.1e}); predict of 4 images {predict_s:.2f} s with "
          f"the fold, {predict2_s:.2f} s reusing it (host clock) [{card}]", flush=True)


def phase_experiments(root: Path, card: str) -> dict:
    """``run_ablation`` of the four variants at ABLATION_SCALE, IMGSZ,
    VAL_BATCH, stage 1 and stage 2 of one epoch each (the registry's recipe
    otherwise: lr0, cos_lr, close_mosaic), on the 64 val images as both
    splits through a data YAML, with the counts at 0. Checks: each stage 2
    starts bit-equal to its stage 1's ``weights/best``; ``validate_run``
    reports no problem and fce_wiou's best says WIoU; ``ablation_s.json``
    holds four rows; the NMS kernel launched once per val batch of every
    stage (the stem never) and bit-equal to the plain version on each
    stage's val; ``inspect`` finds finite fusion weights in every
    BiFPN_Concat of fce and bifpn; ``YOLO.info`` of the three
    architectures; the report's tables written, each figure drawn or listed
    as skipped. Returns the path's launches."""
    from dataclasses import replace

    from fce_yolo_tpu_torch import YOLO, api
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.experiments import (ABLATION_ORDER, TrainConfig, inspect_checkpoint, run_ablation,
                                                validate_run)
    from fce_yolo_tpu_torch.experiments import config as xconfig
    from fce_yolo_tpu_torch.experiments.figures import produce_report
    from fce_yolo_tpu_torch.ops import nms as nms_ops
    from fce_yolo_tpu_torch.ops.stem import fused_stem
    from fce_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    phase_repair(root, card)
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    data = root / "ablation.yaml"
    data.write_text(f"path: {root}\ntrain: images/val\nval: images/val\nnames:\n{names}")
    project = root / "ablation"
    cfg = TrainConfig(data=str(data), batch=VAL_BATCH, imgsz=IMGSZ, workers=8, project=str(project))
    scale, n_val, stages = ABLATION_SCALE, -(-VAL_IMAGES // VAL_BATCH), 2 * len(ABLATION_ORDER)

    starts: dict[str, dict] = {}  # stage-2 run -> the model's state_dict as YOLO.train begins
    captured: dict[str, list] = {}  # run -> its val batches' preds
    stage_runs: dict[str, tuple] = {}  # run -> (seconds, YOLO.train's speed rows)
    current: list[str] = []
    real_train, real_nms = api.YOLO.train, DetectionValidator.nms

    def recording_train(self, *args, **kw):
        current.append(kw["name"])
        if kw["name"].endswith("_stage2"):
            starts[kw["name"]] = {k: t.detach().cpu().clone() for k, t in self.model.state_dict().items()}
        t0 = time.perf_counter()
        out = real_train(self, *args, **kw)
        torch.cuda.synchronize()
        stage_runs[kw["name"]] = (time.perf_counter() - t0, out["speed"])
        return out

    def capturing_nms(self, preds):
        captured.setdefault(current[-1], []).append(preds.detach().clone())
        return real_nms(self, preds)

    registry = dict(xconfig.MODEL_CONFIGS)
    try:
        for name in ABLATION_ORDER:  # one epoch a stage; the recipe's lr0, cos_lr and close_mosaic
            mc = registry[name]
            xconfig.MODEL_CONFIGS[name] = replace(mc, stage1=replace(mc.stage1, epochs=1),
                                                  stage2=replace(mc.stage2, epochs=1))
        api.YOLO.train, DetectionValidator.nms = recording_train, capturing_nms
        fused_stem.launches = nms_ops.pick_suppress.launches = 0
        t0 = time.perf_counter()
        report = run_ablation(cfg, scale=scale, clean=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_stem": fused_stem.launches, "pick_suppress": nms_ops.pick_suppress.launches}
    finally:
        api.YOLO.train, DetectionValidator.nms = real_train, real_nms
        xconfig.MODEL_CONFIGS.update(registry)

    check(launches == {"fused_stem": 0, "pick_suppress": n_val * stages},
          f"experiments path: launches {launches}, expected no stem and {n_val} NMS a stage over {stages} stages")
    check(report["problems"] == [], f"validate_run: {report['problems']}")
    check(len(report["table"]) == 4 and len(json.loads((project / f"ablation_{scale}.json").read_text())["table"]) == 4,
          "ablation table rows")
    for name in ABLATION_ORDER:
        mc = xconfig.MODEL_CONFIGS[name]
        best, _ = load_checkpoint(project / mc.get_result_path(scale, stage=1) / "weights" / "best")
        start = starts[mc.get_result_path(scale)]
        check(start.keys() == best["model"].keys() and all(torch.equal(start[k], t) for k, t in best["model"].items()),
              f"{name}: stage 2 did not start bit-equal from stage 1's best")
        check(validate_run(project / mc.get_result_path(scale), 1, mc.iou_type) == [], f"{name}: validate_run")
    meta = json.loads((project / xconfig.MODEL_CONFIGS["fce_wiou"].get_result_path(scale) / "weights" / "best"
                       / "meta.json").read_text())
    check(meta["train_args"]["iou_type"] == "WIoU", f"fce_wiou trained with {meta['train_args']['iou_type']}")

    val = DetectionValidator(None, {i: f"class{i}" for i in range(VAL_NC)}, imgsz=IMGSZ, batch_size=VAL_BATCH)
    check(sorted(captured) == sorted(stage_runs) and all(len(v) == n_val for v in captured.values()),
          f"val batches seen per stage: { {k: len(v) for k, v in captured.items()} }")
    for run, preds in captured.items():  # one epoch a stage: its only val is its last
        calls: list = []
        for p in preds:
            nms_kernel_vs_plain(val, p, calls)
    del captured

    fusion = {}
    for name in ("fce", "bifpn"):
        rep = inspect_checkpoint(str(project / xconfig.MODEL_CONFIGS[name].get_result_path(scale) / "weights" / "best"))
        check(len(rep["bifpn"]) == 4 and all(np.isfinite(i["raw"]).all() for i in rep["bifpn"].values()),
              f"{name}: BiFPN fusion weights {rep['bifpn']}")
        fusion[name] = {k: i["normalized"] for k, i in rep["bifpn"].items()}
    for name in ("baseline", "bifpn", "fce"):
        best = project / xconfig.MODEL_CONFIGS[name].get_result_path(scale) / "weights" / "best"
        print(f"phase experiments: YOLO.info(flops=True) of {name}: {YOLO(str(best), device='cuda').info(flops=True)}",
              flush=True)
    out = produce_report(report["runs"], project / "report", scale=scale, imgsz=IMGSZ)
    check(all(Path(p).exists() for p in out["written"]) and sum(p.endswith(".md") for p in out["written"]) == 2,
          f"report: {out}")
    check(len(out["written"]) + len(out["skipped"]) == 2 + 4, f"report figures neither drawn nor listed: {out}")

    for run, (sec, speed) in stage_runs.items():
        print(f"phase experiments: {run}: {sec:.1f} s (YOLO.train, host clock, checkpoints included); " + "; ".join(
            f"epoch {sp['epoch'] + 1}: {sp['img_per_s']:.2f} img/s, val {sp['val_s']:.2f} s" for sp in speed)
              + f" [{card}]", flush=True)
    print(f"phase experiments: run_ablation yolo11{scale} x {len(ABLATION_ORDER)} variants {IMGSZ} bf16 B={VAL_BATCH}, "
          f"{stages} stages of 1 epoch ({VAL_IMAGES // VAL_BATCH} steps), launches {launches}; stage 2 bit-equal to "
          f"stage 1's best for every variant; validate_run clean; NMS kernel idx/ok equal to the plain version on "
          f"all {n_val * stages} val batches; fusion weights {fusion}; report {len(out['written'])} written, "
          f"{len(out['skipped'])} figures skipped; {wall:.1f} s in all [{card}]", flush=True)
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

    def model(name: str):
        yolo = YOLO(name, device="cuda")
        init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
        yolo.to(torch.bfloat16).fuse()  # the predictor would fold on first use
        spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
        check(spec is not None, f"{name} must take the fused stem")
        return yolo, spec

    yolo, spec = model("yolo11s-fce.yaml")
    yolo_m, spec_m = model("yolo11m-fce.yaml")

    stem = phase_stem(yolo.model, spec, yolo_m.model, spec_m, card)
    del yolo_m
    nms = phase_nms(card)
    predict = phase_e2e(yolo, spec, card)
    del yolo
    with tempfile.TemporaryDirectory() as tmp:
        val, nms_val, val_out = phase_val(write_val_dataset(Path(tmp)), card)
        phase_loss(val_out, card)
        del val_out
        train = phase_train(Path(tmp), card)
        experiments = phase_experiments(Path(tmp), card)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paths = {"predict": predict, "val": val, "train": train, "experiments": experiments}
    kernels = [
        {"name": "fused_stem", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/stem.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_stem.py:309", "launches": sum(p["fused_stem"] for p in paths.values()),
         "launches_by_path": {k: p["fused_stem"] for k, p in paths.items()}, **{k: stem[k] for k in keys}},
        {"name": "pick_suppress", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_nms.py:33", "launches": sum(p["pick_suppress"] for p in paths.values()),
         "launches_by_path": {k: p["pick_suppress"] for k, p in paths.items()}, **{k: nms[k] for k in keys},
         **nms_val},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
