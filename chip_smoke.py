"""Smoke run of the PyTorch + CUDA port on one GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, then drives
``YOLO("yolo11s-fce.yaml", device="cuda").predict`` at full width (640 px,
random weights from a seed) and checks that the main path went through both
kernels. The stem is also timed at B=16 and B=64 and on the m form
(yolo11m-fce) beside cuDNN's unfused bf16 layers 0-2; the NMS kernels at
B=1, 16 and 64 (K=1024), with few valid candidates, at the validator's
K=4096 and with scores out of order. Every kernel's time stands beside its
bound (the least time the card could take).

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
NMS_K_VAL = 4096  # the validator's candidate pool (pre_nms_topk at conf 0.001)
E2E_BATCH, E2E_BATCHES = 16, 3  # the stem kernel is also checked at this batch, the main path's
BIG_BATCH = 64  # the stem and the device path again where the device is busy
IMGSZ = 640
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
    launches = phase_e2e(yolo, spec, card)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "fused_stem", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/stem.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_stem.py:309", "launches": launches["fused_stem"],
         **{k: stem[k] for k in keys}},
        {"name": "pick_suppress", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_nms.py:33", "launches": launches["pick_suppress"],
         **{k: nms[k] for k in keys}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
