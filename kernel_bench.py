"""Time one checkout's CUDA kernel on one GPU: the fused stem beside cuDNN's
unfused bf16 layers 0-2 at 640 px, the NMS kernels on chip_smoke.py's
timed cases, or the JPEG decode; or that checkout's train step.

    python3 kernel_bench.py --kernel stem [--root CHECKOUT] [--model yolo11s-fce.yaml] [--batches 16 64]
    python3 kernel_bench.py --kernel nms [--root CHECKOUT]
    python3 kernel_bench.py --kernel train-step [--root CHECKOUT] [--batches 16]
    python3 kernel_bench.py --kernel jpeg [--root CHECKOUT]

``--root`` imports ``fce_yolo_tpu_torch`` from another checkout, for
example an earlier commit unpacked with ``git archive`` into ``build/``.
That checkout's own kernel sources, weight packing and build are used, so
two versions of a kernel are timed by the same script: run them in turns in
one call (parent, change, change, parent). Each kernel is first held against
its plain version with chip_smoke.py's bounds (the stem within 0.02 *
max|ref| and a uniform per-row error; NMS bit for bit). The stem and cuDNN
are then timed in turns, twice, with CUDA events around 10 calls; NMS twice
from a CUDA graph of 20 calls (device time, without the host's launch cost),
once from Python, and split by kernel with torch.profiler (device time of
each kernel per call). The train step is chip_smoke.py's phase train (c)
(``train_step_times``: yolo11s-fce at 640 px, bf16 and float32 steps, peak
memory, AdamW + EMA alone) on random images with 1-3 boxes each. The JPEG
decode is chip_smoke.py's phase jpeg (c) (``time_jpeg``: a call split by
stage, each kernel alone, img/s on 1 and 8 threads) on its 480x640 and
1080x1920 4:2:0 q95 images. Prints one JSON object per batch or case, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

# chip_smoke imports the port only inside its functions, so they use the checkout chosen below
from chip_smoke import (IMGSZ, MAX_DET, SEED, card_line, check_stem, cuda_ms, graph_ms, jpeg_bytes, jpeg_test_image,
                        nms_bound, nms_timed_cases, stem_bound, time_jpeg, train_step_times)


def bench_stem(args) -> None:
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.kernels import build as kbuild
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.ops.stem import fold_stem_params, fused_stem, stem_spec_from_model, stem_weights

    _, build_s, _ = kbuild.build()
    yolo = YOLO(args.model, device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()
    spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
    if spec is None:
        raise SystemExit(f"kernel_bench: {args.model} does not take the fused stem at {IMGSZ} px")
    weights = stem_weights(fold_stem_params(yolo.model, spec), spec)
    stem_layers = torch.nn.Sequential(*yolo.model.model[:3])

    for batch in args.batches:
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randint(0, 256, (batch, spec.H, spec.W, 3), np.uint8)).cuda()
        _, rel, spread = check_stem(x, weights, spec, f"{args.model} B={batch}")
        x_nchw = (x.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
        kernel_ms, cudnn_ms = [], []
        with torch.inference_mode():
            for _ in range(2):
                cudnn_ms.append(cuda_ms(lambda: stem_layers(x_nchw)))
                kernel_ms.append(cuda_ms(lambda: fused_stem(x, weights, spec)))
        bound_ms, bound_by = stem_bound(spec, batch)
        print(json.dumps({"root": str(args.root), "kernel": "stem", "model": args.model, "batch": batch,
                          "kernel_ms": kernel_ms, "cudnn_layers_0_2_ms": cudnn_ms, "rel_err": rel,
                          "row_spread": spread, "bound_ms": bound_ms, "bound_by": bound_by, "build_s": build_s}),
              flush=True)


def kernel_split(call, iters: int = 20) -> dict[str, float]:
    """Device milliseconds per call of each CUDA kernel that ``call`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        name, us = re.search(r"\w+_kernel\b", event.key), getattr(event, "device_time_total", 0)
        if name and us:
            split[name.group(0)] = us / iters / 1e3
    return split


def bench_nms(args) -> None:
    from fce_yolo_tpu_torch.kernels import build as kbuild
    from fce_yolo_tpu_torch.ops.nms import pick_suppress, pick_suppress_reference

    _, build_s, _ = kbuild.build()
    for name, boxes, scores, valid in nms_timed_cases():
        cu = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
        ref_idx, ref_ok = pick_suppress_reference(*(a.cpu() for a in cu), 0.7, MAX_DET)
        idx, ok = pick_suppress(*cu, iou_thres=0.7, max_det=MAX_DET)
        mism = int((idx.cpu() != ref_idx).sum() + (ok.cpu() != ref_ok).sum())
        if mism:
            raise SystemExit(f"kernel_bench: NMS kernel differs from the plain version on {name!r}: {mism}")

        def call():
            return pick_suppress(*cu, iou_thres=0.7, max_det=MAX_DET)

        kernel_ms = [graph_ms(call) for _ in range(2)]
        eager_ms = cuda_ms(call)
        split = kernel_split(call)
        kept = int(ref_ok.sum())
        bound_ms, bound_by = nms_bound(boxes.shape[0], boxes.shape[1], kept)
        print(json.dumps({"root": str(args.root), "kernel": "nms", "case": name, "batch": boxes.shape[0],
                          "k": boxes.shape[1], "max_det": MAX_DET, "iou": 0.7, "picks": kept,
                          "kernel_ms": kernel_ms, "eager_ms": eager_ms, "split_ms": split, "bound_ms": bound_ms,
                          "bound_by": bound_by, "build_s": build_s}), flush=True)


def bench_train_step(args) -> None:
    for batch in args.batches:
        rng = np.random.RandomState(SEED)
        cls, boxes = np.zeros((batch, 8), np.float32), np.zeros((batch, 8, 4), np.float32)
        mask = np.zeros((batch, 8), bool)
        for i in range(batch):
            k = rng.randint(1, 4)
            cls[i, :k] = rng.randint(0, 80, k)
            boxes[i, :k] = np.concatenate([rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.1, 0.4, (k, 2))], 1)
            mask[i, :k] = True
        img = rng.randint(0, 256, (batch, IMGSZ, IMGSZ, 3), np.uint8)
        bdev = {k: torch.from_numpy(v).cuda() for k, v in (("img", img), ("cls", cls), ("bboxes", boxes),
                                                          ("mask", mask))}
        print(json.dumps({"root": str(args.root), "bench": "train_step", "model": "yolo11s-fce.yaml", "batch": batch,
                          **train_step_times(bdev, nc=80)}), flush=True)


def bench_jpeg(args) -> None:
    from fce_yolo_tpu_torch.data import jpeg as J

    card = card_line()
    for what, seed, (h, w), n in (("480x640 4:2:0 q95", SEED + 22, (480, 640), 20),
                                  ("1080x1920 4:2:0 q95", SEED + 21, (1080, 1920), 10)):
        buf = jpeg_bytes(jpeg_test_image(np.random.RandomState(seed), h, w), 95, "420", 0)
        # the plain path's Python entropy decode is for small images: held at 480x640 only
        if h < 1000 and not (J.decode_jpeg(buf, what, "cuda") == J.decode_jpeg_reference(buf, what)).all():
            raise SystemExit(f"kernel_bench: {what}: the card's decode differs from the plain path")
        out = time_jpeg(buf, what, n, card)
        print(json.dumps({"root": str(args.root), "bench": "jpeg", "image": what, "bytes": len(buf),
                          **{k: v for k, v in out.items() if k != "bounds"}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("stem", "nms", "train-step", "jpeg"), required=True)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                    help="checkout whose fce_yolo_tpu_torch is timed (default: this one)")
    ap.add_argument("--model", default="yolo11s-fce.yaml", help="stem: the model whose stem is timed")
    ap.add_argument("--batches", type=int, nargs="+", default=None,
                    help="stem (default 16 64) or train-step (default 16): the batch sizes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: CUDA is not available; this script only runs on a GPU")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import fce_yolo_tpu_torch

    if not Path(fce_yolo_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kernel_bench: imported {fce_yolo_tpu_torch.__file__}, not the package under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if args.batches is None:
        args.batches = [16] if args.kernel == "train-step" else [16, 64]
    {"stem": bench_stem, "nms": bench_nms, "train-step": bench_train_step, "jpeg": bench_jpeg}[args.kernel](args)
    print(card)


if __name__ == "__main__":
    main()
