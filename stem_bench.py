"""Time one checkout's fused stem kernel beside cuDNN's unfused bf16 layers
0-2 on one GPU, at 640 px.

    python3 stem_bench.py [--root CHECKOUT] [--model yolo11s-fce.yaml] [--batches 16 64]

``--root`` imports ``fce_yolo_tpu_torch`` from another checkout, for
example an earlier commit unpacked with ``git archive`` into ``build/``.
That checkout's own kernel source, weight packing and build are used, so
two versions of the kernel are timed by the same script: run them in turns
in one call (parent, change, change, parent). The kernel is first held
against ``stem_reference`` with chip_smoke.py's bounds; then the kernel
and cuDNN are timed in turns, twice. Prints one JSON object per batch,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

# chip_smoke imports the port only inside its functions, so they use the checkout chosen below
from chip_smoke import IMGSZ, SEED, card_line, check_stem, cuda_ms, stem_bound


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                    help="checkout whose fce_yolo_tpu_torch is timed (default: this one)")
    ap.add_argument("--model", default="yolo11s-fce.yaml")
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stem_bench: CUDA is not available; this script only runs on a GPU")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import fce_yolo_tpu_torch
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.kernels import build as kbuild
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.ops.stem import fold_stem_params, fused_stem, stem_spec_from_model, stem_weights

    if not Path(fce_yolo_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"stem_bench: imported {fce_yolo_tpu_torch.__file__}, not the package under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    _, build_s, _ = kbuild.build()

    yolo = YOLO(args.model, device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()
    spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
    if spec is None:
        raise SystemExit(f"stem_bench: {args.model} does not take the fused stem at {IMGSZ} px")
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
        print(json.dumps({"root": str(args.root), "model": args.model, "batch": batch, "kernel_ms": kernel_ms,
                          "cudnn_layers_0_2_ms": cudnn_ms, "rel_err": rel, "row_spread": spread,
                          "bound_ms": bound_ms, "bound_by": bound_by, "build_s": build_s}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
