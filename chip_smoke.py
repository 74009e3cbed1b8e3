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
- ``YOLO.train`` (bf16, AdamW, B=16, TRAIN_EPOCHS on those 64 images as
  both splits): finite losses, checkpoints, the NMS kernel once per val batch
  of each epoch and bit-equal to the plain version on the last epoch's, the
  reloaded ``best`` giving the run's mAP; the train step timed in bf16 and
  f32; one f32 SGD step on the card against the CPU and a float64 step;
- the experiment layer: first the fold repair (``predict`` leaves the
  facade's model unfolded, so it saves, reloads and trains with its
  BatchNorm; ``fuse`` saves and reloads folded), then ``run_ablation`` of
  the four variants (baseline, bifpn, fce, fce_wiou) at s, 640 px, B=16,
  stage 1 and stage 2 of one epoch each with the recipe's lr0 and cos_lr,
  on the first 32 of those images as both splits: stage 2 starting bit-equal from stage
  1's best, ``validate_run`` clean, the NMS kernel once per val batch of
  every stage and bit-equal to the plain version on each, ``inspect``,
  ``YOLO.info`` and the report's tables;
- JPEG reading (phase jpeg): ``decode_jpeg`` on the card (host entropy
  decode, the IDCT and colour kernels of csrc/jpeg.cu) byte-equal to the
  plain path on baseline files this script writes (every sampling, gray,
  four qualities, restart intervals, EXIF orientations, 1x1 to 1080x1920),
  timed stage by stage; ``YOLO.val`` on a JPEG copy of the 64 images (both
  JPEG kernels once an image, NMS bit-equal on every batch) and
  ``YOLO.predict`` on their directory (stem, NMS and both JPEG kernels; the
  detections equal to a predict on the plain decoder's arrays), and
  ``YOLO.train`` on them;
- the still-image formats (phase formats): files this script writes (BMP
  24-bit, palette and RLE8; TIFF LZW strips with horizontal differencing,
  PackBits tiles, 16-bit and uncompressed; PNG 16-bit and Adam7; PFM; a
  DNG's preview; progressive JPEG in libjpeg's simple progression over a
  baseline file's coefficients) read through ``imread`` on the card, the
  lossless ones equal to the array written and a progressive JPEG to the
  baseline decode of the same coefficients (both JPEG kernels once a file),
  the decodes timed; ``YOLO.val`` on phase val's 64 images written 16 each
  as BMP, LZW TIFF, 16-bit PNG and Adam7 PNG (P, R and mAP equal to phase
  val's, NMS bit-equal on every batch) and as progressive JPEG (equal to
  phase jpeg's, both JPEG kernels once an image); ``YOLO.predict`` on a
  directory of 16 files of every kind and 4 WebP files (stem and NMS once a
  batch, the JPEG kernels once a JPEG, ``webp_color`` once a lossy WebP,
  detections equal to a predict on the arrays); WebP (csrc/webp.cu: the
  container, VP8L, VP8 and ALPH as host C++, then the ``webp_color``
  kernel): every committed fixture (``tests/fixtures/webp``, written by
  cv2's and PIL's libwebp) read on the card with the SHA-256 of cv2's
  decode, the C++ decode equal to the plain decoders on the small ones, the
  kernel equal to ``webp_color_reference``, reads timed at 480x640;
  ``YOLO.val`` on 16 val images as lossy WebP equal to a val on the same
  decoded arrays;
- the task heads (phase tasks): yolo11s-seg, yolo11s-pose and yolo11s-obb
  at 640 px, ``YOLO.predict`` in bf16 at B=16 on arrays (the stem kernel
  held against its plain version on the fed batch, the kernel path's preds
  against the plain path's, and for segment and pose the NMS kernel's
  idx/ok, masks and keypoints equal to the plain version's on the same
  preds) and ``YOLO.val`` in float32 on 16 PNG images it writes with
  polygons, 17-keypoint instances or rotated rectangles (the NMS kernel
  once a segment or pose batch and bit-equal to the plain version on each,
  the same P/R/mAP of every family from both, box mAP50 above zero);
- their training (phase task_train), on those images as both splits: one
  float32 SGD step of each on the card against the CPU, then ``YOLO.train``
  (bf16, AdamW, B=16, 1 epoch of 1 step; mosaic on segment and pose,
  ``copy_paste`` on segment): finite losses, the task validator on the EMA
  model each epoch, the NMS kernel (segment, pose) bit-equal to its plain
  version on every val batch, ``best`` reloaded with its task and keypoint
  shape;
- tracking (phase track): ``YOLO.track`` of the bf16 yolo11s-fce at 640 px,
  one frame a batch, over 48 frames of 720x1280 (a textured scene panned 3
  px a frame there and back, 4 rectangles that move, cross, and leave the
  view and come back), with ByteTrack, BoT-SORT (camera-motion compensation
  on the host, no cv2) and BoT-SORT with ReID through ``YOLO.embed``: the
  stem and the NMS kernel once a frame, the NMS kernel bit-equal to the
  plain version on every frame and the tracks bit-equal through both, the
  stem held and timed at B=1 on a fed frame; the rectangles' true boxes
  keep their ids through BoT-SORT (and through ByteTrack, but the one the
  pan takes out of view) and the GMC recovers the pan within 0.1 px;
- video (phase video): those 48 frames as a Motion-JPEG AVI written here
  (frame 0 without DHT, a ``LIST rec `` group, an odd-sized chunk), each
  frame decoded on the card (both JPEG kernels once a frame) byte-equal to
  the plain decoder; ``YOLO.predict(stream=True)`` and ``YOLO.track``
  (ByteTrack) on the file, the stem, NMS and JPEG kernels once a frame,
  detections and tracks equal to those on the plain decoder's arrays and
  the NMS kernel bit-equal to the plain version on every frame; an OBB
  model tracked over the first 8 frames;
- classify (phase classify): yolo11s-cls at 224 px on a 3-class folder of
  JPEGs written here: ``YOLO.predict`` on the directory (probabilities
  against a CPU copy) and on the AVI, ``YOLO.val``, ``YOLO.train`` for 2
  epochs of 2 steps, the JPEG kernels once an image read, ``best``
  reloaded with its names giving the run's top-1;
- drawing and image writing (phase draw): the JPEG writer's ``jpeg_fdct``
  kernel against its plain version (coefficients equal, files byte-equal)
  from 37x53 to 1080x1920 and on a gray frame, timed beside its bound and
  the host entropy stage; yolo11s-seg (bf16) ``YOLO.predict`` on 8 of
  phase track's frames, then ``Masks.xy``, ``plot``, ``save``,
  ``save_txt`` and ``save_crop``, the stem and NMS kernels once a batch and
  ``jpeg_fdct`` once a file, every file byte-equal to the plain writer's and
  decoded on the card; ``YOLO.val(plots_dir=...)`` writing its mosaics and
  the six figures (the NMS kernel bit-equal to the plain version on every
  batch) and ``YOLO.train(plots=True)`` its mosaics (every ``YOLO.train``
  above writes the first three batches' mosaics and ``results.png`` too);
  each figure, drawn on the host by ``utils/chart.py``, read back through
  the port's PNG reader and timed;
- the solutions layer (phase solutions): the 15 apps (counting, heatmap,
  regions, speed, zones, queues, parking, overlays, blur, crops, instance
  masks, analytics charts, distance, alarms, workouts) through their
  ``__call__`` on 6 of phase track's frames, bf16 yolo11s-fce, -seg and
  -pose at conf 0.25: the stem and NMS kernels once a frame, ``jpeg_fdct``
  once a crop, every frame's tracks, result fields and drawn frame bit-equal
  with the plain NMS swapped in; ``solutions count`` on the short AVI from
  the command line writing a JPEG a frame; ``VisualAISearch`` (HSV and
  CLIP) on the card against the CPU;
- the model families (phase families): the 32 v3/v5/v6/v8/v9/yolo12 YAMLs
  built and run, yolov8s and yolo12s predict, val and a train epoch, the
  v8 task heads' predict;
- YOLOv10 and the last packaged blocks (phase v10): the six v10 YAMLs built
  and run; yolov10s's ``preds6`` on the card against the CPU (float32),
  ``YOLO.predict`` at B=16 in bf16 (no stem, no NMS: the head's top-k is the
  result), its end-to-end ``YOLO.val`` against the CPU's and a train epoch
  with the dual-assignment loss; yolo11-cls-resnet18 predict, val and
  train on phase classify's JPEGs; test-time augmentation of yolo11s-fce
  (15,049 merged candidates an image at 640 px) through the NMS kernel,
  bit-equal to the plain version; CoordAtt and CoordCrossAtt against the CPU;
- RT-DETR (phase rtdetr): rtdetr-l, -x, -resnet50, -resnet101 and
  yolov8l-rtdetr built and run once in bf16; rtdetr-l's ``preds`` on the
  card against the CPU (float32, the decoder on the CPU's queries, the
  card's own top-k held to near-ties), ``YOLO.predict`` at B=16 in bf16 (no
  stem, no NMS: the decoder's queries are the detections) with one batch
  under torch.profiler, ``YOLO.val`` on 16 PNG images and a two-step
  ``YOLO.train`` with the denoising groups and the Hungarian matching;
- YOLO-World and YOLOE (phase world): the six open-vocabulary YAMLs at s
  built and run once in bf16 with the hash text of 80 names bound;
  yolov8s-worldv2's and yoloe-11s's float32 ``preds`` and the CLIP text and
  vision towers on the card against the CPU; ``YOLOE.set_classes`` then
  ``YOLO.predict`` of yoloe-11s in bf16 at B=16 (the stem kernel once a
  batch with the text on the graph, held against its plain version, the
  kernel path's scores following the bound text; NMS once a batch, equal
  to the plain version) and of yolov8s-worldv2 (NMS only), each with one
  batch under torch.profiler; a visual-prompt predict (NMS once);
  ``YOLOWorld.val`` on 16 PNG images (NMS once a batch); and
  ``train_multimodal`` and ``train_visual_prompt`` for one epoch of two
  steps, the latter leaving every parameter outside SAVPE bit-equal, then
  each one's step timed alone on one batch;
- weights in (phase weights): an Ultralytics-layout ``.pt`` of yolo11s-fce
  (fp16 ``model``, fp32 ``ema``) opened by ``YOLO(path)`` on the card, its
  weights equal to the ``ema``, predicting in bf16 through the stem and NMS
  kernels; the committed JAX orbax checkpoint (``tests/fixtures``) read
  without orbax, zstd through ``csrc/zstd.cu``'s host C++ byte-equal to the
  Python decoder, predicting within a stated bound of JAX's stored
  predictions; the C++ and Python decoders' MB/s;
- the command line (phase cli): ``python -m fce_yolo_tpu_torch checks`` in
  a process of its own naming the card; ``entrypoint`` with no ``device=``
  (so the card) for ``detect train`` (1 epoch on the 64 JPEGs), ``val`` and
  ``predict`` with every save of its ``best`` (the NMS kernel held against
  its plain version on a val batch), ``benchmark`` (the native bf16 row:
  the stem and NMS kernels once a batch, the stem held on its first batch;
  the ``torch_export`` row timed, the TensorFlow rows FAILED) and ``track
  ... save=True`` on the short AVI; ``YOLO.tune`` of 2 one-epoch runs, each
  watched to its end; every mode's launches exact;
- deployment (phase deploy): ``InferenceServer`` of the bf16 model answering
  16 JPEG images over ``RemoteModel`` and a raw socket at once (rows equal
  to ``YOLO.predict``'s, the stem and NMS kernels once a request);
  ``YOLO.export`` as a ``torch_export`` program at B=16 without and with
  NMS, read back by ``AutoBackend`` on the card (preds against the eager
  model, the NMS kernel launched from inside the program through its
  custom op and bit-equal to the plain version), as the ``native`` artifact
  run by ``fy_infer`` (built by g++; raw preds against the card's, image
  mode's rows against ``YOLO.predict``'s) and from the command line.

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
TRAIN_EPOCHS = 2  # phase train (b): YOLO.train on the 64 val images as both splits; best and last may differ
JPEG_TRAIN_EPOCHS = 1  # phase jpeg (f): YOLO.train on the 64 JPEGs as both splits (one epoch for the time limit)
TRAIN_TOL = 1e-3  # phase train (a), card vs CPU: loss parts, relative; updates, of the largest update
ABLATION_SCALE = "s"  # phase experiments: every variant at full width and depth
ABLATION_IMAGES = 16  # phase experiments: the first val images as both splits, 1 step and 1 val batch a stage
FAMILY_IMAGES = 16  # phase families (d), (e) and v10 (d): the first val images (both splits for (e)), 1 batch
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


class figure_times:
    """Within the block, time each call of ``module``'s functions ``names``
    (figure writers returning a path) and keep {file name: ms} in ``ms``."""

    def __init__(self, module, names: tuple[str, ...]):
        self.module, self.names, self.ms = module, names, {}

    def __enter__(self):
        self.real = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.real.items():
            def timed(*a, _fn=fn, _n=n, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                key = Path(str(out)).name if out else _n
                while key in self.ms:
                    key += "'"
                self.ms[key] = (time.perf_counter() - t0) * 1e3
                return out
            setattr(self.module, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def read_figure(path: Path, size: tuple[int, int] | None = None) -> tuple[int, int]:
    """Read a written PNG back through the port's reader; check its (width,
    height) against ``size`` when given. Returns it."""
    from fce_yolo_tpu_torch.data.imread import imread

    img = imread(path, device="cuda")
    got = (img.shape[1], img.shape[0])
    check(img.ndim == 3 and img.dtype == np.uint8 and (size is None or got == size),
          f"{path.name}: read back as {img.dtype} {img.shape}, expected {size}")
    return got


class PhaseClock:
    """Seconds between calls, by the name given at each call: ``main``'s phases."""

    def __init__(self):
        self.t, self.secs = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.secs[name] = round(now - self.t, 1)
        self.t = now


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the kernel's name in the record."""
    from fce_yolo_tpu_torch.data import jpeg, jpeg_write, webp
    from fce_yolo_tpu_torch.ops import nms, stem

    return {"fused_stem": stem.fused_stem, "pick_suppress": nms.pick_suppress, "jpeg_idct": jpeg.jpeg_idct,
            "jpeg_color": jpeg.jpeg_color, "jpeg_fdct": jpeg_write.jpeg_fdct, "webp_color": webp.webp_color}


def reset_launches() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def no_jpeg(**launches) -> dict:
    """The launches a path that reads no JPEG and no lossy WebP should show
    (and writes no JPEG unless ``jpeg_fdct`` is given)."""
    return {"jpeg_fdct": 0, **launches, "jpeg_idct": 0, "jpeg_color": 0, "webp_color": 0}


def train_plots(steps: int) -> int:
    """The JPEGs one ``YOLO.train`` writes by default: a mosaic of each of
    the first epoch's first three batches (``train_batch0..2.jpg``)."""
    return min(3, steps)


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


def time_stem(model, spec, batch: int, card: str, what: str, x: torch.Tensor | None = None,
              phase: str = "stem") -> dict:
    """Check the kernel on ``x`` (a uint8 NHWC batch on the card; a seeded
    one when None), then time it beside its plain version and the unfused
    bf16 layers 0-2 (cuDNN, what the predictor runs without the kernel) on
    the same batch."""
    from fce_yolo_tpu_torch.ops.stem import fold_stem_params, fused_stem, stem_reference, stem_weights

    if x is None:
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randint(0, 256, (batch, spec.H, spec.W, 3), np.uint8)).cuda()
    weights = stem_weights(fold_stem_params(model, spec), spec)
    dmax, rel, spread = check_stem(x, weights, spec, f"phase {phase} {what} B={batch}")
    x_nchw = (x.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    stem_layers = torch.nn.Sequential(*model.model[:3])
    with torch.inference_mode():
        ms = cuda_ms(lambda: fused_stem(x, weights, spec))
        plain_ms = cuda_ms(lambda: stem_reference(x, weights.arrays, spec), iters=3, warmup=1)
        layers_ms = cuda_ms(lambda: stem_layers(x_nchw))
        ms2 = cuda_ms(lambda: fused_stem(x, weights, spec))  # kernel, cuDNN, kernel: one spread
    bound_ms, bound_by = stem_bound(spec, batch)
    print(f"phase {phase}: {what} {spec} B={batch} max|d|/max|ref|={rel:.3e} (limit 0.02) "
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


def letterboxed(imgs: list[np.ndarray]) -> torch.Tensor:
    """The predictor's uint8 RGB NHWC batch of ``imgs`` (letterbox, BGR -> RGB) on the card."""
    from fce_yolo_tpu_torch.data.augment import letterbox

    return torch.from_numpy(np.stack([np.ascontiguousarray(letterbox(im, IMGSZ, scaleup=False)[0][..., ::-1])
                                      for im in imgs])).cuda()


def phase_e2e(yolo, spec, card: str) -> tuple[dict, float]:
    """``YOLO.predict`` of the bf16 model at B=16 on arrays, the stem held
    on the fed batch, the kernel path against the plain path; the device
    path timed at B=16 and B=64. Returns (launches, img/s through predict)."""
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.ops.nms import batched_nms
    from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, stem_weights

    imgs = e2e_images(SEED + 1, E2E_BATCHES)
    yolo.predict(imgs[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    results = yolo.predict(imgs, imgsz=IMGSZ, batch=E2E_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    check(len(results) == len(imgs), f"{len(results)} results for {len(imgs)} images")
    for r, img in zip(results, imgs):
        check(len(r) <= MAX_DET, f"{len(r)} > max_det detections")
        check(bool(np.isfinite(r.boxes.data).all()), "non-finite boxes")
        h, w = img.shape[:2]
        xyxy = r.boxes.xyxy
        check(bool(((xyxy >= 0) & (xyxy <= np.array([w, h, w, h]))).all()), "boxes outside the image")
    check(launches["fused_stem"] > 0 and launches["pick_suppress"] > 0 and launches["jpeg_idct"] == 0,
          f"main path skipped a kernel: {launches}")

    # the first batch as the predictor built it (letterbox, BGR -> RGB), on the same folded bf16 model
    model = yolo.model
    batch = letterboxed(imgs[:E2E_BATCH])
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
    return launches, len(imgs) / wall


def _png_filtered(x: np.ndarray, bpp: int) -> np.ndarray:
    """Rows (H, stride) of samples as bytes -> (H, 1 + stride) filtered rows:
    row r takes filter r % 5 (None, Sub, Up, Average, Paeth)."""
    h = x.shape[0]
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])  # (5, H, stride)
    kind = np.arange(h) % 5
    rows = (x - preds[kind, np.arange(h)]) & 255
    return np.concatenate([kind[:, None], rows], 1).astype(np.uint8)


def png_bytes(rgb: np.ndarray, depth: int = 8, interlace: bool = False) -> bytes:
    """An RGB PNG of ``rgb`` (H, W, 3) uint8 written with zlib: 8 bits a
    sample, or 16 (``depth=16``: the sample is the high byte, the low byte is
    noise a reader drops); Adam7-interlaced with ``interlace``. Row r of
    each pass takes filter r % 5 (None, Sub, Up, Average, Paeth), so the
    reader meets all five."""
    h, w, _ = rgb.shape
    if depth == 16:
        low = np.random.RandomState(h * w).randint(0, 256, rgb.shape)
        rgb = ((rgb.astype(np.uint16) << 8) | low.astype(np.uint16)).astype(">u2")
    bpp = 3 * depth // 8
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)) \
        if interlace else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = rgb[y0::dy, x0::dx]
        if sub.size:  # an empty pass has no rows
            raw += _png_filtered(sub.reshape(sub.shape[0], -1).view(np.uint8), bpp).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def bmp_bytes(rgb: np.ndarray, kind: str = "24") -> bytes:
    """A bottom-up BMP (BITMAPINFOHEADER) of ``rgb`` (H, W, 3) uint8:
    ``kind`` "24" (BGR), "8" (a palette of the image's colours, at most 256)
    or "rle8" (that palette, RLE8: runs of 3 or more as encoded runs, other
    stretches as absolute runs, a run of 4 or more of palette entry 0 inside
    a row as a delta, each row ended by an end of line, the last by end of
    bitmap)."""
    h, w, _ = rgb.shape
    bgr = rgb[::-1, :, ::-1]  # file rows bottom-up
    if kind == "24":
        pitch = (3 * w + 3) & -4
        rows = np.zeros((h, pitch), np.uint8)
        rows[:, : 3 * w] = bgr.reshape(h, 3 * w)
        pixels, palette, bpp, comp = rows.tobytes(), b"", 24, 0
    else:
        colours, idx = np.unique(bgr.reshape(-1, 3), axis=0, return_inverse=True)
        idx = idx.reshape(h, w).astype(np.uint8)
        palette = np.concatenate([colours, np.zeros((len(colours), 1), np.uint8)], 1).astype(np.uint8).tobytes()
        bpp = 8
        if kind == "8":
            pitch = (w + 3) & -4
            rows = np.zeros((h, pitch), np.uint8)
            rows[:, :w] = idx
            pixels, comp = rows.tobytes(), 0
        else:
            pixels, comp = _rle8(idx), 1
    size = 40
    offset = 14 + size + len(palette)
    header = struct.pack("<IiiHHIIiiII", size, w, h, 1, bpp, comp, len(pixels), 2835, 2835,
                         len(palette) // 4, 0)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + header + palette + pixels


def _rle8(idx: np.ndarray) -> bytes:
    """RLE8 of palette indices (H, W), file rows in order (see ``bmp_bytes``)."""
    out = bytearray()
    h = idx.shape[0]
    for r, row in enumerate(idx):
        edges = np.flatnonzero(np.diff(row.astype(np.int16))) + 1
        starts, ends = np.r_[0, edges], np.r_[edges, len(row)]
        single = []  # a stretch of short runs waiting to go out as one absolute run

        def flush():
            while single:
                part, single[:] = single[:255], single[255:]
                if len(part) < 3:  # an absolute run takes 3 or more
                    for v in part:
                        out.extend((1, v))
                else:
                    out.extend((0, len(part), *part, *([0] * (len(part) & 1))))

        for s, e in zip(starts.tolist(), ends.tolist()):
            v, n = int(row[s]), e - s
            if n >= 3:
                flush()
                if v == 0 and n >= 4 and e < len(row):  # a delta that reached the row's end would move to the next
                    while n:                             # row, and the end of line after it would skip a row
                        out.extend((0, 2, min(n, 255), 0))
                        n -= min(n, 255)
                while n:
                    out.extend((min(n, 255), v))
                    n -= min(n, 255)
            else:
                single.extend([v] * n)
        flush()
        out.extend((0, 1 if r == h - 1 else 0))
    return bytes(out)


TIFF_TYPES = {"B": 1, "H": 3, "I": 4, "Q": 16}  # struct code -> TIFF field type (BYTE, SHORT, LONG, LONG8)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB first, code width raised one code early, a clear code
    first and whenever the table fills, EOI last)."""
    codes, table, nxt, w = [256], {}, 258, -1
    for b in data:
        if w < 0:
            w = b
            continue
        k = (w << 8) | b
        c = table.get(k)
        if c is not None:
            w = c
            continue
        codes.append(w)
        table[k] = nxt
        nxt += 1
        w = b
        if nxt == 4093:
            codes.append(256)
            table, nxt = {}, 258
    if w >= 0:
        codes.append(w)
    codes.append(257)
    codes = np.array(codes, np.int64)
    # the decoder's width for each code: it adds an entry for every code after the first since a clear
    i = np.arange(len(codes))
    last_clear = np.r_[-1, np.maximum.accumulate(np.where(codes == 256, i, -1))[:-1]]
    free = 258 + np.maximum(i - last_clear - 2, 0)
    width = 9 + (free >= 511) + (free >= 1023) + (free >= 2047)
    at = np.arange(int(width.sum())) - np.repeat(np.cumsum(width) - width, width)  # bit within its code
    bits = (np.repeat(codes, width) >> (np.repeat(width, width) - 1 - at)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def tiff_packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeat packets, the rest as literal packets (128 at most each)."""
    a = np.frombuffer(data, np.uint8)
    edges = np.flatnonzero(np.diff(a.astype(np.int16))) + 1
    out, lit = bytearray(), bytearray()

    def flush():
        for i in range(0, len(lit), 128):
            part = lit[i: i + 128]
            out.append(len(part) - 1)
            out.extend(part)
        lit.clear()

    for s, e in zip(np.r_[0, edges].tolist(), np.r_[edges, len(a)].tolist()):
        if e - s >= 3:
            flush()
            for i in range(s, e, 128):
                out.extend((257 - min(128, e - i), int(a[s])))
        else:
            lit.extend(a[s:e].tobytes())
    flush()
    return bytes(out)


def tiff16(rgb: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """8-bit samples as 16-bit ones that libtiff rounds back to them: v * 257 + d, |d| <= 128."""
    return np.clip(rgb.astype(np.int64) * 257 + rng.randint(-128, 129, rgb.shape), 0, 65535).astype(np.uint16)


def tiff_bytes(img: np.ndarray, compression: int = 1, predictor: int = 1, tile: tuple[int, int] | None = None,
               rows_per_strip: int | None = None, big_endian: bool = False, bigtiff: bool = False,
               photometric: int | None = None, bits: int | None = None, palette: np.ndarray | None = None,
               orientation: int | None = None, extra_samples: int | None = None, planar: int = 1,
               tags: dict | None = None, pages: int = 1) -> bytes:
    """A TIFF of ``img``: (H, W) or (H, W, C) uint8 or uint16 (C samples a
    pixel, RGB order), in strips of ``rows_per_strip`` rows (default 16) or
    tiles of ``tile`` (height, width), edge tiles padded; ``compression`` 1
    (none), 5 (LZW), 8 or 32946 (Deflate) or 32773 (PackBits);
    ``predictor`` 2: horizontal differencing. ``bits`` below 8 packs the
    samples MSB first, each row to a byte. ``photometric`` defaults to 1
    (BlackIsZero) for one sample, else 2 (RGB); ``palette`` (2^bits, 3)
    uint16 makes it 3. ``planar`` 2 stores each sample in planes of its own.
    ``tags`` adds {tag: (struct code, values)}; ``pages`` repeats the image
    in a chain of IFDs (each later page inverted)."""
    e = ">" if big_endian else "<"
    img = img if img.ndim == 3 else img[..., None]
    h, w, spp = img.shape
    bits = bits or 8 * img.dtype.itemsize
    photometric = photometric if photometric is not None else (3 if palette is not None else 1 if spp == 1 else 2)
    th, tw = tile if tile else (rows_per_strip or 16, w)

    def block(a: np.ndarray) -> bytes:  # one strip or tile: (rows, cols, samples) -> its stored bytes
        rows, cols, n = a.shape
        x = a.reshape(rows, cols * n)
        if predictor == 2:
            d = x.astype(np.int64)
            d[:, n:] -= x[:, :-n].astype(np.int64)
            x = (d & (0xFFFF if bits == 16 else 0xFF)).astype(x.dtype)
        if bits < 8:
            x = np.packbits(np.unpackbits(x.astype(np.uint8)[..., None], axis=2)[..., 8 - bits:].reshape(rows, -1), 1)
        raw = x.astype(e + ("u2" if bits == 16 else "u1")).tobytes()
        if compression == 5:
            return tiff_lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            return tiff_packbits(raw)
        return raw

    def blocks(a: np.ndarray) -> list[bytes]:  # every strip or tile of every plane, in order
        out = []
        for p in ([a[..., i: i + 1] for i in range(spp)] if planar == 2 else [a]):
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    part = p[y: y + th, x: x + tw]
                    if tile:
                        part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1]), (0, 0)))
                    out.append(block(part))
        return out

    off_code = "Q" if bigtiff else "I"
    out = bytearray((b"MM" if big_endian else b"II") + (struct.pack(e + "HHHQ", 43, 8, 0, 16) if bigtiff
                                                        else struct.pack(e + "HI", 42, 8)))
    first_ifd_at = len(out) - (8 if bigtiff else 4)
    prev_link = first_ifd_at
    for page in range(pages):
        a = img if page == 0 else (~img if img.dtype == np.uint16 else (255 - img).astype(img.dtype))
        data = blocks(a)
        offsets = []
        for d in data:
            offsets.append(len(out))
            out += d + b"\0" * (len(d) & 1)
        entries = {256: ("I", [w]), 257: ("I", [h]), 258: ("H", [bits] * spp), 259: ("H", [compression]),
                   262: ("H", [photometric]), 277: ("H", [spp]), 284: ("H", [planar])}
        entries.update({322: ("I", [tw]), 323: ("I", [th]), 324: (off_code, offsets),
                        325: (off_code, [len(d) for d in data])} if tile else
                       {273: (off_code, offsets), 278: ("I", [th]), 279: (off_code, [len(d) for d in data])})
        if predictor != 1:
            entries[317] = ("H", [predictor])
        if palette is not None:
            entries[320] = ("H", np.asarray(palette, np.int64).T.ravel().tolist())
        if orientation is not None:
            entries[274] = ("H", [orientation])
        if extra_samples is not None:
            entries[338] = ("H", [extra_samples])
        entries.update(tags or {})
        ifd_at = len(out)
        struct.pack_into(e + off_code, out, prev_link, ifd_at)
        slot = 8 if bigtiff else 4
        body = struct.pack(e + ("Q" if bigtiff else "H"), len(entries))
        extra = bytearray()
        extra_at = ifd_at + len(body) + len(entries) * (20 if bigtiff else 12) + slot
        for tag in sorted(entries):
            code, values = entries[tag]
            raw = struct.pack(e + code * len(values), *values)
            count = len(values)
            if code == "B":
                count = len(raw)
            if len(raw) <= slot:
                field = raw + b"\0" * (slot - len(raw))
            else:
                field = struct.pack(e + off_code, extra_at + len(extra))
                extra += raw + b"\0" * (len(raw) & 1)
            body += struct.pack(e + ("HHQ" if bigtiff else "HHI"), tag, TIFF_TYPES[code], count) + field
        prev_link = ifd_at + len(body)
        out += body + b"\0" * slot + extra
    return bytes(out)


# Annex K tables, natural order
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
JPEG_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)
# (bits, values) of the four Annex K Huffman tables: DC luma, DC chroma, AC luma, AC chroma
JPEG_HUFFMAN = {
    "dc0": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc1": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac0": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
        "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a929394"
        "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
        "e9eaf1f2f3f4f5f6f7f8f9fa")),
    "ac1": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a2627"
        "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6"
        "e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}
JPEG_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}  # luma (h, v)
JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])


def _huffman_codes(bits, values) -> tuple[np.ndarray, np.ndarray]:
    """Symbol -> (code, length) arrays of 256 from a table's (bits, values)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _jpeg_blocks(plane: np.ndarray, bh: int, bw: int, q: np.ndarray) -> np.ndarray:
    """A plane (edge-padded to bh x bw blocks) -> quantised DCT coefficients (bh, bw, 64), natural order."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128.0, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    n = np.arange(8)
    c = np.sqrt(np.where(n == 0, 1.0, 2.0) / 8)[:, None] * np.cos((2 * n[None] + 1) * n[:, None] * np.pi / 16)
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ui,abij,vj->abuv", c, blocks, c).reshape(bh, bw, 64)
    return np.clip(np.round(coef / q), -1023, 1023).astype(np.int64)


def _jpeg_scan(comps: list[tuple[np.ndarray, int]], restart: int) -> bytes:
    """One scan's entropy-coded bytes: ``comps`` holds each component's
    quantised coefficients in scan order (n_mcu, blocks an MCU, 64) and its
    table id; a restart marker every ``restart`` MCUs."""
    n_mcu = comps[0][0].shape[0]
    coef = np.concatenate([c for c, _ in comps], axis=1)  # (n_mcu, blocks an MCU, 64)
    slot_table = np.concatenate([np.full(c.shape[1], t) for c, t in comps])
    slot_comp = np.concatenate([np.full(c.shape[1], i) for i, (c, _) in enumerate(comps)])
    per = coef.shape[1]
    zz = coef[:, :, JPEG_ZIGZAG].reshape(n_mcu * per, 64)
    nblk = zz.shape[0]
    blk_mcu = np.repeat(np.arange(n_mcu), per)
    blk_table = np.tile(slot_table, n_mcu)
    blk_comp = np.tile(slot_comp, n_mcu)
    interval = blk_mcu // restart if restart else np.zeros(nblk, np.int64)
    # DC differences per component, the prediction reset at each restart interval
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for ci in range(len(comps)):
        sel = np.flatnonzero(blk_comp == ci)
        d = dc[sel]
        prev = np.concatenate([[0], d[:-1]])
        first = np.concatenate([[True], interval[sel][1:] != interval[sel][:-1]])
        diff[sel] = d - np.where(first, 0, prev)
    codes = {k: _huffman_codes(*v) for k, v in JPEG_HUFFMAN.items()}

    def size_bits(v):
        s = np.zeros_like(v)
        a = np.abs(v)
        nz = a > 0
        s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        return s, np.where(v < 0, v + (1 << s) - 1, v)

    toks_blk, toks_slot, toks_val, toks_len = [], [], [], []

    def emit(blk, slot, val, length):
        toks_blk.append(blk)
        toks_slot.append(slot)
        toks_val.append(val)
        toks_len.append(length)

    s, extra = size_bits(diff)
    for t in (0, 1):
        sel = blk_table == t
        code, ln = codes[f"dc{t}"]
        emit(np.flatnonzero(sel), np.zeros(sel.sum(), np.int64), code[s[sel]], ln[s[sel]])
    emit(np.arange(nblk), np.ones(nblk, np.int64), extra, s)
    bi, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev_k = np.concatenate([[0], k[:-1]])
    prev_k[np.concatenate([[True], bi[1:] != bi[:-1]])] = 0
    run = k - prev_k - 1
    v = zz[bi, k]
    s, extra = size_bits(v)
    sym = (run % 16) * 16 + s
    n_zrl = run // 16
    zb = np.repeat(bi, n_zrl)
    zk = np.repeat(k, n_zrl)
    last = np.full(nblk, 0)
    last[bi] = k  # the last non-zero position of each block (k ascending within a block)
    eob = np.flatnonzero(last != 63)
    for t in (0, 1):
        code, ln = codes[f"ac{t}"]
        sel = blk_table[zb] == t
        emit(zb[sel], 4 * zk[sel], np.full(sel.sum(), code[0xF0]), np.full(sel.sum(), ln[0xF0]))
        sel = blk_table[bi] == t
        emit(bi[sel], 4 * k[sel] + 2, code[sym[sel]], ln[sym[sel]])
        sel = blk_table[eob] == t
        emit(eob[sel], np.full(sel.sum(), 1000), np.full(sel.sum(), code[0]), np.full(sel.sum(), ln[0]))
    emit(bi, 4 * k + 3, extra, s)
    blk, slot, val, length = (np.concatenate(a).astype(np.int64) for a in (toks_blk, toks_slot, toks_val, toks_len))
    order = np.lexsort((slot, blk))
    blk, val, length = blk[order], val[order], length[order]
    return _jpeg_pack(val, length, interval[blk], int(interval[-1]) + 1, restart)


def jpeg_progressive_scans(ncomp: int) -> list[tuple[tuple[int, ...], int, int, int, int]]:
    """libjpeg's ``jpeg_simple_progression`` (jcparam.c): (components, Ss,
    Se, Ah, Al) of each scan, for YCbCr and for gray."""
    if ncomp == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    return [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0),
            ((0,), 1, 63, 1, 0)]


# every AC symbol: 254 codes of 8 bits, 2 of 9 (no code is all ones)
JPEG_AC_ALL = ([0] * 7 + [254, 2] + [0] * 7, bytes(range(256)))


def _jpeg_progressive(comps: list, restart: int, segment) -> bytes:
    """The scans of ``jpeg_progressive_scans`` as libjpeg's jcphuff codes
    them (DC first and refinement, AC first with EOB runs, AC refinement
    with correction bits buffered through EOB runs and ZRLs), each AC scan
    after a DHT of ``JPEG_AC_ALL`` in slot 0; the DC scans use the Annex K
    tables already defined. ``comps``: (MCU-padded plane (BH, BW, 64), table,
    own grid (rows, cols) of blocks, (v, h) factors) each. A Python loop
    over blocks: ~1 s a 480 x 640 image on one core."""
    dc_codes = [_huffman_codes(*JPEG_HUFFMAN[f"dc{t}"]) for t in range(2)]
    ac_code, ac_len = (a.tolist() for a in _huffman_codes(*JPEG_AC_ALL))
    zigzag = [c[0][..., JPEG_ZIGZAG].tolist() for c in comps]  # (BH, BW, 64) nested lists, zig-zag order
    out = b""
    for sel, ss, se, ah, al in jpeg_progressive_scans(len(comps)):
        vals: list[int] = []
        lens: list[int] = []
        ends: list[int] = []  # token count at the end of each restart interval

        def put(v: int, n: int) -> None:
            if n:
                vals.append(v)
                lens.append(n)

        if len(sel) > 1:  # interleaved DC scan: MCUs of h x v blocks a component
            (bh0, bw0), (v0, h0) = comps[sel[0]][0].shape[:2], comps[sel[0]][3]
            my_n, mx_n = bh0 // v0, bw0 // h0
            units = [[(j, my * comps[i][3][0] + by, mx * comps[i][3][1] + bx) for j, i in enumerate(sel)
                      for by in range(comps[i][3][0]) for bx in range(comps[i][3][1])]
                     for my in range(my_n) for mx in range(mx_n)]
        else:
            rows, cols = comps[sel[0]][2]
            units = [[(0, by, bx)] for by in range(rows) for bx in range(cols)]
        last = [0] * len(sel)
        eobrun, be = 0, []  # the EOB run and its buffered correction bits

        def emit_eobrun() -> None:
            nonlocal eobrun
            if eobrun:
                nb = eobrun.bit_length() - 1
                put(ac_code[nb << 4], ac_len[nb << 4])
                put(eobrun & ((1 << nb) - 1), nb)
                for bit in be:
                    put(bit, 1)
                eobrun = 0
                be.clear()

        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                emit_eobrun()
                ends.append(len(vals))
                last = [0] * len(sel)
            for j, by, bx in unit:
                blk = zigzag[sel[j]][by][bx]
                if ss == 0:
                    v = blk[0] >> al
                    if ah:
                        put(v & 1, 1)
                        continue
                    d, last[j] = v - last[j], v
                    nb = abs(d).bit_length()
                    code, ln = dc_codes[comps[sel[j]][1]]
                    put(int(code[nb]), int(ln[nb]))
                    put(d if d >= 0 else d - 1 + (1 << nb), nb)
                    continue
                band = blk[ss: se + 1]
                if not ah:  # AC first
                    r = 0
                    for c in band:
                        a = abs(c) >> al
                        if not a:
                            r += 1
                            continue
                        emit_eobrun()
                        while r > 15:
                            put(ac_code[0xF0], ac_len[0xF0])
                            r -= 16
                        nb = a.bit_length()
                        put(ac_code[(r << 4) + nb], ac_len[(r << 4) + nb])
                        put(a if c >= 0 else (~a) & ((1 << nb) - 1), nb)
                        r = 0
                    if r:
                        eobrun += 1
                        if eobrun == 0x7FFF:
                            emit_eobrun()
                    continue
                absv = [abs(c) >> al for c in band]  # AC refinement
                eob = max((k for k, a in enumerate(absv) if a == 1), default=-1)
                r, br = 0, []
                for k, a in enumerate(absv):
                    if not a:
                        r += 1
                        continue
                    while r > 15 and k <= eob:
                        emit_eobrun()
                        put(ac_code[0xF0], ac_len[0xF0])
                        r -= 16
                        for bit in br:
                            put(bit, 1)
                        br = []
                    if a > 1:
                        br.append(a & 1)
                        continue
                    emit_eobrun()
                    put(ac_code[(r << 4) + 1], ac_len[(r << 4) + 1])
                    put(0 if band[k] < 0 else 1, 1)
                    for bit in br:
                        put(bit, 1)
                    br, r = [], 0
                if r or br:
                    eobrun += 1
                    be.extend(br)
                    if eobrun == 0x7FFF or len(be) > 1000 - 64 + 1:
                        emit_eobrun()
        emit_eobrun()
        ends.append(len(vals))
        interval = np.repeat(np.arange(len(ends)), np.diff(np.r_[0, ends]))
        data = _jpeg_pack(np.array(vals, np.int64), np.array(lens, np.int64), interval, len(ends), restart)
        head = b""
        if ss:
            bits_, values = JPEG_AC_ALL
            head = segment(0xC4, bytes([0x10]) + bytes(bits_) + values)
        sos = bytes([len(sel)]) + b"".join(bytes([i + 1, (min(i, 1) if ss == 0 else 0) * 16]) for i in sel)
        out += head + segment(0xDA, sos + bytes([ss, se, ah * 16 + al])) + data
    return out


def _jpeg_pack(val: np.ndarray, length: np.ndarray, tok_interval: np.ndarray, n_int: int, restart: int) -> bytes:
    """Tokens (value, bit length) in stream order -> entropy-coded bytes:
    each restart interval padded to a byte with 1 bits, FF stuffed, RSTn
    between intervals."""
    bits_per = np.bincount(tok_interval, weights=length, minlength=n_int).astype(np.int64)
    pad = (-bits_per) % 8
    ends = np.searchsorted(tok_interval, np.arange(n_int), side="right")
    val = np.insert(val, ends, (1 << pad) - 1)
    length = np.insert(length, ends, pad)
    tok = np.repeat(np.arange(len(length)), length)
    start = np.cumsum(length) - length
    pos = np.arange(int(length.sum())) - start[tok]
    bits = (val[tok] >> (length[tok] - 1 - pos)) & 1
    data = np.packbits(bits.astype(np.uint8))
    byte_ends = np.cumsum((bits_per + pad) // 8)
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0)  # byte stuffing
    byte_ends = byte_ends + np.searchsorted(ff, byte_ends, side="left")
    if restart and n_int > 1:
        at = np.repeat(byte_ends[:-1], 2)
        marks = np.stack([np.full(n_int - 1, 0xFF), 0xD0 + np.arange(n_int - 1) % 8], 1).ravel()
        data = np.insert(data, at, marks)
    return data.astype(np.uint8).tobytes()


def jpeg_bytes(img: np.ndarray, quality: int = 95, sampling: str = "420", restart: int = 0,
               orientation: int | None = None, interleave: bool = True, progressive: bool = False) -> bytes:
    """A baseline JPEG of ``img`` (RGB (H, W, 3) uint8, or gray (H, W)):
    libjpeg's quality scaling of the Annex K tables, the Annex K Huffman
    tables, ``sampling`` (444, 422, 420, 440 or 411: the luma's factors,
    the chroma box-averaged; a gray image's one component takes the luma's
    factors), a restart marker every ``restart`` MCUs, and an APP1 Exif
    block with ``orientation`` if one is given. ``interleave``: one scan of
    all components, else one scan each. A scan of one component (a gray
    image's, or each of ``interleave=False``) is non-interleaved: one block
    an MCU over the component's own block grid, ceil(width / 8) x
    ceil(height / 8). Vectorised: no Python loop over blocks.
    ``progressive``: the same quantised coefficients in a progressive file
    (SOF2) instead, in the scans of libjpeg's ``jpeg_simple_progression``
    (``jpeg_progressive_scans``), ``interleave`` ignored."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tables = [np.clip((t * scale + 50) // 100, 1, 255) for t in (JPEG_LUMA_Q, JPEG_CHROMA_Q)]
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, factors = [img.astype(np.float64)], [JPEG_SAMPLING[sampling]]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        planes = [y, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b, 128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
        factors = [JPEG_SAMPLING[sampling], (1, 1), (1, 1)]
    hmax, vmax = factors[0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    alone = len(planes) == 1 or not interleave
    comps = []  # (coefficients in scan order (n_mcu, blocks an MCU, 64), table id)
    for i, (p, (fh, fv)) in enumerate(zip(planes, factors)):
        sh, sv = hmax // fh, vmax // fv
        ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
        p = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
        p = p.reshape(ph // sv, sv, pw // sh, sh).mean(axis=(1, 3))  # the component's real samples
        p = np.clip(np.round(p), 0, 255)
        if alone:
            bh, bw = -(-p.shape[0] // 8), -(-p.shape[1] // 8)
            coef = _jpeg_blocks(p, bh, bw, tables[min(i, 1)]).reshape(bh * bw, 1, 64)
        else:
            coef = _jpeg_blocks(p, mcuy * fv, mcux * fh, tables[min(i, 1)])
            coef = coef.reshape(mcuy, fv, mcux, fh, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, fv * fh, 64)
        comps.append((coef, min(i, 1)))
        if progressive:  # the component's MCU-padded plane; the blocks of its own grid are the baseline's
            plane = _jpeg_blocks(p, mcuy * fv, mcux * fh, tables[min(i, 1)])
            if alone:
                bh, bw = -(-p.shape[0] // 8), -(-p.shape[1] // 8)
                plane[bh:], plane[:, bw:] = 0, 0
            comps[-1] = (plane, min(i, 1), (-(-p.shape[0] // 8), -(-p.shape[1] // 8)), (fv, fh))

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8"
    if orientation is not None:
        tiff = b"MM\x00\x2a" + struct.pack(">IH", 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4
        out += segment(0xE1, b"Exif\x00\x00" + tiff)
    n_tables = 1 if len(comps) == 1 else 2
    out += segment(0xDB, b"".join(bytes([t]) + tables[t][JPEG_ZIGZAG].astype(np.uint8).tobytes()
                                  for t in range(n_tables)))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for i, (fh, fv) in enumerate(factors):
        sof += bytes([i + 1, fh * 16 + fv, min(i, 1)])
    out += segment(0xC2 if progressive else 0xC0, sof)
    for t in range(n_tables):
        for kind, cls in (("dc", 0), ("ac", 1)):
            bits_, values = JPEG_HUFFMAN[f"{kind}{t}"]
            out += segment(0xC4, bytes([cls * 16 + t]) + bytes(bits_) + bytes(values))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    if progressive:
        return out + _jpeg_progressive(comps, restart, segment) + b"\xff\xd9"
    for scan in ([[i] for i in range(len(comps))] if alone else [list(range(len(comps)))]):
        sos = bytes([len(scan)]) + b"".join(bytes([i + 1, min(i, 1) * 17]) for i in scan) + b"\x00\x3f\x00"
        out += segment(0xDA, sos) + _jpeg_scan([comps[i] for i in scan], restart)
    return out + b"\xff\xd9"


def strip_dht(buf: bytes) -> bytes:
    """A JPEG with its DHT segments taken out, as Motion-JPEG (AVI1) frames
    come: a decoder takes the Annex K.3 tables, which ``jpeg_bytes`` uses."""
    out, pos = bytearray(buf[:2]), 2
    while buf[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", buf[pos + 2: pos + 4])[0]
        if buf[pos + 1] != 0xC4:
            out += buf[pos:end]
        pos = end
    return bytes(out + buf[pos:])


def avi_bytes(frames: list, width: int, height: int, fps: int = 30, fourcc: bytes = b"MJPG",
              index: bool = True) -> bytes:
    """A Motion-JPEG AVI of one video stream: ``frames`` holds each frame's
    JPEG bytes (one ``00dc`` chunk; b"" is a dropped frame) or a list of
    them (one ``LIST rec `` group); an odd-sized chunk is followed by its pad
    byte; ``idx1`` indexes the chunks when ``index``."""
    def chunk(tag: bytes, body: bytes) -> bytes:
        return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    def listed(kind: bytes, body: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body

    n = sum(len(f) if isinstance(f, list) else 1 for f in frames)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10 if index else 0, n, 0, 1, 0, width, height, 0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, 0, 0xFFFFFFFF, 0, 0, 0,
                                          width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc, width * height * 3, 0, 0, 0, 0)
    hdrl = listed(b"hdrl", chunk(b"avih", avih) + listed(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, entries = b"", []
    for f in frames:
        group = f if isinstance(f, list) else [f]
        at = len(movi) + (16 if isinstance(f, list) else 4)  # idx1 offsets count from the 'movi' tag
        body = b""
        for frame in group:
            entries.append(b"00dc" + struct.pack("<III", 0x10, at + len(body), len(frame)))
            body += chunk(b"00dc", frame)
        movi += listed(b"rec ", body) if isinstance(f, list) else body
    out = hdrl + listed(b"movi", movi) + (chunk(b"idx1", b"".join(entries)) if index else b"")
    return b"RIFF" + struct.pack("<I", len(out) + 4) + b"AVI " + out


def val_images():
    """tests/conftest.py's tiny dataset at full size: VAL_IMAGES RGB images of
    480-800 px a side, grey with 1-3 solid rectangles of classes 0-2, each
    with its label lines."""
    rng = np.random.RandomState(SEED + 3)
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
        yield i, img, lines


def write_val_dataset(root: Path, kind: str = "png") -> str:
    """``val_images`` under ``root`` as PNG (``png_bytes``) or as baseline
    JPEG (``jpeg_bytes``, q95 4:2:0), with their labels; the data YAML names
    VAL_NC classes."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i, img, lines in val_images():
        data = png_bytes(img) if kind == "png" else jpeg_bytes(img, 95, "420")
        (root / "images" / "val" / f"{i:03d}.{kind}").write_bytes(data)
        (root / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n{names}")
    return str(root / "data.yaml")


def matching_model(yolo):
    """Seed-0 weights without the class prior, then so that some detections
    match the labels (mAP above zero): DFL bin 8 of every side up by 6 (boxes
    ~16 strides wide) and the labels' classes 0-2 up by 1 (scores ~0.73, the
    rest ~0.5), in both head sets of a v10 model."""
    from fce_yolo_tpu_torch.nn.model import init_weights

    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    head = yolo.model.detect
    with torch.no_grad():
        for branch in (*head.cv2, *getattr(head, "one2one_cv2", ())):
            branch[-1].bias[8::16] += 6.0
        for branch in (*head.cv3, *getattr(head, "one2one_cv3", ())):
            branch[-1].bias[:3] += 1.0
    return yolo


def same_outputs(a, b) -> bool:
    """Equal NMS outputs: dicts of arrays, or of lists of arrays (masks)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_outputs(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_outputs(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b))


def kernel_vs_plain(run, calls: list, k: int, iou: float, max_det: int, what: str) -> dict:
    """``run()`` (an NMS path to host arrays) with the NMS kernel, then again
    with its plain version swapped into ``ops.nms``; the kernel then runs on
    the candidates the plain pass saw, once the swap is undone (inside it,
    the kernel's wrapper would count on the swapped-in function). Checks the
    candidate count, idx/ok and every output of ``run`` equal; appends
    (candidates, plain (idx, ok)) to ``calls``; returns both passes' outputs."""
    from fce_yolo_tpu_torch.ops import nms as nms_ops

    real = nms_ops.pick_suppress

    def plain(boxes, scores, valid, iou_thres, max_det):
        out = nms_ops.pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)
        calls.append(((boxes.clone(), scores.clone(), valid.clone()), out))
        return out

    outs = {"kernel": run()}
    try:
        nms_ops.pick_suppress = plain
        outs["plain"] = run()
    finally:
        nms_ops.pick_suppress = real
    args, (ip, op) = calls[-1]
    ik, ok = real(*args, iou_thres=iou, max_det=max_det)
    check(args[0].shape[1] == k, f"{what}: NMS ran at K={args[0].shape[1]}, not {k}")
    mism = int((ik != ip).sum() + (ok != op).sum())
    check(mism == 0, f"{what}: NMS kernel differs from the plain version ({mism})")
    check(same_outputs(outs["kernel"], outs["plain"]), f"{what}: outputs differ between the kernel and the plain version")
    return outs


def nms_kernel_vs_plain(val, preds: torch.Tensor, calls: list) -> dict:
    """``val.nms(preds)`` through ``kernel_vs_plain`` at the validator's K:
    idx/ok and the ``batched_nms`` outputs equal; returns both as numpy."""
    return kernel_vs_plain(lambda: val.to_host(val.nms(preds)), calls, NMS_K_VAL, val.iou, val.max_det,
                           f"val batch {len(calls) + 1}")


def val_batches_vs_plain(yolo, data: str):
    """Every val batch of ``data`` again, outside ``YOLO.val``: forward, then
    ``nms_kernel_vs_plain`` (idx/ok equal), and P, R, mAP and the confusion
    matrix equal from the kernel's and the plain version's detections, mAP50
    above zero. Returns (validator, loader, per-batch NMS calls, the first
    LOSS_STEPS (batch, img, preds), metrics seconds, P/R/mAP)."""
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics

    val = DetectionValidator(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=VAL_BATCH)
    loader = val.get_dataloader(data)
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
    return val, loader, calls, kept_batches, metrics_s, mk


def phase_val(data: str, card: str) -> tuple[dict, dict, dict]:
    """``YOLO.val`` with the counts at 0, then each batch again with the NMS
    kernel and with its plain version on the same candidates: idx/ok equal,
    and P, R, mAP (above zero: the random head's boxes are widened and the
    labels' classes raised) equal through the same ``_update_metrics``. Returns (the
    val path's launches, the NMS kernel's val-path record, and the model
    with the first LOSS_STEPS batches for phase loss)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.ops import nms as nms_ops
    from fce_yolo_tpu_torch.ops.boxes import xywh2xyxy

    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))  # float32, the plain graph (as the JAX validator)
    with torch.inference_mode():  # cuDNN's first-call set-up, outside the timed run
        yolo.model.eval()(torch.zeros(VAL_BATCH, 3, IMGSZ, IMGSZ, device="cuda"))
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-VAL_IMAGES // VAL_BATCH)
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_batches),
          f"val path: {launches}, expected no stem, no JPEG and one NMS for each of {n_batches} batches")
    check(len(res["metrics"].stats["conf"]) == VAL_IMAGES, "val path scored the wrong number of images")

    val, loader, calls, kept_batches, metrics_s, mk = val_batches_vs_plain(yolo, data)
    real = nms_ops.pick_suppress

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
    png = {"img_s": VAL_IMAGES / wall, "loader_wait_ms": speed["preprocess"], "decode_ms": png_ms,
           "metrics": res["metrics"].mean_results()}
    return launches, record, {"yolo": yolo, "batches": [(b, im) for b, im, _ in kept_batches], "png": png}


def jpeg_test_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """RGB: ramps, a flat rectangle and noise, so the coefficients take every
    size and long zero runs."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 9 % 256], 2)
    img = img + rng.randint(-30, 31, img.shape)
    img[h // 4: h // 2, w // 4: w // 2] = (200, 40, 90)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_cases() -> list[tuple[str, bytes]]:
    """Phase jpeg (b)'s files: each sampling (444, 422, 420, 440, 411 and
    gray) at quality 50, 75, 95 and 100, cycling through 1x1, 7x9 and 17x33,
    restart intervals 0, 1 and 7 and EXIF orientations 1-8; then six at
    480x640 and 481x641; then non-interleaved scans of components sampled
    above 1x1: gray with 2x2 and 4x1 factors, and 4:2:0 and 4:1:1 with a
    scan per component ("sep"), up to 481x641."""
    rng = np.random.RandomState(SEED + 20)
    small, cases, i = [(1, 1), (7, 9), (17, 33)], [], 0
    for sampling in ("444", "422", "420", "440", "411", "gray"):
        for quality in (50, 75, 95, 100):
            (h, w), restart, orientation = small[i % 3], (0, 1, 7)[i // 3 % 3], 1 + i % 8
            cases.append((sampling, quality, restart, orientation, h, w))
            i += 1
    cases += [("420", 95, 0, None, 480, 640), ("422", 75, 7, 6, 481, 641), ("411", 50, 1, None, 481, 641),
              ("440", 100, 0, 3, 480, 640), ("444", 95, 1, None, 481, 641), ("gray", 75, 7, 8, 481, 641)]
    cases += [("gray420", 90, 0, None, 64, 64), ("gray411", 75, 7, 6, 17, 33), ("sep420", 90, 7, None, 17, 33),
              ("sep411", 95, 0, 5, 64, 64), ("sep420", 95, 1, None, 481, 641)]
    out = []
    for sampling, quality, restart, orientation, h, w in cases:
        img = jpeg_test_image(rng, h, w)
        factors = sampling[-3:] if sampling[-3:].isdigit() else "444"
        buf = jpeg_bytes(img[..., 0] if sampling.startswith("gray") else img, quality, factors, restart, orientation,
                         interleave=not sampling.startswith("sep"))
        out.append((f"{sampling} q{quality} {h}x{w} restart {restart} orientation {orientation}", buf))
    return out


def jpeg_bounds(info: np.ndarray) -> dict:
    """Least ms of each JPEG kernel on this image: bytes (int16 coefficients
    in and uint8 planes out; planes in and BGR out) at the HBM rate, against
    integer operations (~1200 a block for dequantisation and the two IDCT
    passes, ~45 a pixel for upsampling and colour) at the CUDA cores' f32
    rate (the table has no int32 rate). Returns {kernel: (ms, what bounds it)}."""
    total, pixels = int(info[7]), int(info[0]) * int(info[1])
    out = {}
    for name, nbytes, ops in (("jpeg_idct", 3 * total, 1200 * total // 64), ("jpeg_color", total + 3 * pixels, 45 * pixels)):
        ops_ms, bytes_ms = 1e3 * ops / F32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
        out[name] = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return out


def time_jpeg(buf: bytes, what: str, n: int, card: str, phase: str = "phase jpeg (c)") -> dict:
    """One image's decode on the card, split (host entropy decode, H2D, each
    kernel, D2H: CUDA events inside fce_jpeg_decode, mean of n); each kernel
    alone (CUDA graph) beside its plain version (numpy on the host, via the
    wrapper's CPU branch) and its bound; img/s with 1 and 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from fce_yolo_tpu_torch.data import jpeg as J

    split = np.zeros(5, np.float64)
    t = np.zeros(5, np.float32)
    J.decode_jpeg(buf, what, "cuda")  # warm: buffers and stream of this thread
    t0 = time.perf_counter()
    for _ in range(n):
        J.decode_jpeg(buf, what, "cuda", times=t)
        split += t
    call_ms = (time.perf_counter() - t0) * 1e3 / n
    split /= n
    info, planes, qt = J.jpeg_coefficients(buf, what)
    flat = torch.from_numpy(np.concatenate([p.ravel() for p in planes])).cuda()
    dev_planes = J.jpeg_idct(flat, qt, info)
    out = {"call_ms": call_ms, "split": split.tolist(), "bounds": jpeg_bounds(info)}
    out["jpeg_idct_ms"] = graph_ms(lambda: J.jpeg_idct(flat, qt, info))
    out["jpeg_color_ms"] = graph_ms(lambda: J.jpeg_color(dev_planes, info))
    cpu_coef, cpu_planes = flat.cpu(), dev_planes.cpu()
    for name, fn in (("jpeg_idct", lambda: J.jpeg_idct(cpu_coef, qt, info)),
                     ("jpeg_color", lambda: J.jpeg_color(cpu_planes, info))):
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        out[f"{name}_plain_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    copies = 4 * n
    for threads in (1, 8):
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda b: J.decode_jpeg(b, what, "cuda"), [buf] * threads))  # each thread's buffers
            t0 = time.perf_counter()
            list(pool.map(lambda b: J.decode_jpeg(b, what, "cuda"), [buf] * copies))
            out[f"img_s_{threads}"] = copies / (time.perf_counter() - t0)
    b = out["bounds"]
    print(f"{phase}: {what} ({len(buf)} bytes): decode_jpeg {call_ms:.3f} ms a call (host clock); split "
          f"(CUDA events, mean of {n}): host entropy decode {split[0]:.3f} ms, H2D {split[1]:.3f}, jpeg_idct "
          f"{split[2]:.4f}, jpeg_color {split[3]:.4f}, D2H {split[4]:.3f}; kernels alone (CUDA graph): jpeg_idct "
          f"{out['jpeg_idct_ms']:.4f} ms (bound {b['jpeg_idct'][0]:.4f}, {b['jpeg_idct'][1]}; plain "
          f"{out['jpeg_idct_plain_ms']:.1f} ms), jpeg_color {out['jpeg_color_ms']:.4f} ms (bound "
          f"{b['jpeg_color'][0]:.4f}, {b['jpeg_color'][1]}; plain {out['jpeg_color_plain_ms']:.1f} ms); "
          f"{out['img_s_1']:.1f} img/s on 1 thread, {out['img_s_8']:.1f} on 8 [{card}]", flush=True)
    return out


def phase_jpeg(root: Path, png: dict, card: str) -> tuple[dict, dict]:
    """JPEG reading on the card (the kernels of csrc/jpeg.cu):
    (b) ``decode_jpeg`` on the card equal to the plain path byte for byte on
    every file of ``jpeg_cases``; at 1080x1920 the two kernels against the
    plain stages on the C decoder's coefficients;
    (c) ``time_jpeg`` at 480x640 and 1080x1920, 4:2:0 q95;
    (d) ``YOLO.val`` (phase val's model and checks) on a q95 4:2:0 JPEG copy
    of phase val's images, the counts at 0: both JPEG kernels once an image,
    NMS once a batch and bit-equal to the plain version on each;
    (e) ``YOLO.predict`` (bf16, B=16) on the directory of those JPEGs, the
    counts at 0: stem and NMS once a batch, both JPEG kernels once an image;
    the paths, the images and the detections equal to a predict on the
    arrays the plain decoder gives for the same files;
    (f) ``YOLO.train`` (phase train's settings, JPEG_TRAIN_EPOCHS) on those
    JPEGs as both splits, the counts at 0: NMS once a val batch, both JPEG kernels at
    least once a train item and a val image; finite losses.
    Returns (launches by path, the JPEG kernels' records)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data import jpeg as J
    from fce_yolo_tpu_torch.data.dataset import YOLODataset
    from fce_yolo_tpu_torch.nn.model import init_weights

    t_phase = time.perf_counter()
    worst, n_cases = 0, 0
    for name, buf in jpeg_cases():
        out, ref = J.decode_jpeg(buf, name, "cuda"), J.decode_jpeg_reference(buf, name)
        check(out.shape == ref.shape, f"phase jpeg (b) {name}: shape {out.shape} vs the plain path's {ref.shape}")
        d = int(np.abs(out.astype(np.int16) - ref).max(initial=0))
        check(d == 0, f"phase jpeg (b) {name}: the kernel path differs from the plain path by up to {d}")
        worst, n_cases = max(worst, d), n_cases + 1
    big = jpeg_bytes(jpeg_test_image(np.random.RandomState(SEED + 21), 1080, 1920), 95, "420", 0)
    info, planes, qt = J.jpeg_coefficients(big, "1080x1920")
    hdr = J.header_from_info(info)
    ref_planes = [J.jpeg_idct_reference(p, qt[c]) for c, p in enumerate(planes)]
    dev_planes = J.jpeg_idct(torch.from_numpy(np.concatenate([p.ravel() for p in planes])).cuda(), qt, info)
    check(bool((dev_planes.cpu().numpy() == np.concatenate([p.ravel() for p in ref_planes])).all()),
          "phase jpeg (b) 1080x1920: jpeg_idct differs from jpeg_idct_reference")
    ref_bgr = J.jpeg_color_reference(ref_planes, hdr)
    check(bool((J.jpeg_color(dev_planes, info).cpu().numpy() == ref_bgr).all()),
          "phase jpeg (b) 1080x1920: jpeg_color differs from jpeg_color_reference")
    check(bool((J.decode_jpeg(big, "1080x1920", "cuda") == ref_bgr).all()),
          "phase jpeg (b) 1080x1920: decode_jpeg differs from the plain stages")
    print(f"phase jpeg (b): the kernel path equals the plain path byte for byte on {n_cases} files (every sampling "
          f"and gray, q50/75/95/100, restart 0/1/7, orientations 1-8, 1x1 to 481x641, gray at 2x2/4x1 and a scan per "
          f"component); at 1080x1920 4:2:0 q95 "
          f"jpeg_idct and jpeg_color equal the plain stages on the C decoder's coefficients [{card}]", flush=True)

    vga = jpeg_bytes(jpeg_test_image(np.random.RandomState(SEED + 22), 480, 640), 95, "420", 0)
    timed = {"480x640": time_jpeg(vga, "480x640 4:2:0 q95", 20, card),
             "1080x1920": time_jpeg(big, "1080x1920 4:2:0 q95", 10, card)}

    data = write_val_dataset(root / "jpeg", "jpg")
    n_batches = -(-VAL_IMAGES // VAL_BATCH)
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))  # phase val's model, float32
    with torch.inference_mode():
        yolo.model.eval()(torch.zeros(VAL_BATCH, 3, IMGSZ, IMGSZ, device="cuda"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    val_launches = read_launches()
    check(val_launches == {"fused_stem": 0, "pick_suppress": n_batches, "jpeg_fdct": 0, "webp_color": 0,
                           "jpeg_idct": VAL_IMAGES,
                           "jpeg_color": VAL_IMAGES}, f"val path on JPEG: launches {val_launches}")
    check(len(res["metrics"].stats["conf"]) == VAL_IMAGES, "val path on JPEG scored the wrong number of images")
    _, _, _, _, _, mk = val_batches_vs_plain(yolo, data)
    jpeg_metrics = {"metrics": res["metrics"].mean_results(), "img_s": VAL_IMAGES / wall}
    speed = res["metrics"].speed
    print(f"phase jpeg (d): YOLO.val yolo11s-fce {IMGSZ} f32 B={VAL_BATCH} on {VAL_IMAGES} JPEG images (q95 4:2:0, "
          f"480-800 px), launches {val_launches}; NMS kernel idx/ok equal to the plain version on every batch; "
          f"P/R/mAP50/mAP50-95 {tuple(round(v, 6) for v in mk)} equal from both; {VAL_IMAGES / wall:.1f} img/s "
          f"(PNG, phase val: {png['img_s']:.1f}); loader wait {speed['preprocess']:.2f} ms an image (PNG: "
          f"{png['loader_wait_ms']:.2f}); inference {speed['inference']:.2f} ms, metrics {speed['postprocess']:.2f} "
          f"ms an image [{card}]", flush=True)
    del yolo

    yolo = YOLO("yolo11s-fce.yaml", device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()
    folder = root / "jpeg" / "images" / "val"
    files = sorted(str(f) for f in folder.iterdir())
    yolo.predict(files[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = yolo.predict(str(folder), imgsz=IMGSZ, batch=E2E_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    predict_launches = read_launches()
    n_pred = -(-VAL_IMAGES // E2E_BATCH)
    check(predict_launches == {"fused_stem": n_pred, "pick_suppress": n_pred, "jpeg_fdct": 0, "webp_color": 0,
                               "jpeg_idct": VAL_IMAGES,
                               "jpeg_color": VAL_IMAGES}, f"predict on JPEG files: launches {predict_launches}")
    check([r.path for r in results] == files, "predict on a directory: paths or order differ from the sorted files")
    arrays = [J.decode_jpeg_reference(Path(f).read_bytes(), f) for f in files]
    again = yolo.predict(arrays, imgsz=IMGSZ, batch=E2E_BATCH)
    dmax = 0.0
    for r, a, img in zip(results, again, arrays):
        check(bool((r.orig_img == img).all()), f"{r.path}: the kernel decode differs from the plain decode")
        check(len(r) == len(a) and bool((r.boxes.cls == a.boxes.cls).all()), f"{r.path}: detections differ")
        if len(r):
            dmax = max(dmax, float(np.abs(r.boxes.data - a.boxes.data).max()))
    check(dmax <= 1e-3, f"predict on JPEG files vs on the plain decoder's arrays: detections differ by {dmax}")
    n_det = sum(len(r) for r in results)
    print(f"phase jpeg (e): YOLO.predict yolo11s-fce {IMGSZ} bf16 B={E2E_BATCH} on the directory of {VAL_IMAGES} "
          f"JPEGs, launches {predict_launches}; paths in sorted order; images and {n_det} detections equal to a "
          f"predict on the plain decoder's arrays (max|d| {dmax:.1e}, limit 1e-3); {VAL_IMAGES / wall:.1f} img/s "
          f"through YOLO.predict (host clock, decode and letterbox included); phase jpeg {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)

    del yolo
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.train(train_data(root / "jpeg"), epochs=JPEG_TRAIN_EPOCHS, batch=VAL_BATCH, imgsz=IMGSZ,
                     project=str(root / "runs_jpeg"), verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = read_launches()
    decodes = train_launches["jpeg_idct"]
    check(train_launches["fused_stem"] == 0 and train_launches["pick_suppress"] == n_batches * JPEG_TRAIN_EPOCHS
          and train_launches["jpeg_color"] == decodes >= 2 * VAL_IMAGES * JPEG_TRAIN_EPOCHS
          and train_launches["jpeg_fdct"] == train_plots(n_batches),
          f"train on JPEG: launches {train_launches}, expected NMS once a val batch and a decode an image or more")
    check(all(np.isfinite(r["train/box_loss"]) for r in res["results"]), "train on JPEG: a loss is not finite")
    ds = YOLODataset(str(root / "jpeg" / "images" / "val"), imgsz=IMGSZ, mode="train", nc=VAL_NC, device="cuda")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for i in range(4):
        ds.get(i, rng)
    item_ms = (time.perf_counter() - t0) * 1e3 / 4
    print(f"phase jpeg (f): YOLO.train yolo11s-fce {IMGSZ} bf16 B={VAL_BATCH} AdamW, {JPEG_TRAIN_EPOCHS} epochs on the "
          f"{VAL_IMAGES} JPEGs as both splits, launches {train_launches}; " + "; ".join(
              f"epoch {sp['epoch'] + 1}: {sp['img_per_s']:.2f} img/s, loader wait {sp['loader_wait_ms']:.1f} ms a step, "
              f"step {sp['step_ms']:.1f} ms, val {sp['val_s']:.2f} s" for sp in res["speed"])
          + f"; {wall:.1f} s in all; one mosaic item (4 JPEG decodes on the card, resizes, warp, HSV, flip) "
          f"{item_ms:.1f} ms on one thread [{card}]", flush=True)
    del yolo

    main = timed["480x640"]
    records = {}
    for name in ("jpeg_idct", "jpeg_color"):
        bound_ms, bound_by = main["bounds"][name]
        records[name] = {"max_abs_err": float(worst), "ms": main[f"{name}_ms"], "plain_ms": main[f"{name}_plain_ms"],
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                         "ms_1080x1920": timed["1080x1920"][f"{name}_ms"],
                         "bound_ms_1080x1920": timed["1080x1920"]["bounds"][name][0]}
    return ({"val_jpeg": val_launches, "predict_jpeg": predict_launches, "train_jpeg": train_launches}, records,
            jpeg_metrics)


FORMAT_KINDS = ("bmp24", "tif", "png16", "adam7")  # phase formats (b): val image i written as kind i % 4
FORMAT_SUFFIX = {"bmp24": "bmp", "bmp8": "bmp", "rle8": "bmp", "tif": "tif", "tiles": "tiff", "tif16": "tif",
                 "tifraw": "tiff", "png16": "png", "adam7": "png", "adam7-16": "png", "pfm": "pfm", "dng": "dng",
                 "jpg": "jpg", "progressive": "jpg", "progressive-gray": "jpeg", "mpo": "mpo"}
FORMAT_RESTART = 8  # the progressive files' restart interval (MCUs; blocks in a scan of one component)
VAL_WEBP = 16  # phase formats (e): the first val images, committed as WebP


def pfm_bytes(rgb: np.ndarray) -> bytes:
    """A little-endian RGB PFM of ``rgb`` (H, W, 3) uint8: the values as floats, rows bottom to top."""
    h, w, _ = rgb.shape
    return b"PF\n%d %d\n-1.0\n" % (w, h) + np.ascontiguousarray(rgb[::-1]).astype("<f4").tobytes()


def format_bytes(rgb: np.ndarray, kind: str) -> bytes:
    """``rgb`` (H, W, 3) uint8 written as ``kind``: bmp24, bmp8, rle8, tif (LZW strips with horizontal
    differencing), tiles (PackBits, 32 x 32), tif16 (16-bit LZW), tifraw (uncompressed), png16, adam7,
    adam7-16, pfm, dng (a TIFF with DNG's version tag), jpg (baseline 4:2:0 q95), jpg-gray (baseline, the green
    channel), progressive and progressive-gray (their coefficients as a progressive file), mpo (two JPEGs back to
    back)."""
    rng = np.random.RandomState(rgb.shape[0] * rgb.shape[1])
    writers = {
        "bmp24": lambda: bmp_bytes(rgb, "24"), "bmp8": lambda: bmp_bytes(rgb, "8"),
        "rle8": lambda: bmp_bytes(rgb, "rle8"), "tif": lambda: tiff_bytes(rgb, 5, 2),
        "tiles": lambda: tiff_bytes(rgb, 32773, tile=(32, 32)), "tif16": lambda: tiff_bytes(tiff16(rgb, rng), 5, 2),
        "tifraw": lambda: tiff_bytes(rgb), "png16": lambda: png_bytes(rgb, 16),
        "adam7": lambda: png_bytes(rgb, 8, True), "adam7-16": lambda: png_bytes(rgb, 16, True),
        "pfm": lambda: pfm_bytes(rgb),
        "dng": lambda: tiff_bytes(rgb, 5, 2, tags={50706: ("B", [1, 4, 0, 0]), 254: ("I", [1])}),
        "jpg": lambda: jpeg_bytes(rgb, 95, "420"), "jpg-gray": lambda: jpeg_bytes(rgb[..., 1], 95, "444"),
        "progressive": lambda: jpeg_bytes(rgb, 95, "420", FORMAT_RESTART, progressive=True),
        "progressive-gray": lambda: jpeg_bytes(rgb[..., 1], 95, "444", FORMAT_RESTART, progressive=True),
        "mpo": lambda: jpeg_bytes(rgb, 90, "420") + jpeg_bytes(rgb[::2, ::2].copy(), 90, "420"),
    }
    return writers[kind]()


def format_job(job: tuple[np.ndarray, tuple[str, ...]]) -> list[bytes]:
    """A worker's job in phase formats: one image written in each of the kinds (``format_bytes``)."""
    rgb, kinds = job
    return [format_bytes(rgb, k) for k in kinds]


def write_format_files(jobs: list) -> list[list[bytes]]:
    """``format_job`` over ``jobs`` in spawned worker processes (the numpy
    writers' progressive JPEG takes ~1 s a 480 x 640 image on one core)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(format_job, jobs))


WEBP_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "webp"  # tests/fixtures/make_webp.py
WEBP_PLAIN_MAX = 160 * 160  # phase formats (d): the plain decoders held to the C++ one on files of at most this
WEBP_VGA = ("lossy_q75_m4_480x640.webp", "lossless_m2_q50_480x640.webp")  # (d) timed
WEBP_HOST_FIXTURE = "lossy_q90_m6_97x131.webp"  # (d) the host decoders' speed, C++ against Python
WEBP_READS = 20  # (d) reads a timing
WEBP_THREADS = 8  # (d) img/s on this many threads too
WEBP_PREDICT = ("lossy_q75_m4_480x640.webp", "lossless_m4_q75_96x128.webp", "alpha_q70_aq50_65x77.webp",
                "exif6_lossy_40x60.webp")  # (c) the WebP files in the predict directory


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def webp_reads(card: str) -> tuple[dict, dict]:
    """(d) WebP (``data/webp.py``, ``csrc/webp.cu``): every committed fixture
    through ``imread(..., "cuda")`` with the SHA-256 of cv2's decode recorded
    beside it (the card machine has no cv2), ``webp_color`` once a lossy file
    and never for a lossless one; on the fixtures of at most WEBP_PLAIN_MAX
    pixels the C++ decode's planes (Y, U, V, alpha) or ARGB equal to the plain
    decoders', and on every lossy one the kernel's BGR equal to
    ``webp_color_reference`` of the same planes; at 480x640 (lossy and
    lossless) a read timed on the host clock and split by CUDA events, the
    kernel alone from a CUDA graph beside its bytes bound and the plain
    version, img/s on 1 and WEBP_THREADS threads; the host decoders on one
    fixture, C++ against Python. Returns the ``webp_color`` and the
    ``fce_webp_decode`` records (without launches)."""
    from concurrent.futures import ThreadPoolExecutor

    from fce_yolo_tpu_torch.data import webp as W
    from fce_yolo_tpu_torch.data.imread import imread

    recorded = json.loads((WEBP_FIXTURES / "decodes.json").read_text())
    worst, n_plain, n_lossy = 0, 0, 0
    for name, rec in sorted(recorded.items()):
        path = WEBP_FIXTURES / name
        buf = path.read_bytes()
        before = W.webp_color.launches
        out = imread(path, "cuda")
        ran = W.webp_color.launches - before
        check(list(out.shape) == rec["shape"] and sha256(out) == rec["sha256"],
              f"phase formats (d) {name}: {out.shape}, not cv2's decode {rec['shape']}")
        info, flat, planes = W.webp_decode_host(buf, name)
        lossy = int(info[0]) == 1
        check(ran == int(lossy), f"phase formats (d) {name}: webp_color ran {ran} times for a "
                                 f"{'lossy' if lossy else 'lossless'} file")
        if lossy:
            n_lossy += 1
            bgr = W.webp_color(torch.from_numpy(flat).cuda(), info).cpu().numpy()
            ref = W.webp_color_reference(planes["y"], planes["u"], planes["v"])
            worst = max(worst, int(np.abs(bgr.astype(np.int16) - ref).max()))
            check(bgr.shape == ref.shape and bool((bgr == ref).all()),
                  f"phase formats (d) {name}: webp_color differs from webp_color_reference")
        if int(info[3]) * int(info[4]) <= WEBP_PLAIN_MAX:
            plain = W.webp_planes_reference(buf, name)
            check(plain.shape == flat.shape and bool((plain == flat).all()),
                  f"phase formats (d) {name}: the C++ decode's planes differ from the plain decoders'")
            n_plain += 1
    print(f"phase formats (d): {len(recorded)} committed WebP files read through imread on the card with the "
          f"SHA-256 of cv2's decode, webp_color once each of the {n_lossy} lossy ones and never for the others; the "
          f"C++ decode's planes equal to the plain decoders' on {n_plain} (up to {WEBP_PLAIN_MAX} px), the kernel's "
          f"BGR equal to webp_color_reference on every lossy one (max|d| {worst}) [{card}]", flush=True)

    timed = {}
    for name in WEBP_VGA:
        buf = (WEBP_FIXTURES / name).read_bytes()
        W.decode_webp(buf, name, "cuda")
        t0 = time.perf_counter()
        for _ in range(WEBP_READS):
            W.decode_webp(buf, name, "cuda")
        ms = (time.perf_counter() - t0) * 1e3 / WEBP_READS
        split = np.zeros(4, np.float64)
        times = np.zeros(4, np.float32)
        for _ in range(WEBP_READS):
            W.decode_webp(buf, name, "cuda", times)
            split += times
        split /= WEBP_READS
        with ThreadPoolExecutor(WEBP_THREADS) as pool:
            list(pool.map(lambda _: W.decode_webp(buf, name, "cuda"), range(WEBP_THREADS)))  # each thread's buffers
            t0 = time.perf_counter()
            list(pool.map(lambda _: W.decode_webp(buf, name, "cuda"), range(WEBP_THREADS * WEBP_READS)))
            img_s_n = WEBP_THREADS * WEBP_READS / (time.perf_counter() - t0)
        timed[name] = {"ms": ms, "split": split.tolist(), "img_s_1": 1e3 / ms, "img_s_n": img_s_n, "bytes": len(buf)}
        print(f"phase formats (d): {name} ({len(buf)} bytes): decode_webp {ms:.3f} ms a read (host clock, mean of "
              f"{WEBP_READS}); split (CUDA events): host decode {split[0]:.3f} ms, H2D {split[1]:.4f}, webp_color "
              f"{split[2]:.4f}, D2H {split[3]:.4f}; {1e3 / ms:.1f} img/s on 1 thread, {img_s_n:.1f} on "
              f"{WEBP_THREADS} [{card}]", flush=True)

    name = WEBP_VGA[0]
    info, flat, planes = W.webp_decode_host((WEBP_FIXTURES / name).read_bytes(), name)
    h, w = int(info[4]), int(info[3])
    d_planes = torch.from_numpy(flat).cuda()
    kernel_ms = graph_ms(lambda: W.webp_color(d_planes, info))
    t0 = time.perf_counter()
    for _ in range(3):
        W.webp_color_reference(planes["y"], planes["u"], planes["v"])
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    yuv = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)
    bound_ms = (yuv + 3 * w * h) / HBM_BYTES_PER_S * 1e3
    print(f"phase formats (d): webp_color alone at {h}x{w}: {kernel_ms:.4f} ms (CUDA graph of 20; bound "
          f"{bound_ms:.5f} ms, bytes: Y+U+V in, BGR out at 3.35 TB/s), plain {plain_ms:.1f} ms (numpy) [{card}]",
          flush=True)
    color_rec = {"max_abs_err": float(worst), "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "bytes", "library_ms": None, "read_ms_480x640": timed[WEBP_VGA[0]]["ms"],
                 "split_ms_480x640": timed[WEBP_VGA[0]]["split"], "img_s_1_480x640": timed[WEBP_VGA[0]]["img_s_1"],
                 f"img_s_{WEBP_THREADS}_480x640": timed[WEBP_VGA[0]]["img_s_n"]}

    buf = (WEBP_FIXTURES / WEBP_HOST_FIXTURE).read_bytes()
    info, flat, _ = W.webp_decode_host(buf, WEBP_HOST_FIXTURE)
    t0 = time.perf_counter()
    for _ in range(WEBP_READS):
        W.webp_decode_host(buf, WEBP_HOST_FIXTURE)
    ms = (time.perf_counter() - t0) * 1e3 / WEBP_READS
    t0 = time.perf_counter()
    plain = W.webp_planes_reference(buf, WEBP_HOST_FIXTURE)
    host_plain_ms = (time.perf_counter() - t0) * 1e3
    check(plain.shape == flat.shape and bool((plain == flat).all()), "phase formats (d): the host decoders differ")
    out_bytes = 3 * int(info[3]) * int(info[4])
    mb_s, plain_mb_s = out_bytes / ms / 1e3, out_bytes / host_plain_ms / 1e3
    lossless = timed[WEBP_VGA[1]]
    print(f"phase formats (d): host decode of {WEBP_HOST_FIXTURE} ({len(buf)} bytes -> {out_bytes} bytes of BGR): "
          f"C++ {ms:.3f} ms ({mb_s:.1f} MB/s of BGR), Python {host_plain_ms:.1f} ms ({plain_mb_s:.3f} MB/s) (host "
          f"clock) [{card}]", flush=True)
    decode_rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": host_plain_ms,
                  "bound_ms": (len(buf) + out_bytes) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
                  "mb_s": mb_s, "plain_mb_s": plain_mb_s, "fixture": WEBP_HOST_FIXTURE,
                  "lossless_read_ms_480x640": lossless["ms"], "lossless_split_ms_480x640": lossless["split"],
                  "lossless_img_s_1_480x640": lossless["img_s_1"],
                  f"lossless_img_s_{WEBP_THREADS}_480x640": lossless["img_s_n"]}
    return color_rec, decode_rec


def webp_val(root: Path, yolo, card: str) -> tuple[dict, dict, int]:
    """(e) ``YOLO.val`` (phase val's model, f32, B=16) on the first VAL_WEBP
    of phase val's images as the committed lossy WebP fixtures, with their
    labels, and on the same decoded images saved as arrays (``np.save``
    under an image suffix: the dataset collects image suffixes, ``imread``
    reads by leading bytes): P, R, mAP50 and mAP50-95 equal, the NMS kernel
    once a batch and bit-equal to the plain version, ``webp_color`` once a
    WebP image. Returns both paths' launches and the host decodes counted."""
    from fce_yolo_tpu_torch.data import webp as W
    from fce_yolo_tpu_torch.data.imread import imread

    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    n_batches = -(-VAL_WEBP // VAL_BATCH)
    out, decodes = {}, 0
    for what in ("webp", "arrays"):
        base = root / f"formats_{what}"
        (base / "images" / "val").mkdir(parents=True)
        (base / "labels" / "val").mkdir(parents=True)
        for i, _, lines in val_images():
            if i >= VAL_WEBP:
                break
            src = WEBP_FIXTURES / f"val_{i:03d}.webp"
            dst = base / "images" / "val" / f"{i:03d}.{'webp' if what == 'webp' else 'png'}"
            if what == "webp":
                dst.write_bytes(src.read_bytes())
            else:
                with open(dst, "wb") as f:
                    np.save(f, imread(src, "cuda"))
            (base / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
        (base / "data.yaml").write_text(f"path: {base}\nval: images/val\nnames:\n{names}")
        data = str(base / "data.yaml")
        torch.cuda.synchronize()
        reset_launches()
        before = W.decode_webp.launches
        res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
        torch.cuda.synchronize()
        launches = read_launches()
        if what == "webp":
            decodes = W.decode_webp.launches - before
        want = VAL_WEBP if what == "webp" else 0
        check(launches == no_jpeg(fused_stem=0, pick_suppress=n_batches) | {"webp_color": want},
              f"phase formats (e) val on {what}: launches {launches}")
        _, _, calls, _, _, mk = val_batches_vs_plain(yolo, data)
        check(len(calls) == n_batches, f"phase formats (e): NMS compared on {len(calls)} batches")
        got = tuple(res["metrics"].mean_results())
        check(np.allclose(got, mk, rtol=0, atol=1e-9),
              f"phase formats (e) {what}: YOLO.val's {got} != the per-batch {mk}")
        out[what] = (launches, got)
    check(out["webp"][1] == out["arrays"][1],
          f"phase formats (e): P/R/mAP on WebP {out['webp'][1]} != on the arrays {out['arrays'][1]}")
    print(f"phase formats (e): YOLO.val yolo11s-fce {IMGSZ} f32 B={VAL_BATCH} on {VAL_WEBP} val images as lossy WebP, "
          f"launches {out['webp'][0]}, and as the decoded arrays, launches {out['arrays'][0]}: P/R/mAP50/mAP50-95 "
          f"{tuple(round(v, 6) for v in out['webp'][1])} equal from both, the NMS kernel bit-equal to the plain "
          f"version on every batch [{card}]", flush=True)
    return {"formats_val_webp": out["webp"][0], "formats_val_webp_arrays": out["arrays"][0]}, decodes


def phase_formats(root: Path, png: dict, jpeg_d: dict, card: str) -> dict:
    """The still-image formats on the card (``data/imread.py``):
    (a) every writer's file (BMP 24-bit, palette and RLE8; TIFF LZW strips
    with differencing, PackBits tiles and 16-bit; PNG 16-bit and Adam7;
    PFM; progressive JPEG) read through ``imread(..., "cuda")``: the lossless
    ones give exactly the array written, a progressive JPEG exactly the
    baseline decode of the same coefficients (the C decoder's coefficients
    equal too) with ``jpeg_idct`` and ``jpeg_color`` once each; a 480x640
    and a 1080x1920 progressive decode timed beside the baseline one, and
    the host read of each other format at 480x640;
    (b) ``YOLO.val`` (phase val's model, f32, B=16) on phase val's 64 images
    written 16 each as BMP, LZW TIFF, 16-bit PNG and Adam7 PNG: P, R, mAP50
    and mAP50-95 equal to phase val's, the NMS kernel once a batch and
    bit-equal to the plain version on each; and on the same 64 as
    progressive JPEGs: equal to phase jpeg (d)'s, both JPEG kernels once an
    image;
    (c) ``YOLO.predict`` (bf16, B=16) on a directory of 16 files, one of each
    kind, and 4 WebP fixtures (lossy, lossless, with alpha, EXIF-rotated):
    the stem and NMS kernels once a batch, both JPEG kernels once a JPEG,
    ``webp_color`` once a lossy WebP, the images and detections equal to a
    predict on the arrays;
    (d) ``webp_reads`` (run first); (e) ``webp_val`` (inside (b)).
    Returns the launches by path, the ``webp_color`` record and the
    ``fce_webp_decode`` record."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data import jpeg as J
    from fce_yolo_tpu_torch.data import webp as W
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.nn.model import init_weights

    t_phase = time.perf_counter()
    color_rec, decode_rec = webp_reads(card)
    rng = np.random.RandomState(SEED + 30)
    vals = list(val_images())
    small = jpeg_test_image(rng, 37, 53) // 32 * 32  # at most 512 colours: quantised for the palettes below
    small_pal = np.full((37, 53, 3), 60, np.uint8)
    small_pal[5:30, 9:40] = (80, 80, 255)
    small_pal[::7, ::5] = (255, 80, 80)
    vga = jpeg_test_image(rng, 480, 640)
    vga_pal = np.full((480, 640, 3), 60, np.uint8)
    vga_pal[100:300, 200:500] = (80, 255, 80)
    vga_pal[::9, ::7] = (255, 80, 80)
    big = jpeg_test_image(np.random.RandomState(SEED + 21), 1080, 1920)
    lossless = ("bmp24", "bmp8", "rle8", "tif", "tiles", "tif16", "tifraw", "png16", "adam7", "adam7-16", "pfm")
    palette_kinds = ("bmp8", "rle8")
    jobs = [(vals[i][1], (FORMAT_KINDS[i % 4], "progressive")) for i in range(VAL_IMAGES)]
    jobs += [(vga, ("jpg", "progressive") + tuple(k for k in lossless if k not in palette_kinds)),
             (vga_pal, palette_kinds), (big, ("jpg", "progressive")),
             (small, tuple(k for k in lossless if k not in palette_kinds)), (small_pal, palette_kinds)]
    mixed = [vals[i][1] for i in range(E2E_BATCH)]
    mixed_kinds = ("bmp24", "bmp8", "rle8", "tif", "tiles", "tif16", "tifraw", "png16", "adam7", "adam7-16", "pfm",
                   "dng", "jpg", "progressive", "progressive-gray", "mpo")
    twin = {"progressive": "jpg", "progressive-gray": "jpg-gray"}  # the baseline file of the same coefficients
    jobs += [(img, (k, twin[k]) if k in twin else (k,)) for img, k in zip(mixed, mixed_kinds)]
    t0 = time.perf_counter()
    written = write_format_files(jobs)
    write_s = time.perf_counter() - t0
    data_files, (vga_files, vga_pal_files, big_files, small_files, small_pal_files) = written[:VAL_IMAGES], \
        written[VAL_IMAGES: VAL_IMAGES + 5]
    mixed_files = written[VAL_IMAGES + 5:]

    # (a) every writer's file through imread on the card
    folder = root / "formats_a"
    folder.mkdir()
    n_files = 0
    for img, kinds, bufs in ((vga, [k for k in lossless if k not in palette_kinds], vga_files[2:]),
                             (vga_pal, palette_kinds, vga_pal_files),
                             (small, [k for k in lossless if k not in palette_kinds], small_files),
                             (small_pal, palette_kinds, small_pal_files)):
        for kind, buf in zip(kinds, bufs):
            path = folder / f"{img.shape[0]}x{img.shape[1]}.{kind}"
            path.write_bytes(buf)
            out = imread(path, "cuda")
            check(out.shape == img.shape and bool((out == img[..., ::-1]).all()),
                  f"phase formats (a) {path.name}: not the array written")
            n_files += 1
    prog_cases = [(vga, "420", 95, FORMAT_RESTART, None)]
    for i, (sampling, quality, restart, orientation, h, w) in enumerate(
            [("420", 75, 0, None, 7, 9), ("422", 95, 1, 6, 17, 33), ("444", 50, 7, None, 33, 47),
             ("440", 100, 3, 3, 40, 56), ("411", 90, 2, None, 64, 80), ("gray", 95, 5, 8, 61, 67)]):
        prog_cases.append((jpeg_test_image(rng, h, w), sampling, quality, restart, orientation))
    for img, sampling, quality, restart, orientation in prog_cases:
        src = img[..., 0] if sampling == "gray" else img
        args = (src, quality, "444" if sampling == "gray" else sampling, restart, orientation)
        base = jpeg_bytes(*args) if img is not vga else vga_files[0]
        prog = jpeg_bytes(*args, progressive=True) if img is not vga else vga_files[1]
        what = f"progressive {sampling} q{quality} {img.shape[0]}x{img.shape[1]} restart {restart}"
        path = folder / "p.jpg"
        path.write_bytes(prog)
        before = read_launches()
        out = imread(path, "cuda")
        after = read_launches()
        check(after["jpeg_idct"] - before["jpeg_idct"] == 1 and after["jpeg_color"] - before["jpeg_color"] == 1,
              f"phase formats (a) {what}: the JPEG kernels did not run once each")
        ref = J.decode_jpeg(base, what, "cuda")
        check(out.shape == ref.shape and bool((out == ref).all()),
              f"phase formats (a) {what}: differs from the baseline decode of the same coefficients")
        ib, cb, _ = J.jpeg_coefficients(base, what)
        ip, cp, _ = J.jpeg_coefficients(prog, what)
        for c, (a, b) in enumerate(zip(cb, cp)):
            rows, cols = -(-int(ib[21 + 8 * c]) // 8), -(-int(ib[20 + 8 * c]) // 8)
            check(bool((a[:rows, :cols] == b[:rows, :cols]).all()),
                  f"phase formats (a) {what}: component {c}'s coefficients differ from the baseline file's")
        n_files += 1
    print(f"phase formats (a): {n_files} files read through imread on the card equal to what was written (BMP "
          f"24-bit, palette and RLE8; TIFF LZW + differencing, PackBits tiles, 16-bit, uncompressed; PNG 16-bit, "
          f"Adam7 8/16-bit; PFM; at 37x53 and 480x640) and {len(prog_cases)} progressive JPEGs equal to the "
          f"baseline decode of the same coefficients (every sampling, gray, restarts, orientations), jpeg_idct and "
          f"jpeg_color once each a file; {len(jobs)} writer jobs in {write_s:.1f} s [{card}]", flush=True)
    timed = {}
    for name, files in (("480x640", vga_files), ("1080x1920", big_files)):
        n = 20 if name == "480x640" else 10
        timed[name] = {"baseline": time_jpeg(files[0], f"{name} 4:2:0 q95 baseline", n, card, "phase formats (a)"),
                       "progressive": time_jpeg(files[1], f"{name} 4:2:0 q95 progressive (restart {FORMAT_RESTART})",
                                                n, card, "phase formats (a)")}
    host = {}
    for kind, buf in zip([k for k in lossless if k not in palette_kinds], vga_files[2:]):
        host[kind] = buf
    host.update(zip(palette_kinds, vga_pal_files))
    read_ms = {}
    for kind, buf in host.items():
        path = folder / f"t.{kind}"
        path.write_bytes(buf)
        imread(path, "cuda")
        t0 = time.perf_counter()
        for _ in range(5):
            imread(path, "cuda")
        read_ms[kind] = (time.perf_counter() - t0) * 1e3 / 5
    print("phase formats (a): host read at 480x640 through imread(..., 'cuda') (host clock, mean of 5, one thread): "
          + ", ".join(f"{k} {v:.2f} ms ({len(host[k])} bytes)" for k, v in read_ms.items()) + f" [{card}]", flush=True)

    # (b) YOLO.val on the lossless copy, then on the progressive one
    n_batches = -(-VAL_IMAGES // VAL_BATCH)
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))  # phase val's model, float32
    with torch.inference_mode():
        yolo.model.eval()(torch.zeros(VAL_BATCH, 3, IMGSZ, IMGSZ, device="cuda"))
    out_b = {}
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    for what, ext_of in (("lossless", lambda i: FORMAT_SUFFIX[FORMAT_KINDS[i % 4]]), ("progressive", lambda i: "jpg")):
        base = root / f"formats_{what}"
        (base / "images" / "val").mkdir(parents=True)
        (base / "labels" / "val").mkdir(parents=True)
        for (i, _, lines), bufs in zip(vals, data_files):
            (base / "images" / "val" / f"{i:03d}.{ext_of(i)}").write_bytes(bufs[0] if what == "lossless" else bufs[1])
            (base / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
        (base / "data.yaml").write_text(f"path: {base}\nval: images/val\nnames:\n{names}")
        data = str(base / "data.yaml")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        jpegs = VAL_IMAGES if what == "progressive" else 0
        check(launches == {"fused_stem": 0, "pick_suppress": n_batches, "jpeg_fdct": 0, "webp_color": 0,
                           "jpeg_idct": jpegs,
                           "jpeg_color": jpegs}, f"phase formats (b) val on {what} files: launches {launches}")
        metrics = res["metrics"].mean_results()
        want = png["metrics"] if what == "lossless" else jpeg_d["metrics"]
        check(metrics == want, f"phase formats (b) val on {what} files: P/R/mAP {metrics} != {want} "
                               f"({'phase val' if what == 'lossless' else 'phase jpeg (d)'})")
        if what == "lossless":
            _, _, calls, _, _, mk = val_batches_vs_plain(yolo, data)
            check(len(calls) == n_batches, f"phase formats (b): NMS compared on {len(calls)} batches")
        out_b[what] = (launches, metrics, VAL_IMAGES / wall, res["metrics"].speed["preprocess"])
    webp_paths, val_decodes = webp_val(root, yolo, card)
    del yolo
    lw, pw = out_b["lossless"], out_b["progressive"]
    print(f"phase formats (b): YOLO.val yolo11s-fce {IMGSZ} f32 B={VAL_BATCH} on the {VAL_IMAGES} val images as "
          f"{VAL_IMAGES // 4} each BMP, LZW TIFF, 16-bit PNG and Adam7 PNG: launches {lw[0]}, P/R/mAP50/mAP50-95 "
          f"{tuple(round(v, 6) for v in lw[1])} equal to phase val's, the NMS kernel bit-equal to the plain version "
          f"on every batch; {lw[2]:.1f} img/s, loader wait {lw[3]:.2f} ms an image (PNG, phase val: "
          f"{png['img_s']:.1f} img/s); as progressive JPEGs: launches {pw[0]}, P/R/mAP "
          f"{tuple(round(v, 6) for v in pw[1])} equal to phase jpeg (d)'s; {pw[2]:.1f} img/s, loader wait "
          f"{pw[3]:.2f} ms an image (baseline, phase jpeg "
          f"(d): {jpeg_d['img_s']:.1f} img/s) [{card}]", flush=True)

    # (c) YOLO.predict on a directory of every kind
    folder = root / "formats_c"
    folder.mkdir()
    files, arrays = [], []
    for i, (img, kind, bufs) in enumerate(zip(mixed, mixed_kinds, mixed_files)):
        path = folder / f"{i:02d}_{kind}.{FORMAT_SUFFIX[kind]}"
        path.write_bytes(bufs[0])
        files.append(str(path))
        if kind in ("jpg", "mpo"):  # the first JPEG, decoded on the card (phase jpeg (b): equal to the plain path)
            arrays.append(J.decode_jpeg(bufs[0][: bufs[0].index(b"\xff\xd9") + 2], kind, "cuda"))
        elif kind in twin:
            arrays.append(J.decode_jpeg(bufs[1], kind, "cuda"))  # the baseline twin: (a) showed them equal
        else:
            arrays.append(np.ascontiguousarray(img[..., ::-1]))
    for j, name in enumerate(WEBP_PREDICT):  # (d) showed their reads equal to cv2's
        path = folder / f"{len(mixed) + j:02d}_webp-{name}"
        path.write_bytes((WEBP_FIXTURES / name).read_bytes())
        files.append(str(path))
        arrays.append(imread(path, "cuda"))
    n_webp_lossy = sum(not n.startswith("lossless") for n in WEBP_PREDICT)
    yolo = YOLO("yolo11s-fce.yaml", device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()
    yolo.predict(arrays, imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    decodes = W.decode_webp.launches
    t0 = time.perf_counter()
    results = yolo.predict(str(folder), imgsz=IMGSZ, batch=E2E_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    predict_launches = read_launches()
    decodes = W.decode_webp.launches - decodes + val_decodes
    n_jpeg = sum(k in ("jpg", "mpo") or k.startswith("progressive") for k in mixed_kinds)
    n_pred = -(-len(files) // E2E_BATCH)
    check(predict_launches == {"fused_stem": n_pred, "pick_suppress": n_pred, "jpeg_fdct": 0, "jpeg_idct": n_jpeg,
                               "jpeg_color": n_jpeg, "webp_color": n_webp_lossy},
          f"phase formats (c): launches {predict_launches}")
    check([r.path for r in results] == files, "phase formats (c): paths or order differ from the sorted files")
    again = yolo.predict(arrays, imgsz=IMGSZ, batch=E2E_BATCH)
    dmax = 0.0
    for r, a, img in zip(results, again, arrays):
        check(r.orig_img.shape == img.shape and bool((r.orig_img == img).all()), f"{r.path}: not the expected image")
        check(len(r) == len(a) and bool((r.boxes.cls == a.boxes.cls).all()), f"{r.path}: detections differ")
        if len(r):
            dmax = max(dmax, float(np.abs(r.boxes.data - a.boxes.data).max()))
    check(dmax <= 1e-3, f"phase formats (c): detections differ by {dmax} from a predict on the arrays")
    del yolo
    print(f"phase formats (c): YOLO.predict yolo11s-fce {IMGSZ} bf16 B={E2E_BATCH} on a directory of {len(files)} "
          f"files ({', '.join(mixed_kinds)}, and WebP {', '.join(WEBP_PREDICT)}), launches {predict_launches}; "
          f"images and {sum(len(r) for r in results)} detections equal to a predict on the arrays (max|d| "
          f"{dmax:.1e}, limit "
          f"1e-3); {len(files) / wall:.1f} img/s through YOLO.predict (host clock, reads and letterbox included); "
          f"phase formats {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    decode_rec["launches"] = decodes
    return {"formats_val": out_b["lossless"][0], "formats_val_progressive": out_b["progressive"][0],
            "formats_predict": predict_launches, **webp_paths}, color_rec, decode_rec


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


def train_step_times(bdev: dict, nc: int, name: str = "yolo11s-fce.yaml", bf16s: tuple = (True, False)) -> dict:
    """The train step (forward + loss + backward + clip + AdamW + EMA, with
    its one host sync) of ``name`` on a batch already on the card: CUDA
    events over 5 steps after 2 (and the first step alone, on the host
    clock), in bf16 autocast and in float32 (TF32 off), with the peak memory
    of each; then AdamW + EMA alone on the float32 model (10 calls after 2)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.task_losses import task_loss_for
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    batch = int(bdev["img"].shape[0])
    out = {}
    for bf16 in bf16s:
        yolo = YOLO(name, device="cuda")
        opt = Optimizer(OptimCfg(optimizer="AdamW", batch_size=batch, nbs=batch, nc=nc), yolo.model)
        state = create_train_state(yolo.model, opt)
        cfg = DetectionLossCfg(nc=nc, strides=tuple(yolo.strides))
        task_loss = task_loss_for("detect", cfg, end2end=yolo.spec.layers[-1].name == "v10Detect")[0]
        step = make_train_step(yolo.model, opt, cfg, bf16=bf16, task_loss=task_loss)
        tag = "bf16" if bf16 else "f32"
        t0 = time.perf_counter()
        step(state, bdev)
        torch.cuda.synchronize()
        out[f"first_step_ms_{tag}"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        out[f"step_ms_{tag}"] = cuda_ms(lambda: step(state, bdev), iters=5, warmup=2)
        out[f"peak_gib_{tag}"] = torch.cuda.max_memory_allocated() / 2**30
        if not bf16:
            params = state.params
            grads = [torch.full_like(p, 1e-3) for p in params]
            out["optimizer_ema_ms"] = cuda_ms(lambda: (opt.step(params, grads), state.ema.update(params)))
        del yolo, opt, state, step
        torch.cuda.empty_cache()
    return out


def step_batch(data: dict):
    """The first mosaic batch of ``data``'s train split on the card, and its dataset."""
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader

    d = check_det_dataset(data)
    ds = YOLODataset(d["train"], imgsz=IMGSZ, mode="train", nc=VAL_NC)
    batch = next(iter(DataLoader(ds, batch_size=VAL_BATCH, workers=8)))
    return {k: torch.from_numpy(batch[k]).cuda() for k in ("img", "cls", "bboxes", "mask")}, ds


def time_train_step(data: dict, card: str) -> dict:
    """Phase train (c): ``train_step_times`` on a mosaic batch, and one
    mosaic item's host time on one thread."""
    bdev, ds = step_batch(data)
    out = train_step_times(bdev, VAL_NC)
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


def phase_train(root: Path, card: str) -> tuple[dict, list[float]]:
    """(b) ``YOLO.train`` for TRAIN_EPOCHS epochs
    with the defaults (bf16, AdamW from "auto") on 64 PNG images as both
    splits, starting from phase val's matching weights: finite losses, one
    results.csv row an epoch, last and best written, the NMS kernel launched
    once per val batch of every epoch and equal to the plain version on the
    last epoch's batches, ``results.png`` drawn (timed) and read back at its
    size, and ``best`` reloaded in a fresh YOLO giving the
    run's best mAP50-95 within 1e-6; (c) times; (a) one step card vs CPU.
    Returns (the train path's launches, each epoch's img/s)."""
    import csv as _csv

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.experiments.analysis import load_results
    from fce_yolo_tpu_torch.utils import plotting

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
        with figure_times(plotting, ("plot_results",)) as figs:
            reset_launches()
            t0 = time.perf_counter()
            res = yolo.train(data, epochs=TRAIN_EPOCHS, batch=VAL_BATCH, imgsz=IMGSZ, project=str(root / "runs"),
                             verbose=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
    finally:
        DetectionValidator.nms = real_nms
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_val * TRAIN_EPOCHS, jpeg_fdct=train_plots(n_val)),
          f"train path: launches {launches}, expected no stem, {n_val} NMS an epoch and 3 mosaics written")
    rows = res["results"]
    check(res["epochs_run"] == len(rows) == TRAIN_EPOCHS, f"train path ran {res['epochs_run']} epochs")
    check(all(np.isfinite(r[k]) for r in rows for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")),
          f"train path: a logged loss is not finite {rows}")
    save_dir = Path(res["save_dir"])
    with open(save_dir / "results.csv") as f:
        check(len(list(_csv.DictReader(f))) == TRAIN_EPOCHS, "results.csv does not hold one row an epoch")
    for w in ("last", "best"):
        check((save_dir / "weights" / w / "meta.json").exists(), f"weights/{w} missing")
    panels = sum(k not in ("epoch", "time") and isinstance(v, (int, float)) for k, v in load_results(save_dir)[0].items())
    cols = min(4, panels)  # plot_results: 4 x 3 in a panel, up to 4 a row, at dpi 120
    check(list(figs.ms) == ["results.png"], f"phase train: figures drawn {list(figs.ms)}")
    read_figure(save_dir / "results.png", (4 * cols * 120, 3 * -(-panels // cols) * 120))
    print(f"phase train: results.png ({panels} panels) drawn in {figs.ms['results.png']:.1f} ms (host clock) and read "
          f"back at its size [{card}]", flush=True)

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
    return launches, [sp["img_per_s"] for sp in res["speed"]]


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
    otherwise: lr0, cos_lr, close_mosaic), on the first ABLATION_IMAGES val
    images as both splits through a data YAML, with the counts at 0. Checks: each stage 2
    starts bit-equal to its stage 1's ``weights/best``; ``validate_run``
    reports no problem and fce_wiou's best says WIoU; ``ablation_s.json``
    holds four rows; the NMS kernel launched once per val batch of every
    stage (the stem never) and bit-equal to the plain version on each
    stage's val; ``inspect`` finds finite fusion weights in every
    BiFPN_Concat of fce and bifpn; ``YOLO.info`` of the three
    architectures; the report's tables written and its four figures drawn
    (none skipped), ``produce_all``'s curves, bars and per-run results grids,
    each figure timed and read back; then, outside the counted run,
    ``compose_panels`` to a JPEG and ``visualize_image_annotations`` on it
    with their default device, each JPEG coded by the card's kernels.
    Returns the path's launches."""
    from dataclasses import replace

    from fce_yolo_tpu_torch import YOLO, api
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.experiments import (ABLATION_ORDER, TrainConfig, inspect_checkpoint, run_ablation,
                                                validate_run)
    from fce_yolo_tpu_torch.experiments import config as xconfig
    from fce_yolo_tpu_torch.experiments import figures as xfigures
    from fce_yolo_tpu_torch.experiments.figures import produce_all, produce_report
    from fce_yolo_tpu_torch.utils import plotting
    from fce_yolo_tpu_torch.utils.chart import Figure
    from fce_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    phase_repair(root, card)
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    sub = root / "ablation_data"
    for kind, ext in (("images", "png"), ("labels", "txt")):
        (sub / kind / "val").mkdir(parents=True)
        for i in range(ABLATION_IMAGES):
            (sub / kind / "val" / f"{i:03d}.{ext}").symlink_to(root / kind / "val" / f"{i:03d}.{ext}")
    data = root / "ablation.yaml"
    data.write_text(f"path: {sub}\ntrain: images/val\nval: images/val\nnames:\n{names}")
    project = root / "ablation"
    cfg = TrainConfig(data=str(data), batch=VAL_BATCH, imgsz=IMGSZ, workers=8, project=str(project))
    scale, n_val, stages = ABLATION_SCALE, -(-ABLATION_IMAGES // VAL_BATCH), 2 * len(ABLATION_ORDER)

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
        reset_launches()
        t0 = time.perf_counter()
        report = run_ablation(cfg, scale=scale, clean=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        api.YOLO.train, DetectionValidator.nms = real_train, real_nms
        xconfig.MODEL_CONFIGS.update(registry)

    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_val * stages, jpeg_fdct=stages * train_plots(n_val)),
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
    with figure_times(xfigures, ("plot_metric_panels", "plot_ablation_bars", "plot_training_curves")) as figs, \
            figure_times(plotting, ("plot_results",)) as grids:
        out = produce_report(report["runs"], project / "report", scale=scale, imgsz=IMGSZ)
        every = produce_all(report["runs"], project / "figures", scale=scale)
    check(all(Path(p).exists() for p in out["written"]) and sum(p.endswith(".md") for p in out["written"]) == 2,
          f"report: {out}")
    check(out["skipped"] == {} and len(out["written"]) == 2 + 4, f"report: every figure drawn: {out}")
    sizes = {"metric_panels_en.png": (14, 10), "metric_panels_cn.png": (14, 10), "ablation_bars.png": (7, 4.5),
             "training_curves.png": (8, 5)}  # inches, all at dpi 150
    for f in out["written"]:
        if f.endswith(".png"):
            read_figure(Path(f), Figure(sizes[Path(f).name]).pixel_size(150))
    check(len(every) == 2 + len(report["runs"]) and len(grids.ms) == len(report["runs"]),
          f"produce_all: {every}, results grids {list(grids.ms)}")
    for f in every:
        read_figure(Path(f))
    fig_ms = {**figs.ms, **{f"{Path(f).parent.name}/results.png": ms for f, ms in zip(every[2:], grids.ms.values())}}
    print("phase experiments figures: " + ", ".join(f"{f} {ms:.1f} ms" for f, ms in fig_ms.items())
          + f" (host clock; produce_report and produce_all), each read back [{card}]", flush=True)
    # outside the counted run: the two image-writing entry points code on the card by default
    reset_launches()
    composed = xfigures.compose_panels([("(a)", every[0]), ("(b)", every[1])], project / "figures" / "composed.jpg",
                                       fig_title="Figure 1")
    boxes = project / "figures" / "composed.txt"
    boxes.write_text("0 0.3 0.5 0.2 0.4\n1 0.7 0.5 0.2 0.4\n")
    annotated = plotting.visualize_image_annotations(composed, boxes, {0: "curves", 1: "bars"})
    jpeg_launches = read_launches()
    size = read_figure(Path(composed))
    read_figure(Path(annotated), size)
    check(jpeg_launches == no_jpeg(fused_stem=0, pick_suppress=0, jpeg_fdct=2) | {"jpeg_idct": 1, "jpeg_color": 1},
          f"compose_panels and visualize_image_annotations on the card: launches {jpeg_launches}")
    print(f"phase experiments: compose_panels wrote {Path(composed).name} {size} and visualize_image_annotations "
          f"{Path(annotated).name} on the card's JPEG kernels: {jpeg_launches} [{card}]", flush=True)

    for run, (sec, speed) in stage_runs.items():
        print(f"phase experiments: {run}: {sec:.1f} s (YOLO.train, host clock, checkpoints included); " + "; ".join(
            f"epoch {sp['epoch'] + 1}: {sp['img_per_s']:.2f} img/s, val {sp['val_s']:.2f} s" for sp in speed)
              + f" [{card}]", flush=True)
    print(f"phase experiments: run_ablation yolo11{scale} x {len(ABLATION_ORDER)} variants {IMGSZ} bf16 B={VAL_BATCH}, "
          f"{stages} stages of 1 epoch ({ABLATION_IMAGES // VAL_BATCH} steps on {ABLATION_IMAGES} images), launches {launches}; stage 2 bit-equal to "
          f"stage 1's best for every variant; validate_run clean; NMS kernel idx/ok equal to the plain version on "
          f"all {n_val * stages} val batches; fusion weights {fusion}; report {len(out['written'])} written, "
          f"none skipped; produce_all {len(every)} figures; {wall:.1f} s in all [{card}]", flush=True)
    return launches


# ------------------------------------------------------------ phase tasks
TASK_MODELS = {"segment": "yolo11s-seg.yaml", "pose": "yolo11s-pose.yaml", "obb": "yolo11s-obb.yaml"}
TASK_IMAGES = 16  # phase tasks (b): one val batch a task (and task_train (b)'s one step)
TASK_COLORS = [(80, 80, 255), (80, 255, 80), (255, 80, 80)]  # RGB of classes 0-2


def task_images(task: str):
    """TASK_IMAGES RGB images of 480-800 px a side, grey with 1-3 objects of
    classes 0-2 and their label lines: filled star polygons (segment),
    rectangles with 17 keypoints inside (pose), or rotated rectangles as
    four corners (obb), all normalized."""
    from fce_yolo_tpu_torch.ops.geometry import fill_poly

    rng = np.random.RandomState(SEED + 5)
    for i in range(TASK_IMAGES):
        h, w = (int(v) for v in rng.randint(480, 801, 2))
        img = np.full((h, w, 3), 60, np.uint8)
        lines = []
        for _ in range(rng.randint(1, 4)):
            k = int(rng.randint(0, 3))
            cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
            if task == "pose":
                bw, bh = rng.uniform(0.2, 0.4) * w, rng.uniform(0.2, 0.4) * h
                poly = np.array([[cx - bw / 2, cy - bh / 2], [cx + bw / 2, cy - bh / 2], [cx + bw / 2, cy + bh / 2],
                                 [cx - bw / 2, cy + bh / 2]])
                kpts = np.stack([rng.uniform(cx - bw / 2, cx + bw / 2, 17), rng.uniform(cy - bh / 2, cy + bh / 2, 17)], 1)
            elif task == "obb":
                bw, bh, a = rng.uniform(0.25, 0.4) * min(h, w), rng.uniform(0.12, 0.2) * min(h, w), rng.uniform(-0.7, 0.7)
                rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
                poly = np.array([[-bw / 2, -bh / 2], [bw / 2, -bh / 2], [bw / 2, bh / 2], [-bw / 2, bh / 2]]) @ rot.T
                poly += [cx, cy]
            else:
                n = int(rng.randint(8, 13))
                ang, rad = np.sort(rng.uniform(0, 2 * np.pi, n)), rng.uniform(0.06, 0.16, n) * min(h, w)
                poly = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
            poly = np.clip(poly / [w, h], 0.01, 0.99)
            plane = np.zeros((h, w), np.float32)
            fill_poly(plane, [np.round(poly * [w, h]).astype(np.int32)], 1.0)
            img[plane > 0] = TASK_COLORS[k]
            if task == "pose":
                (x1, y1), (x2, y2) = poly.min(0), poly.max(0)
                lines.append(f"{k} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f} " + " ".join(
                    f"{x / w:.6f} {y / h:.6f} 2" for x, y in kpts))
            else:
                lines.append(f"{k} " + " ".join(f"{v:.6f}" for v in poly.ravel()))
        yield i, img, lines


def write_task_dataset(root: Path, task: str) -> str:
    """``task_images`` as PNG under ``root/task`` with their labels; VAL_NC class names."""
    base = root / task
    (base / "images" / "val").mkdir(parents=True)
    (base / "labels" / "val").mkdir(parents=True)
    for i, img, lines in task_images(task):
        (base / "images" / "val" / f"{i:03d}.png").write_bytes(png_bytes(img))
        (base / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    (base / "data.yaml").write_text(f"path: {base}\nval: images/val\nnames:\n{names}")
    return str(base / "data.yaml")


def task_matching_model(yolo, task: str):
    """``matching_model``'s widened boxes and raised classes, and: OBB boxes
    twice as long as high (DFL bin 4 above and below instead of 8) at angle
    0 (the angle branch's bias at sigmoid 0.25); segment masks that fill
    their boxes (positive prototypes and mask coefficients)."""
    matching_model(yolo)
    head = yolo.model.detect
    with torch.no_grad():
        if task == "obb":
            for branch in head.cv2:
                branch[-1].bias[[24, 56]] -= 6.0
                branch[-1].bias[[20, 52]] += 6.0
            for branch in head.cv4:
                branch[-1].bias.fill_(float(np.log(0.25 / 0.75)))
        if task == "segment":
            head.proto.cv3.bn.bias += 5.0
            for branch in head.cv4:
                branch[-1].bias += 1.0
    return yolo


def e2e_images(seed: int, batches: int) -> list[np.ndarray]:
    """``batches`` batches of random 640x640 arrays and one letterboxed 480x640 one."""
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (IMGSZ, IMGSZ, 3), np.uint8) for _ in range(batches * E2E_BATCH)]
    imgs.append(rng.randint(0, 256, (IMGSZ * 3 // 4, IMGSZ, 3), np.uint8))
    return imgs


def task_predict(task: str, card: str, name: str | None = None, imgs: list | None = None,
                 stem: bool = True, yolo=None) -> dict:
    """(a) ``YOLO.predict`` of the task's model (the yolo11s one unless
    ``name`` is given; bf16, folded, seed weights without the class prior;
    or ``yolo``, a facade made so, with ``name`` for the messages) on
    33 random arrays (or ``imgs``) at B=16: the stem kernel launched once a
    batch when ``stem`` (the model must take it, else it must not), the NMS
    kernel once a batch but for OBB; finite results of the task's kind. On
    the first batch as the predictor fed it: the stem kernel against its
    plain version and the kernel path's preds against the plain-stem path's
    (when it takes the stem), and (detect, segment, pose) the NMS kernel's
    idx/ok, boxes, keypoints and masks equal to the plain version's on the
    same preds. Returns the launches and the numbers."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, stem_spec_from_model, stem_weights

    name = name or TASK_MODELS[task]
    if yolo is None:
        yolo = YOLO(name, device="cuda")
        init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
        yolo.to(torch.bfloat16).fuse()
    check(yolo.task == task, f"{name}: task {yolo.task}, expected {task}")
    spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
    check((spec is not None) == stem, f"{name} {'must' if stem else 'must not'} take the fused stem")
    imgs = imgs if imgs is not None else e2e_images(SEED + 6, 2)
    yolo.predict(imgs[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    n_det = 0
    for r, img in zip(yolo.predict(imgs, imgsz=IMGSZ, batch=E2E_BATCH, stream=True), imgs):
        h, w = img.shape[:2]
        n_det += len(r)
        check(len(r) <= MAX_DET and bool(np.isfinite(r.boxes.data).all()), f"{task} predict: boxes")
        if task == "segment":
            check(r.masks.data.shape == (len(r), h, w), f"segment predict: masks {r.masks.data.shape}")
        if task == "pose":
            check(r.keypoints.data.shape == (len(r), 17, 3) and bool(np.isfinite(r.keypoints.data).all()),
                  "pose predict: keypoints")
        if task == "obb":
            check(r.obb.data.shape == (len(r), 7) and bool(np.isfinite(r.obb.data).all()), "obb predict: rotated boxes")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-len(imgs) // E2E_BATCH)
    want_nms = 0 if task == "obb" else n_batches  # OBB suppresses with probiou (torch ops)
    want_stem = n_batches if stem else 0
    check(launches == no_jpeg(fused_stem=want_stem, pick_suppress=want_nms),
          f"{name} predict: launches {launches}, expected {want_stem} stem and {want_nms} NMS for {n_batches} batches")

    model = yolo.model
    batch = letterboxed(imgs[:E2E_BATCH])
    x = (batch.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    predictor = DetectionPredictor(model, yolo.names, imgsz=IMGSZ, batch_size=E2E_BATCH)
    stem_rel = stem_spread = dmax = bound = corr = None
    with torch.inference_mode():
        plain_out = model(x)
    out = plain_out
    if stem:
        weights = stem_weights(fold_stem_params(model, spec), spec)
        _, stem_rel, stem_spread = check_stem(batch, weights, spec, f"{name} predict")
        with torch.inference_mode():
            out = apply_with_fused_stem(model, batch, spec, weights)
        fused, plain = out["preds"].float().cpu().numpy(), plain_out["preds"].float().cpu().numpy()
        dmax = float(np.abs(fused - plain).max())
        bound = 0.02 * max(float(np.abs(plain).max()), 1.0)
        corr = float(np.corrcoef(fused.ravel(), plain.ravel())[0, 1])
        check(dmax <= bound and corr > 0.9999, f"{name}: kernel path preds differ: max|d|={dmax} (<= {bound}), "
              f"corr={corr}")

    def host(run_masks: bool):
        nms = predictor.postprocess(out)
        res = {k: v.cpu().numpy() for k, v in nms.items() if k not in ("proto", "extra")}
        if run_masks:
            res["masks"] = [m.cpu().numpy() for m in predictor.masks(nms, E2E_BATCH)]
        return res

    kept = 0
    if task != "obb":
        calls: list = []
        outs = kernel_vs_plain(lambda: host(task == "segment"), calls, min(NMS_K, out["preds"].shape[1]),
                               predictor.iou, predictor.max_det, f"{name} predict")
        kept = int(outs["kernel"]["valid"].sum())

    def device_path():
        nms = predictor.infer(batch)
        return predictor.masks(nms, E2E_BATCH) if task == "segment" else nms

    def plain_path():
        nms = predictor.postprocess(model(x))
        return predictor.masks(nms, E2E_BATCH) if task == "segment" else nms

    with torch.inference_mode():
        ms = cuda_ms(device_path, iters=5)
        ms_plain = cuda_ms(plain_path, iters=5)
    return {"launches": launches, "img_s": len(imgs) / wall, "ms": ms, "ms_plain": ms_plain, "n_det": n_det,
            "kept": kept, "stem_rel": stem_rel, "stem_spread": stem_spread, "dmax": dmax, "bound": bound,
            "corr": corr, "n_images": len(imgs)}


def task_val(root: Path, task: str, card: str) -> dict:
    """(b) ``YOLO.val`` of the task's yolo11s model in float32 (TF32 off) on
    TASK_IMAGES PNG images it writes, with the counts at 0: the NMS kernel
    once a batch (segment, pose; OBB none), then every batch again with the
    kernel and with its plain version (idx/ok and every output equal), and
    P, R, mAP of each family equal from both, equal to ``YOLO.val``'s, box
    mAP50 above zero. Returns the launches and the numbers."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.utils.metrics import DetMetrics

    data = write_task_dataset(root, task)
    yolo = task_matching_model(YOLO(TASK_MODELS[task], device="cuda"), task)
    with torch.inference_mode():  # cuDNN's first-call set-up, outside the timed run
        yolo.model.eval()(torch.zeros(VAL_BATCH, 3, IMGSZ, IMGSZ, device="cuda"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-TASK_IMAGES // VAL_BATCH)
    want_nms = 0 if task == "obb" else n_batches
    check(launches == no_jpeg(fused_stem=0, pick_suppress=want_nms),
          f"{task} val: launches {launches}, expected no stem and {want_nms} NMS for {n_batches} batches")

    val = yolo._validator(imgsz=IMGSZ, batch_size=VAL_BATCH)
    sets = {k: {tag: DetMetrics(names=yolo.names) for tag in val.families} for k in ("kernel", "plain")}
    calls: list = []
    yolo.model.eval()
    for batch in val.get_dataloader(data):
        img = torch.from_numpy(batch["img"]).cuda()
        preds = val.forward(img)
        if task == "obb":  # no NMS kernel on this path: the one output serves both sets
            one = val.to_host(val.nms(preds))
            outs = {"kernel": one, "plain": one}
        else:
            outs = kernel_vs_plain(lambda: val.to_host(val.nms(preds)), calls, NMS_K_VAL, val.iou, val.max_det,
                                   f"{task} val batch {len(calls) + 1}")
        for name, metrics in sets.items():
            val.update_metrics(outs[name], batch, metrics)
    results = {}
    for name, metrics in sets.items():
        for m in metrics.values():
            m.process(nc=val.nc)
        results[name] = {tag: tuple(m.mean_results()) for tag, m in metrics.items()}
    check(results["kernel"] == results["plain"], f"{task} val: P/R/mAP differ: {results}")
    for tag, r in results["kernel"].items():  # the same model on the same batches (cuDNN may pick other sums)
        facade = tuple(res[f"metrics/{k}({tag})"] for k in ("precision", "recall", "mAP50", "mAP50-95"))
        check(max(abs(a - b) for a, b in zip(r, facade)) <= 1e-4, f"{task} val: ({tag}) {r} != YOLO.val's {facade}")
    check(results["kernel"]["B"][2] > 0, f"{task} val: box mAP50 is 0, so the comparison shows nothing")
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: val.nms(val.forward(img)), iters=3, warmup=1)
    return {"launches": launches, "img_s": TASK_IMAGES / wall, "ms": device_ms, "results": results["kernel"],
            "speed": res["metrics"]["box"].speed if isinstance(res["metrics"], dict) else res["metrics"].speed}


def phase_tasks(root: Path, card: str) -> dict:
    """The segment, pose and OBB heads at s (full width and depth), 640 px:
    (a) ``task_predict`` and (b) ``task_val`` for each. Returns each task
    path's launches (predict and val together)."""
    paths = {}
    for task in TASK_MODELS:
        p = task_predict(task, card)
        torch.cuda.empty_cache()
        v = task_val(root, task, card)
        torch.cuda.empty_cache()
        paths[task] = {k: p["launches"][k] + v["launches"][k] for k in p["launches"]}
        fam = "; ".join(f"({tag}) P/R/mAP50/mAP50-95 {tuple(round(x, 6) for x in r)}" for tag, r in v["results"].items())
        nms_note = ("NMS kernel idx/ok and outputs (" + ("masks" if task == "segment" else "keypoints")
                    + f") equal to the plain version on the fed batch ({p['kept']} kept)") if task != "obb" else \
            "rotated NMS in torch ops (no kernel)"
        print(f"phase tasks: {TASK_MODELS[task]} (a) predict {IMGSZ} bf16 B={E2E_BATCH}, {p['n_images']} images, "
              f"{p['n_det']} detections, launches {p['launches']}; stem on the fed batch max|d|/max|ref|="
              f"{p['stem_rel']:.3e} (limit 0.02), per-row max/median={p['stem_spread']:.2f} (limit 3); preds kernel "
              f"vs plain path max|d|={p['dmax']:.3e} (limit {p['bound']:.3e}) corr={p['corr']:.6f}; {nms_note}; "
              f"{p['img_s']:.1f} img/s through YOLO.predict (host clock, incl. letterbox"
              f"{' and the masks to the original size' if task == 'segment' else ''}); {p['ms']:.2f} ms/batch stem "
              f"kernel+model+NMS{'+masks' if task == 'segment' else ''} vs {p['ms_plain']:.2f} plain stem (CUDA events) "
              f"[{card}]", flush=True)
        sp = v["speed"]
        print(f"phase tasks: {TASK_MODELS[task]} (b) val {IMGSZ} f32 B={VAL_BATCH}, {TASK_IMAGES} PNG images, "
              f"launches {v['launches']}; {fam}, equal from the kernel and the plain version on every batch and to "
              f"YOLO.val's; {v['img_s']:.1f} img/s through YOLO.val (host clock, incl. dataset scan, PNG decode and "
              f"the ground-truth fill); device {v['ms']:.2f} ms/batch forward + NMS{' + masks' if task == 'segment' else ''}"
              f" (CUDA events); per image: loader wait {sp['preprocess']:.2f} ms, inference {sp['inference']:.2f} ms, "
              f"metrics {sp['postprocess']:.2f} ms [{card}]", flush=True)
    return paths


# ------------------------------------------------------------ phase task_train
TASK_TRAIN_BATCH, TASK_STEP_BATCH = 16, 4  # (b) YOLO.train: TASK_TRAIN_EPOCHS of TASK_IMAGES // 16 steps; (a) the
# card vs CPU step (the CPU's float32 and float64 steps at 640 px set the phase's time)
TASK_TRAIN_EPOCHS = 1  # (b): each epoch waits 4-7 s a step on the PNG loader, and the script has a time limit
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def task_train_data(root: Path, task: str) -> dict:
    """Phase tasks' PNG images of ``task`` as both splits, VAL_NC names; pose
    with COCO's left-right swap of its 17 keypoints, so its flips run."""
    d = {"path": str(root / task), "train": "images/val", "val": "images/val",
         "names": [f"class{i}" for i in range(VAL_NC)]}
    return {**d, "flip_idx": COCO_FLIP_IDX} if task == "pose" else d


def task_step_check(task: str, data: dict, card: str) -> dict:
    """(a) One float32 SGD step (no warmup, nbs = the batch: the step fires
    and every parameter moves; TF32 off; the assigner's overlaps in float32)
    of the task's yolo11s at IMGSZ, B=TASK_STEP_BATCH, through
    ``make_train_step`` on the card and on the CPU from the same seed weights
    and the same mosaic batch, with BatchNorm frozen (eval mode): the loss
    parts within TRAIN_TOL relative and the parameter updates within
    TRAIN_TOL of the CPU's largest update. Frozen, because with training
    BatchNorm on these flat-colour images at B=4 a float32 step was seen
    ill-posed: on the card and on the CPU alike it strayed from the float64
    step by up to 6.3e-3 of the largest update (pose). The same step with
    training BatchNorm is run and printed beside it, and each float32 step
    is printed against the float64 one on the card (the witness)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.task_losses import task_loss_for
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    d = check_det_dataset(data)
    ds = YOLODataset(d["train"], imgsz=IMGSZ, mode="train", nc=VAL_NC, task=task, flip_idx=d.get("flip_idx"),
                     device="cpu")
    batch = next(iter(DataLoader(ds, batch_size=TASK_STEP_BATCH, workers=8)))
    batch = {k: batch[k] for k in ("img", "cls", "bboxes", "mask", *task_loss_for(task, DetectionLossCfg())[1])}
    cfg = OptimCfg(optimizer="SGD", batch_size=TASK_STEP_BATCH, nbs=TASK_STEP_BATCH, epochs=2, steps_per_epoch=2,
                   nc=VAL_NC, warmup_epochs=0.0)
    sd0 = YOLO(TASK_MODELS[task], device="cpu").model.state_dict()
    weights = [k for k in sd0 if "running" not in k and "num_batches" not in k]

    def step(device: str, frozen_bn: bool, dtype=torch.float32):
        """The step's parts and weights after it; float32 through the port's
        train step, float64 by hand (forward, task loss, backward, SGD)."""
        yolo = YOLO(TASK_MODELS[task], device=device)
        yolo.model.load_state_dict(sd0)
        lcfg = DetectionLossCfg(nc=VAL_NC, strides=tuple(yolo.strides), tal_dtype="float32")
        task_loss = task_loss_for(task, lcfg)[0]
        t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if dtype == torch.float32:
            opt = Optimizer(cfg, yolo.model)
            _, m = make_train_step(yolo.model, opt, lcfg, task_loss=task_loss, frozen_bn=frozen_bn)(
                create_train_state(yolo.model, opt), t)
            check(m["finite"] and opt.count == 1, f"phase task_train (a) {task}: the {device} step did not update")
            parts = {k: float(v) for k, v in m.items() if k not in ("finite", "sync_s", "loss")}
        else:
            model = yolo.model.to(dtype).train()
            for mod in model.modules():
                if frozen_bn and isinstance(mod, torch.nn.BatchNorm2d):
                    mod.eval()
            t["bboxes"] = t["bboxes"].to(dtype)
            total, p, _ = task_loss(model(t["img"].permute(0, 3, 1, 2).to(dtype) / 255.0), t, lcfg,
                                    LossState.init(device))
            total.backward()
            params = [q for _, q in model.named_parameters()]
            Optimizer(cfg, model).step(params, [q.grad for q in params])
            parts = {k: float(v) for k, v in p.items()}
        after = {k: v.detach().cpu().double() for k, v in yolo.model.state_dict().items()}
        del yolo
        torch.cuda.empty_cache()
        return parts, after

    def distance(a, ref) -> tuple[float, float]:
        """Loss parts (relative) and updates (of ref's largest update)."""
        rel = max(abs(a[0][k] - v) / max(abs(v), 1e-12) for k, v in ref[0].items())
        largest = max(float((ref[1][k] - sd0[k].double()).abs().max()) for k in weights)
        return rel, max(float((a[1][k] - ref[1][k]).abs().max()) for k in weights) / largest

    out = {}
    for frozen in (True, False):
        t0 = time.perf_counter()
        cpu = step("cpu", frozen)
        t_cpu = time.perf_counter() - t0
        runs = {"card": step("cuda", frozen), "CPU": cpu, "float64": step("cuda", frozen, torch.float64)}
        check(runs["card"][0]["fg_count"] == runs["CPU"][0]["fg_count"] > 0, f"phase task_train (a) {task}: fg counts")
        out["frozen" if frozen else "training"] = {
            "card_cpu": distance(runs["card"], runs["CPU"]), "card_f64": distance(runs["card"], runs["float64"]),
            "cpu_f64": distance(runs["CPU"], runs["float64"]), "parts": runs["card"][0], "cpu_s": t_cpu}
    rel, du = out["frozen"]["card_cpu"]
    check(rel <= TRAIN_TOL, f"phase task_train (a) {task}: loss parts card vs CPU differ by {rel:.3e}")
    check(du <= TRAIN_TOL, f"phase task_train (a) {task}: the updates card vs CPU differ by {du:.3e} of the largest")
    return {**out, "batch": batch}


def task_step_ms(task: str, batch: dict) -> float:
    """The task's bf16 train step (forward + task loss + backward + clip +
    AdamW + EMA, with its host sync) at B=TASK_TRAIN_BATCH on the card, on
    (a)'s batch repeated to that size: CUDA events over 5 steps after 2."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.task_losses import task_loss_for
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    reps = TASK_TRAIN_BATCH // int(batch["img"].shape[0])
    batch = {k: torch.from_numpy(np.concatenate([v] * reps)).cuda() for k, v in batch.items()}
    yolo = YOLO(TASK_MODELS[task], device="cuda")
    b = int(batch["img"].shape[0])
    opt = Optimizer(OptimCfg(optimizer="AdamW", batch_size=b, nbs=b, nc=VAL_NC), yolo.model)
    state = create_train_state(yolo.model, opt)
    lcfg = DetectionLossCfg(nc=VAL_NC, strides=tuple(yolo.strides))
    step = make_train_step(yolo.model, opt, lcfg, bf16=True, task_loss=task_loss_for(task, lcfg)[0])
    ms = cuda_ms(lambda: step(state, batch), iters=5, warmup=2)
    del yolo, opt, state, step
    torch.cuda.empty_cache()
    return ms


def task_train_run(root: Path, task: str, card: str, step_batch: dict) -> dict:
    """(b) ``YOLO.train`` of the task's yolo11s from phase tasks' matching
    weights for TASK_TRAIN_EPOCHS of TASK_IMAGES // TASK_TRAIN_BATCH steps (bf16,
    AdamW from "auto", B=TASK_TRAIN_BATCH;
    mosaic on for segment and pose, off for OBB; ``copy_paste=0.5`` on
    segment), counts at 0: finite losses, one results.csv row an epoch with
    the task validator's metrics (run on the EMA model), last and best
    written; the NMS kernel once a val batch (segment, pose; OBB none) and
    equal to its plain version on every val batch of every epoch (the preds
    kept through a wrapper of the validator's ``nms``); ``best`` reloaded
    keeps the task and the keypoint shape and gives the run's fitness; (c)
    ``task_step_ms`` on (a)'s batch. Returns the launches and the numbers."""
    import csv as _csv

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.seg_validator import SegmentationValidator
    from fce_yolo_tpu_torch.engine.task_validators import OBBValidator, PoseValidator

    data = task_train_data(root, task)
    cls = {"segment": SegmentationValidator, "pose": PoseValidator, "obb": OBBValidator}[task]
    yolo = task_matching_model(YOLO(TASK_MODELS[task], device="cuda"), task)  # phase tasks' weights: mAP above 0
    captured: list = []
    real_nms = cls.nms

    def capturing_nms(self, preds):  # keeps each val batch's input to NMS for the check after the run
        captured.append({k: v.detach().clone() if torch.is_tensor(v) else v for k, v in preds.items()}
                        if isinstance(preds, dict) else preds.detach().clone())
        return real_nms(self, preds)

    epochs, n_val = TASK_TRAIN_EPOCHS, -(-TASK_IMAGES // TASK_TRAIN_BATCH)
    extra = {"copy_paste": 0.5} if task == "segment" else {}
    cls.nms = capturing_nms
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = yolo.train(data, epochs=epochs, batch=TASK_TRAIN_BATCH, imgsz=IMGSZ, project=str(root / "runs"),
                         name=f"{task}_train", close_mosaic=0 if task != "obb" else epochs, verbose=True, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        cls.nms = real_nms
    want_nms = 0 if task == "obb" else n_val * epochs
    check(launches == no_jpeg(fused_stem=0, pick_suppress=want_nms, jpeg_fdct=train_plots(n_val)),
          f"{task} train path: launches {launches}, expected no stem, {want_nms} NMS and {n_val} mosaics written")
    rows = res["results"]
    check(res["epochs_run"] == len(rows) == epochs, f"{task} train ran {res['epochs_run']} epochs")
    check(all(np.isfinite(r[k]) for r in rows for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")),
          f"{task} train: a logged loss is not finite {rows}")
    fams = {"segment": ("B", "M"), "pose": ("B", "P"), "obb": ("B",)}[task]
    check(all(f"metrics/mAP50-95({t})" in r and "fitness" in r for r in rows for t in fams),
          f"{task} train: the task validator's metrics are missing {rows}")
    save_dir = Path(res["save_dir"])
    with open(save_dir / "results.csv") as f:
        check(len(list(_csv.DictReader(f))) == epochs, f"{task} train: results.csv rows")
    check(len(captured) == n_val * epochs, f"{task} train: {len(captured)} val batches seen")
    val = yolo._validator(imgsz=IMGSZ, batch_size=TASK_TRAIN_BATCH)  # the run's NMS settings
    calls: list = []
    if task != "obb":
        for preds in captured:
            kernel_vs_plain(lambda: val.to_host(val.nms(preds)), calls, NMS_K_VAL, val.iou, val.max_det,
                            f"{task} train val batch {len(calls) + 1}")
    del captured
    best = save_dir / "weights" / "best"
    again = YOLO(str(best), device="cuda")
    check(again.task == task, f"{task}: best reloads as {again.task}")
    if task == "pose":
        check(again.model.detect.kpt_shape == yolo.model.detect.kpt_shape == (17, 3), "pose: kpt_shape lost")
    rerun = again.val(data, imgsz=IMGSZ, batch=TASK_TRAIN_BATCH, verbose=False)
    best_fit = max(r["fitness"] for r in rows)
    check(abs(rerun["fitness"] - best_fit) <= 1e-6, f"{task}: best reloaded fitness {rerun['fitness']} vs {best_fit}")
    del again, yolo
    torch.cuda.empty_cache()
    step_ms = task_step_ms(task, step_batch)
    return {"launches": launches, "rows": rows, "speed": res["speed"], "wall": wall, "step_ms": step_ms,
            "n_nms_checked": len(calls), "refit": rerun["fitness"], "best_fit": best_fit}


def phase_task_train(root: Path, card: str) -> dict:
    """Training of the segment, pose and OBB heads at s (full width and
    depth), 640 px, on phase tasks' PNG images: (a) ``task_step_check``,
    (b) and (c) ``task_train_run``, for each. Returns each train path's
    launches, keyed "<task>_train"."""
    t_phase = time.perf_counter()
    paths = {}
    for task in TASK_MODELS:
        a = task_step_check(task, task_train_data(root, task), card)
        r = task_train_run(root, task, card, a.pop("batch"))
        paths[f"{task}_train"] = r["launches"]
        for bn in ("frozen", "training"):
            x = a[bn]
            parts = " ".join(f"{k} {v:.5f}" for k, v in x["parts"].items())
            note = f"limit {TRAIN_TOL} each" if bn == "frozen" else "not checked"
            print(f"phase task_train: {TASK_MODELS[task]} (a) one f32 SGD step {IMGSZ} B={TASK_STEP_BATCH}, {bn} BN: "
                  f"card vs CPU loss parts max rel {x['card_cpu'][0]:.2e}, updates {x['card_cpu'][1]:.2e} of the CPU's "
                  f"largest ({note}); witness against the float64 step on the card (parts, updates): card "
                  f"{x['card_f64'][0]:.2e} {x['card_f64'][1]:.2e}, CPU {x['cpu_f64'][0]:.2e} {x['cpu_f64'][1]:.2e}; "
                  f"card parts {parts}; CPU step {x['cpu_s']:.1f} s [{card}]", flush=True)
        for e, (row, sp) in enumerate(zip(r["rows"], r["speed"])):
            fam = " ".join(f"mAP50({t}) {row[f'metrics/mAP50({t})']:.6f}" for t in ("B", "M", "P")
                           if f"metrics/mAP50({t})" in row)
            print(f"phase task_train: {TASK_MODELS[task]} (b) epoch {e + 1}/{TASK_TRAIN_EPOCHS}: loss box/cls/dfl "
                  f"{row['train/box_loss']:.4f}/{row['train/cls_loss']:.4f}/{row['train/dfl_loss']:.4f}, {fam}, "
                  f"fitness {row['fitness']:.6f}; {sp['img_per_s']:.2f} img/s; per step: loader wait "
                  f"{sp['loader_wait_ms']:.1f} ms, step call {sp['step_ms']:.1f} ms (host clock); val {sp['val_s']:.2f} s "
                  f"[{card}]", flush=True)
        nms_note = (f"NMS kernel idx/ok and outputs equal to the plain version on all {r['n_nms_checked']} val batches"
                    if task != "obb" else "rotated NMS in torch ops (no kernel)")
        print(f"phase task_train: {TASK_MODELS[task]} (b) YOLO.train {IMGSZ} bf16 B={TASK_TRAIN_BATCH} AdamW, "
              f"{TASK_TRAIN_EPOCHS} epoch(s) of {TASK_IMAGES // TASK_TRAIN_BATCH} steps{', copy_paste 0.5' if task == 'segment' else ''}"
              f"{', no mosaic' if task == 'obb' else ''}, launches {r['launches']}; {nms_note}; best reloaded: fitness "
              f"{r['refit']:.6f} vs {r['best_fit']:.6f}; {r['wall']:.1f} s in all; (c) step on the card bf16 "
              f"B={TASK_TRAIN_BATCH} {r['step_ms']:.1f} ms (CUDA events) [{card}]", flush=True)
    print(f"phase task_train: every check passed; {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths



# ------------------------------------------------------------ phase track
TRACK_FRAMES, TRACK_H, TRACK_W = 48, 720, 1280
TRACK_PAN = 3  # px a frame: the camera pans right for half the frames, then back
TRACK_RECTS = [  # world box on frame 0 (x1, y1, x2, y2), world velocity (px a frame), BGR; the class is the index
    ((100, 150, 260, 270), (14, 0), (40, 40, 230)),  # crosses the next one near frame 32
    ((1000, 200, 1180, 320), (-14, 0), (40, 230, 40)),
    ((600, 450, 780, 600), (0, 0), (230, 40, 40)),  # still in the world
    ((45, 560, 85, 620), (0, 0), (230, 230, 40)),  # out of view on frames 16-32 as the camera pans
]
GMC_TOL = 0.1  # px: the GMC's translation against the pan


def track_pan(t: int) -> int:
    """The camera's x offset in the world on frame ``t``."""
    return TRACK_PAN * min(t, TRACK_FRAMES - t)


def track_scene() -> tuple[list[np.ndarray], list[tuple[np.ndarray, np.ndarray]]]:
    """``TRACK_FRAMES`` BGR frames of TRACK_H x TRACK_W: a textured world
    (random colours every 4 px, interpolated, and noise) seen through
    ``augment.warp_affine`` at the camera's offset, with ``TRACK_RECTS``
    painted on; and per frame the true boxes (N, 4) and classes (N,) of the
    rectangles wholly in view."""
    from fce_yolo_tpu_torch.data.augment import resize_linear, warp_affine

    rng = np.random.RandomState(SEED + 7)
    world_w = TRACK_W + TRACK_PAN * TRACK_FRAMES // 2 + 16
    coarse = rng.randint(0, 256, (TRACK_H // 4 + 2, world_w // 4 + 2, 3), np.uint8)
    world = resize_linear(coarse, (world_w, TRACK_H)).astype(np.int32)
    world = np.clip(world + rng.randint(-6, 7, world.shape), 0, 255).astype(np.uint8)
    views: dict[int, np.ndarray] = {}
    frames, truth = [], []
    for t in range(TRACK_FRAMES):
        pan = track_pan(t)
        if pan not in views:  # the pan goes there and back: each view is warped once
            views[pan] = warp_affine(world, np.array([[1.0, 0, -pan], [0, 1, 0]]), (TRACK_W, TRACK_H))
        img = views[pan].copy()
        boxes, classes = [], []
        for k, ((x1, y1, x2, y2), (vx, vy), color) in enumerate(TRACK_RECTS):
            dx, dy = vx * t - pan, vy * t
            bx = (x1 + dx, y1 + dy, x2 + dx, y2 + dy)
            img[max(bx[1], 0): max(bx[3], 0), max(bx[0], 0): max(bx[2], 0)] = color
            if bx[0] >= 0 and bx[1] >= 0 and bx[2] <= TRACK_W and bx[3] <= TRACK_H:
                boxes.append(bx)
                classes.append(k)
        frames.append(img)
        truth.append((np.array(boxes, float), np.array(classes, float)))
    return frames, truth


class TrackTimers:
    """Host-clock time of ``GMC.apply``, ``BYTETracker.update`` (BoT-SORT's
    too) and the facade's ``embed`` while installed, and every warp the GMC
    returned."""

    def __init__(self, yolo):
        from fce_yolo_tpu_torch.trackers import GMC, BYTETracker

        self.yolo, self.classes = yolo, (GMC, BYTETracker)
        self.real = (GMC.apply, BYTETracker.update, yolo.embed)
        self.reset()

    def reset(self) -> None:
        self.s = {"gmc": 0.0, "update": 0.0, "embed": 0.0}
        self.warps: list[np.ndarray] = []

    def _timed(self, key: str, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.s[key] += time.perf_counter() - t0
            if key == "gmc":
                self.warps.append(out)
            return out
        return run

    def __enter__(self) -> "TrackTimers":
        gmc, tracker = self.classes
        gmc.apply = self._timed("gmc", self.real[0])
        tracker.update = self._timed("update", self.real[1])
        self.yolo.embed = self._timed("embed", self.real[2])
        return self

    def __exit__(self, *exc) -> None:
        gmc, tracker = self.classes
        gmc.apply, tracker.update = self.real[:2]
        del self.yolo.embed


def track_truth(frames, truth, timers: TrackTimers, card: str) -> None:
    """The rectangles' true boxes (score 0.9, class = rectangle) through
    ByteTrack and BoT-SORT with the GMC on the host: each rectangle keeps one
    id through the pan and the crossing (under ByteTrack the one the pan
    takes out of view comes back under a new id: nothing there follows the
    camera); the GMC's warp is the pan within GMC_TOL px, its 2x2 part the
    identity within 1e-3."""
    from fce_yolo_tpu_torch.trackers import build_tracker

    notes = []
    for name in ("bytetrack.yaml", "botsort.yaml"):
        tk = build_tracker(name)
        timers.reset()
        ids: dict[int, set] = {k: set() for k in range(len(TRACK_RECTS))}
        seen, shown = np.zeros(len(TRACK_RECTS), int), np.zeros(len(TRACK_RECTS), int)
        for img, (boxes, classes) in zip(frames, truth):
            out = tk.update(boxes, np.full(len(boxes), 0.9), classes, img=img)
            seen[classes.astype(int)] += 1
            for row in out:
                ids[int(row[6])].add(int(row[4]))
                shown[int(row[6])] += 1
        keep = range(len(TRACK_RECTS)) if name == "botsort.yaml" else range(len(TRACK_RECTS) - 1)
        check(all(len(ids[k]) == 1 for k in keep), f"truth {name}: a rectangle changed its id: {ids}")
        # a new track shows from its second frame
        check(bool((shown >= seen - len(ids[len(TRACK_RECTS) - 1])).all()), f"truth {name}: tracked {shown} of {seen}")
        notes.append(f"{name} ids by rectangle {[sorted(v) for v in ids.values()]}")
    warps = np.stack(timers.warps)
    want = np.array([track_pan(t - 1) - track_pan(t) for t in range(1, len(frames))], float)
    dt = np.abs(warps[1:, 0, 2] - want).max()
    dy = np.abs(warps[1:, 1, 2]).max()
    dr = np.abs(warps[1:, :, :2] - np.eye(2)).max()
    check(max(dt, dy) <= GMC_TOL and dr <= 1e-3,
          f"GMC: translation off the pan by {dt:.4f} / {dy:.4f} px (limit {GMC_TOL}), 2x2 off by {dr:.2e}")
    print(f"phase track: true boxes on the host: {'; '.join(notes)}; GMC warp against the {TRACK_PAN} px pan: "
          f"x within {dt:.4f} px, y within {dy:.4f} px (limit {GMC_TOL}), 2x2 within {dr:.2e} of the identity "
          f"(limit 1e-3); GMC {timers.s['gmc'] * 1e3 / len(frames):.1f} ms a frame (host clock) [{card}]", flush=True)


def phase_track(root: Path, card: str) -> tuple[dict, dict]:
    """``YOLO.track`` of yolo11s-fce at 640 px, bf16, ``matching_model``'s
    weights (up to 300 detections a frame above 0.1), one frame a batch, on
    ``track_scene``'s frames: ByteTrack, BoT-SORT with the GMC and BoT-SORT
    with ReID through ``YOLO.embed``, with the counts at 0 (the stem and the
    NMS kernel once a frame); ByteTrack again with the plain NMS swapped
    into ``ops.nms``: the same tracks bit for bit, and the kernel bit-equal
    to the plain version on every frame's candidates; the stem kernel on a
    fed frame at B=1 against its plain version and timed beside cuDNN; the
    true boxes through the trackers (``track_truth``). Returns (the track
    path's launches, the stem's B=1 numbers)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.augment import letterbox
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.ops import nms as nms_ops
    from fce_yolo_tpu_torch.ops.nms import batched_nms
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model

    t_phase = time.perf_counter()
    frames, truth = track_scene()
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda")).to(torch.bfloat16)
    reid = root / "botsort_reid.yaml"
    cfg = (Path(__file__).resolve().parent / "fce_yolo_tpu_torch" / "trackers" / "cfg" / "botsort.yaml").read_text()
    reid.write_text(cfg.replace("with_reid: False", "with_reid: True"))
    trackers = {"bytetrack": "bytetrack.yaml", "botsort": "botsort.yaml", "botsort+reid": str(reid)}
    yolo.track(frames[:2], tracker=str(reid), imgsz=IMGSZ)  # warm-up: the folded copy, cuDNN's set-up
    torch.cuda.synchronize()

    def run(tracker: str, timers: TrackTimers) -> tuple[list, dict]:
        timers.reset()
        out, n_det = [], 0
        t0 = time.perf_counter()
        for res, tracks in yolo.track(frames, tracker=tracker, imgsz=IMGSZ, stream=True):
            n_det += len(res)
            out.append(tracks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(frames)
        check(len(out) == n, f"{tracker}: {len(out)} frames of tracks for {n}")
        for tracks in out:
            check(tracks.ndim == 2 and tracks.shape[1] == 7 and bool(np.isfinite(tracks).all()), f"{tracker}: tracks")
            check(bool((tracks[:, 4] >= 1).all()) and len(set(tracks[:, 4].tolist())) == len(tracks),
                  f"{tracker}: track ids not distinct positive integers")
        s = timers.s
        return out, {"fps": n / wall, "predict": (wall - s["update"]) * 1e3 / n, "gmc": s["gmc"] * 1e3 / n,
                     "embed": s["embed"] * 1e3 / n, "assoc": (s["update"] - s["gmc"] - s["embed"]) * 1e3 / n,
                     "det": n_det / n, "tracks": sum(len(x) for x in out) / n,
                     "ids": len({i for x in out for i in x[:, 4].tolist()})}

    with TrackTimers(yolo) as timers:
        reset_launches()
        runs = {name: run(tracker, timers) for name, tracker in trackers.items()}
        launches = read_launches()
        n = len(frames) * len(trackers)
        check(launches == no_jpeg(fused_stem=n, pick_suppress=n),
              f"track path: {launches}, expected the stem and the NMS kernel once for each of {n} frames")

        calls: list = []
        real = nms_ops.pick_suppress

        def plain(boxes, scores, valid, iou_thres, max_det):
            out = nms_ops.pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)
            calls.append(((boxes.clone(), scores.clone(), valid.clone()), out, iou_thres, max_det))
            return out

        try:
            nms_ops.pick_suppress = plain
            plain_tracks, _ = run(trackers["bytetrack"], timers)
        finally:
            nms_ops.pick_suppress = real
        check(len(calls) == len(frames), f"plain path: {len(calls)} NMS calls for {len(frames)} frames")
        for t, ((args, (ip, op), iou, max_det), a, b) in enumerate(zip(calls, runs["bytetrack"][0], plain_tracks)):
            check(tuple(args[0].shape) == (1, NMS_K, 4), f"frame {t}: NMS ran on {tuple(args[0].shape)}")
            ik, ok = real(*args, iou_thres=iou, max_det=max_det)
            check(bool((ik == ip).all() and (ok == op).all()), f"frame {t}: NMS kernel differs from the plain version")
            check(np.array_equal(a, b), f"frame {t}: the kernel path's tracks differ from the plain NMS path's")
        kept = int(calls[0][1][1].sum())
        args = calls[0][0]
        with torch.inference_mode():
            nms_ms = graph_ms(lambda: real(*args, iou_thres=0.7, max_det=MAX_DET))
            nms_plain_ms = cuda_ms(lambda: nms_ops.pick_suppress_reference(*args, 0.7, MAX_DET), iters=3, warmup=1)
        nms_bound_ms, nms_bound_by = nms_bound(1, NMS_K, kept)

        track_truth(frames, truth, timers, card)

    model = yolo._inference_model()
    spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
    x = torch.from_numpy(np.ascontiguousarray(letterbox(frames[0], IMGSZ, scaleup=False)[0][..., ::-1])[None]).cuda()
    stem = time_stem(model, spec, 1, card, f"s, frame 0 of {TRACK_H}x{TRACK_W} as fed,", x=x, phase="track")
    x_nchw = (x.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    predictor = DetectionPredictor(model, yolo.names, imgsz=IMGSZ, conf=0.1, batch_size=1)
    with torch.inference_mode():
        dev_ms = cuda_ms(lambda: predictor.infer(x), iters=10)
        dev_plain_ms = cuda_ms(lambda: batched_nms(model(x_nchw)["preds"], conf_thres=0.1, iou_thres=0.7,
                                                   multi_label=False), iters=10)
    print(f"phase track: yolo11s-fce {IMGSZ} bf16, {len(frames)} frames of {TRACK_H}x{TRACK_W} a run, one a batch, "
          f"conf 0.1; launches over the {len(trackers)} runs {launches}; NMS kernel idx/ok equal to the plain "
          f"version on all {len(calls)} frames (B=1, K={NMS_K}) and ByteTrack's tracks bit-equal through both; "
          f"NMS kernel at B=1 {nms_ms:.4f} ms ({kept} picks; CUDA graph; bound {nms_bound_ms:.4f} ms, "
          f"{nms_bound_by}; plain {nms_plain_ms:.2f} ms); device B=1 {dev_ms:.2f} ms stem kernel+model+NMS vs "
          f"{dev_plain_ms:.2f} ms plain stem (CUDA events) [{card}]", flush=True)
    for name, (_, r) in runs.items():
        print(f"phase track: {name}: {r['fps']:.2f} frames/s through YOLO.track; ms a frame (host clock): predict "
              f"{r['predict']:.1f}, GMC {r['gmc']:.1f}, ReID embed {r['embed']:.1f}, association {r['assoc']:.1f}; "
              f"{r['det']:.1f} detections and {r['tracks']:.1f} tracks a frame, {r['ids']} ids [{card}]", flush=True)
    print(f"phase track: every check passed; {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches, {"track_b1_ms": stem["ms"], "track_b1_library_ms": stem["library_ms"],
                      "track_b1_plain_ms": stem["plain_ms"], "track_b1_bound_ms": stem["bound_ms"]}, frames


# ------------------------------------------------------------ phase solutions
SOLUTION_FRAMES = 6  # phase solutions (a): the first frames of track_scene, each app run twice (cut from 8 for time)
SEARCH_IMAGES, CLIP_IMAGES = 16, 8  # (c): the first of phase jpeg's JPEGs (the CPU index decodes in Python)
CLIP_TOL = 1e-4  # (c) the CLIP towers' embeddings, card vs CPU (float32 in both, TF32 off)


def solution_apps(root: Path) -> dict[str, tuple[str, dict]]:
    """The 15 ``BaseSolution`` apps on phase track's 1280x720 scene: (the
    model's task, keywords). Regions, lines and slots span the frame."""
    return {
        "ObjectCounter": ("detect", {"region": [(640, 0), (640, 720)]}),
        "Heatmap": ("detect", {"region": [(0, 360), (1280, 360)]}),
        "RegionCounter": ("detect", {"regions": {"left": [(0, 0), (640, 0), (640, 720), (0, 720)],
                                                 "centre": [(320, 180), (960, 180), (960, 540), (320, 540)]}}),
        "SpeedEstimator": ("detect", {}),
        "TrackZone": ("detect", {"region": [(200, 100), (1080, 100), (1080, 620), (200, 620)]}),
        "QueueManager": ("detect", {"region": [(100, 400), (700, 400), (700, 700), (100, 700)]}),
        "ParkingManagement": ("detect", {"slots": [[(x, y), (x + 300, y), (x + 300, y + 300), (x, y + 300)]
                                                   for x in (40, 480, 920) for y in (40, 380)]}),
        "VisionEye": ("detect", {}),
        "ObjectBlurrer": ("detect", {}),
        "ObjectCropper": ("detect", {"crop_dir": str(root / "solution_crops")}),
        "InstanceSegmentation": ("segment", {}),
        "Analytics": ("detect", {"analytics_type": "bar", "update_every": 4}),
        "DistanceCalculation": ("detect", {}),
        "SecurityAlarm": ("detect", {"records": 5}),
        "AIGym": ("pose", {}),
    }


def solution_fields(res) -> dict:
    return {k: v for k, v in vars(res).items() if k not in ("plot_im", "speed")}


def solution_run(name: str, model, kw: dict, frames: list) -> tuple[list, list]:
    """One app over ``frames`` through its ``__call__``: (its results, the
    tracks ``process`` saw each frame)."""
    import fce_yolo_tpu_torch.solutions as S

    sol = getattr(S, name)(model=model, **kw)
    seen = []
    real = sol.process
    sol.process = lambda res, tracks: (seen.append(tracks), real(res, tracks))[1]
    out = list(sol(frames))
    torch.cuda.synchronize()
    check(len(out) == len(seen) == len(frames), f"{name}: {len(out)} results for {len(frames)} frames")
    return out, seen


def phase_solutions(root: Path, frames: list, short_avi: Path, card: str) -> dict:
    """The solutions layer (``fce_yolo_tpu_torch/solutions/``) on the card:
    (a) each of the 15 ``BaseSolution`` apps through ``__call__`` on
    SOLUTION_FRAMES of phase track's 720x1280 frames, at the solutions'
    conf 0.25, bf16 yolo11s-fce with ``matching_model``'s weights (``AIGym``
    yolo11s-pose, ``InstanceSegmentation`` yolo11s-seg, with
    ``task_matching_model``'s), the counts at 0: the stem and NMS kernels once
    a frame, ``jpeg_fdct`` once a crop ``ObjectCropper`` writes; then each app
    again with the plain NMS swapped into ``ops.nms``: every frame's tracks,
    result fields and ``plot_im`` equal bit for bit; ms a frame of tracking
    and of the app (host clock);
    (b) ``entrypoint(["solutions", "count", "source=<the short AVI>",
    "save_dir=..."])`` in process (the CLI's default yolo11n.yaml, float32, on
    the card): a JPEG a frame, each decoded at 720x1280 on the card, the
    JPEG kernels and NMS once a frame;
    (c) ``VisualAISearch`` on SEARCH_IMAGES of phase jpeg's JPEGs: the HSV
    index on the card equal to the one built with ``device="cpu"``, and the
    top-5 of three queries; the CLIP backend (seeded ViT-B/32 towers) on the
    card within CLIP_TOL of the CPU's on CLIP_IMAGES images and a text query.
    Returns each part's launches, keyed by path."""
    import shutil

    import fce_yolo_tpu_torch.solutions as S
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.cfg import entrypoint
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.ops import nms as nms_ops

    t_phase = time.perf_counter()
    frames = frames[:SOLUTION_FRAMES]
    n = len(frames)
    models = {"detect": matching_model(YOLO("yolo11s-fce.yaml", device="cuda")).to(torch.bfloat16),
              "segment": task_matching_model(YOLO(TASK_MODELS["segment"], device="cuda"), "segment").to(
                  torch.bfloat16),
              "pose": task_matching_model(YOLO(TASK_MODELS["pose"], device="cuda"), "pose").to(torch.bfloat16)}
    for m in models.values():
        m.predict(frames[:1], imgsz=IMGSZ)  # warm-up: the folded copy, cuDNN's set-up
    apps = solution_apps(root)
    torch.cuda.synchronize()

    # (a) every app on the kernels, the counts at 0
    reset_launches()
    t0 = time.perf_counter()
    runs = {name: solution_run(name, models[task], kw, frames) for name, (task, kw) in apps.items()}
    wall = time.perf_counter() - t0
    launches = read_launches()
    crops = runs["ObjectCropper"][0][-1].total_crop_objects
    check(launches == no_jpeg(fused_stem=n * len(apps), pick_suppress=n * len(apps), jpeg_fdct=crops),
          f"solutions path: {launches}, expected the stem and NMS kernels once for each of {n} frames of "
          f"{len(apps)} apps and jpeg_fdct once for each of {crops} crops")
    check(len(list((root / "solution_crops").glob("*.jpg"))) == crops, "ObjectCropper: crops written")
    tracked = {name: sum(len(t) for t in seen) / n for name, (_, seen) in runs.items()}
    check(min(tracked.values()) > 0, f"solutions: an app saw no tracks: {tracked}")

    # ... and again with the plain NMS: the same tracks, fields and frames
    real = nms_ops.pick_suppress
    shutil.rmtree(root / "solution_crops")
    try:
        nms_ops.pick_suppress = lambda boxes, scores, valid, iou_thres, max_det: nms_ops.pick_suppress_reference(
            boxes, scores, valid, iou_thres, max_det)
        for name, (task, kw) in apps.items():
            out, seen = solution_run(name, models[task], kw, frames)
            ref_out, ref_seen = runs[name]
            for t in range(n):
                check(np.array_equal(seen[t], ref_seen[t]), f"{name} frame {t}: tracks differ on the plain NMS path")
                check(solution_fields(out[t]) == solution_fields(ref_out[t]),
                      f"{name} frame {t}: {solution_fields(out[t])} on the plain NMS path, "
                      f"{solution_fields(ref_out[t])} on the kernel's")
                check(out[t].plot_im is not None and np.array_equal(out[t].plot_im, ref_out[t].plot_im),
                      f"{name} frame {t}: plot_im differs on the plain NMS path")
    finally:
        nms_ops.pick_suppress = real
    def brief(res) -> str:  # the last frame's fields, long ones by their length
        return ", ".join(f"{k}={len(v) if isinstance(v, (list, dict)) and len(v) > 4 else v}"
                         for k, v in solution_fields(res).items() if v not in (None, 0, 0.0, False, {}))

    last = {name: brief(out[-1]) for name, (out, _) in runs.items()}
    print(f"phase solutions (a): {len(apps)} apps x {n} frames of {TRACK_H}x{TRACK_W} through __call__, bf16 "
          f"yolo11s-fce/-seg/-pose {IMGSZ} px, conf 0.25; launches {launches}; tracks, every result field and "
          f"plot_im bit-equal on the plain NMS path for all {n * len(apps)} frames; {wall:.1f} s for the kernel "
          f"run [{card}]", flush=True)
    for name, (out, _) in runs.items():
        tr = [r.speed["track"] for r in out]
        so = [r.speed["solution"] for r in out]
        print(f"phase solutions (a): {name}: ms a frame (host clock) track {np.mean(tr):.1f} "
              f"(min {min(tr):.1f}, max {max(tr):.1f}), solution {np.mean(so):.1f} (min {min(so):.1f}, "
              f"max {max(so):.1f}); {tracked[name]:.1f} tracks a frame; last frame: {last[name]} [{card}]",
              flush=True)

    # (b) the command line on the short AVI
    save_dir = root / "solutions_cli"
    reset_launches()
    t0 = time.perf_counter()
    results = entrypoint(["solutions", "count", f"source={short_avi}", f"save_dir={save_dir}"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli = read_launches()
    written = sorted(save_dir.glob("*.jpg"))
    nv = VIDEO_OBB_FRAMES
    check(len(results) == nv and [p.name for p in written] == [f"{i:06d}.jpg" for i in range(nv)],
          f"solutions CLI: {len(results)} results, files {[p.name for p in written]}")
    check(cli == {"fused_stem": 0, "pick_suppress": nv, "jpeg_idct": nv, "jpeg_color": nv, "jpeg_fdct": nv,
                  "webp_color": 0}, f"solutions CLI: launches {cli}")
    for p in written:
        check(imread(p, device="cuda").shape == (TRACK_H, TRACK_W, 3), f"solutions CLI: {p.name} reads back")
    print(f"phase solutions (b): solutions count on the {nv}-frame AVI (yolo11n.yaml f32 on the card): "
          f"{len(written)} JPEGs written and read back at {TRACK_H}x{TRACK_W}; launches {cli}; {cli_s:.1f} s, "
          f"{cli_s * 1e3 / nv:.1f} ms a frame (host clock) [{card}]", flush=True)

    # (c) visual search on the card against the CPU
    src = sorted((root / "jpeg" / "images" / "val").glob("*.jpg"))
    hsv_dir, clip_dir = root / "search_hsv", root / "search_clip"
    for d, n_img in ((hsv_dir, SEARCH_IMAGES), (clip_dir, CLIP_IMAGES)):
        d.mkdir()
        for p in src[:n_img]:
            shutil.copy(p, d / p.name)
    reset_launches()
    t0 = time.perf_counter()
    card_idx = S.VisualAISearch(str(hsv_dir), device="cuda")
    hsv_s = time.perf_counter() - t0
    search = read_launches()
    n_idx = len(card_idx.paths)
    check(n_idx == SEARCH_IMAGES and search == {"fused_stem": 0, "pick_suppress": 0, "jpeg_idct": n_idx,
                                                "jpeg_color": n_idx, "jpeg_fdct": 0, "webp_color": 0},
          f"search: {n_idx} images indexed, launches {search}")
    cpu_idx = S.VisualAISearch(str(hsv_dir), device="cpu")
    check(np.array_equal(card_idx.feats, cpu_idx.feats), "search: the HSV index on the card differs from the CPU's")
    for q in (card_idx.paths[0], card_idx.paths[5], card_idx.paths[-1]):
        check(card_idx.search(q) == cpu_idx.search(q), f"search: top-5 of {q.name} differ")
    top = card_idx.search(card_idx.paths[5])
    check(Path(top[0][0]).name == card_idx.paths[5].name or top[0][1] == top[1][1], "search: a query's own image")
    t0 = time.perf_counter()
    clip_card = S.VisualAISearch(str(clip_dir), backend="clip", device="cuda")
    clip_s = time.perf_counter() - t0
    clip_cpu = S.VisualAISearch(str(clip_dir), backend="clip", device="cpu")
    d_img = float(np.abs(clip_card.feats - clip_cpu.feats).max())
    text = "a red rectangle on grey"
    d_txt = float(np.abs(clip_card._clip[0].encode_text([text]) - clip_cpu._clip[0].encode_text([text])).max())
    check(d_img <= CLIP_TOL and d_txt <= CLIP_TOL, f"search CLIP: card vs CPU {d_img:.3e} images, {d_txt:.3e} text")
    print(f"phase solutions (c): VisualAISearch HSV on {n_idx} JPEGs: index equal to the CPU's, top-5 of 3 queries "
          f"equal, {hsv_s * 1e3 / n_idx:.1f} ms an image (decode on the card + histogram), launches {search}; CLIP "
          f"(seeded ViT-B/32) on {CLIP_IMAGES} images: card vs CPU within {d_img:.3e} (images), {d_txt:.3e} "
          f"(text; limit {CLIP_TOL}), {clip_s * 1e3 / CLIP_IMAGES:.1f} ms an image with the towers' set-up "
          f"[{card}]", flush=True)
    print(f"phase solutions: every check passed; {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"solutions": launches, "solutions_cli": cli, "solutions_search": search}


# ------------------------------------------------------------ phase video
VIDEO_QUALITY = 90  # the AVI's frames: baseline 4:2:0 at this quality
VIDEO_OBB_FRAMES = 8  # the OBB track and the classify predict read the first frames as a short AVI


def video_frame(job: tuple[np.ndarray, bool]) -> tuple[bytes, np.ndarray]:
    """A worker's job in phase video: one BGR frame -> (its baseline JPEG,
    without DHT if asked; the plain decoder's image of those bytes)."""
    from fce_yolo_tpu_torch.data.jpeg import decode_jpeg_reference

    frame, no_dht = job
    buf = jpeg_bytes(np.ascontiguousarray(frame[..., ::-1]), VIDEO_QUALITY, "420")
    if no_dht:
        buf = strip_dht(buf)
    return buf, decode_jpeg_reference(buf)


def write_video(root: Path, frames: list) -> tuple[Path, Path, list, int]:
    """``frames`` as an MJPEG AVI (frame 0 without DHT, frames 1-2 in a
    ``LIST rec `` group, frame 3 odd-sized: a byte after its EOI) and its
    first VIDEO_OBB_FRAMES as a second one; the JPEGs are written and
    decoded by the plain path in spawned worker processes (the numpy writer
    and the Python entropy decode take ~0.5 s a 720x1280 frame each).
    Returns (path, short path, the plain decoder's frames, bytes)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        out = list(pool.map(video_frame, [(f, i == 0) for i, f in enumerate(frames)]))
    jpgs, plain = [b for b, _ in out], [img for _, img in out]
    if len(jpgs[3]) % 2 == 0:
        jpgs[3] += b"\0"
    h, w = frames[0].shape[:2]
    path, short = root / "video.avi", root / "video_short.avi"
    path.write_bytes(avi_bytes([jpgs[0], jpgs[1:3], *jpgs[3:]], w, h))
    short.write_bytes(avi_bytes(jpgs[:VIDEO_OBB_FRAMES], w, h))
    return path, short, plain, sum(len(b) for b in jpgs)


def phase_video(root: Path, frames: list, card: str) -> tuple[dict, dict, Path]:
    """Phase track's 48 frames of 720x1280 as an MJPEG AVI (``write_video``):
    (a) ``data/avi.py`` decodes every frame on the card, both JPEG kernels
    once a frame, byte-equal to the plain decoder; (b) ``YOLO.predict(stream=
    True)`` of phase track's bf16 yolo11s-fce on the file, the stem, NMS and
    both JPEG kernels once a frame, detections equal to a predict on the
    plain decoder's arrays; (c) ``YOLO.track`` (ByteTrack) on the file with
    the counts at 0, then on the plain decoder's arrays with the plain NMS
    swapped into ``ops.nms``: the same tracks bit for bit, and the kernel
    bit-equal to the plain version on every frame's candidates; (d)
    ``YOLO.track`` of a bf16 yolo11s-obb on the short AVI: finite tracks, the
    stem kernel once a frame. Returns (launches by path, timings for the
    record, the short AVI)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data import jpeg as J
    from fce_yolo_tpu_torch.data.avi import avi_frames, read_avi
    from fce_yolo_tpu_torch.ops import nms as nms_ops

    t_phase = time.perf_counter()
    path, short, plain, n_bytes = write_video(root, frames)
    write_s = time.perf_counter() - t_phase
    n = len(plain)
    list(avi_frames(short, "cuda"))  # warm: this thread's stream and buffers
    reset_launches()
    t0 = time.perf_counter()
    decoded = list(avi_frames(path, "cuda"))
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    decode_launches = read_launches()
    check(decode_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": n, "jpeg_color": n},
          f"AVI decode: launches {decode_launches}, expected both JPEG kernels once for each of {n} frames")
    check(len(decoded) == n, f"AVI decode: {len(decoded)} frames of {n}")
    for i, (a, b) in enumerate(zip(decoded, plain)):
        check(bool(np.array_equal(a, b)), f"frame {i}: the card's decode differs from the plain decoder's")
    split, t = np.zeros(5), np.zeros(5, np.float32)
    at, size = read_avi(path).frames[1]
    frame1 = path.read_bytes()[at: at + size]
    for _ in range(10):
        J.decode_jpeg(frame1, "frame 1", "cuda", times=t)
        split += t
    split /= 10
    print(f"phase video (a): {n} frames of {frames[0].shape[0]}x{frames[0].shape[1]} as MJPEG AVI ({n_bytes} bytes; "
          f"frame 0 without DHT, a rec list, an odd chunk; written and plain-decoded in {write_s:.1f} s) decoded on "
          f"the card byte-equal to the plain decoder, launches {decode_launches}; {decode_ms:.2f} ms a frame, "
          f"{1e3 / decode_ms:.1f} frames/s (host clock, one thread); frame 1 split (CUDA events, mean of 10): host "
          f"entropy decode {split[0]:.3f} ms, H2D {split[1]:.3f}, jpeg_idct {split[2]:.4f}, jpeg_color "
          f"{split[3]:.4f}, D2H {split[4]:.3f} [{card}]", flush=True)

    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda")).to(torch.bfloat16)
    yolo.predict(plain[:2], imgsz=IMGSZ, conf=0.1)  # warm-up: the folded copy, cuDNN's set-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    gen = yolo.predict(str(path), imgsz=IMGSZ, conf=0.1, stream=True)
    check(not isinstance(gen, list), "predict(stream=True) returned a list")
    results = list(gen)
    torch.cuda.synchronize()
    predict_fps = n / (time.perf_counter() - t0)
    predict_launches = read_launches()
    check(predict_launches == no_jpeg(fused_stem=n, pick_suppress=n) | {"jpeg_idct": n, "jpeg_color": n},
          f"predict on the AVI: launches {predict_launches}, expected every kernel once for each of {n} frames")
    check([r.path for r in results] == [f"{path}#frame{i}" for i in range(n)], "predict on the AVI: frame names")
    again = yolo.predict(plain, imgsz=IMGSZ, conf=0.1)
    dmax = 0.0
    for i, (r, a) in enumerate(zip(results, again)):
        check(bool((r.orig_img == a.orig_img).all()), f"frame {i}: the predicted frame differs from the plain decode")
        check(len(r) == len(a) and bool((r.boxes.cls == a.boxes.cls).all()), f"frame {i}: detections differ")
        if len(r):
            dmax = max(dmax, float(np.abs(r.boxes.data - a.boxes.data).max()))
    check(dmax <= 1e-3, f"predict on the AVI vs on the plain decoder's arrays: detections differ by {dmax}")
    n_det = sum(len(r) for r in results)

    reset_launches()
    t0 = time.perf_counter()
    tracks = [trk for _, trk in yolo.track(str(path), tracker="bytetrack.yaml", imgsz=IMGSZ, stream=True)]
    torch.cuda.synchronize()
    track_fps = n / (time.perf_counter() - t0)
    track_launches = read_launches()
    check(track_launches == no_jpeg(fused_stem=n, pick_suppress=n) | {"jpeg_idct": n, "jpeg_color": n},
          f"track on the AVI: launches {track_launches}, expected every kernel once for each of {n} frames")
    calls: list = []
    real = nms_ops.pick_suppress

    def plain_nms(boxes, scores, valid, iou_thres, max_det):
        out = nms_ops.pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)
        calls.append(((boxes.clone(), scores.clone(), valid.clone()), out, iou_thres, max_det))
        return out

    try:
        nms_ops.pick_suppress = plain_nms
        plain_tracks = [trk for _, trk in yolo.track(plain, tracker="bytetrack.yaml", imgsz=IMGSZ, stream=True)]
    finally:
        nms_ops.pick_suppress = real
    check(len(calls) == n == len(tracks), f"plain path: {len(calls)} NMS calls, {len(tracks)} frames of tracks")
    for i, ((args, (ip, op), iou, max_det), a, b) in enumerate(zip(calls, tracks, plain_tracks)):
        ik, ok = real(*args, iou_thres=iou, max_det=max_det)
        check(bool((ik == ip).all() and (ok == op).all()), f"frame {i}: NMS kernel differs from the plain version")
        check(a.shape[1] == 7 and np.array_equal(a, b), f"frame {i}: the AVI's tracks differ from the plain path's")
    args = calls[0][0]
    with torch.inference_mode():
        nms_ms = graph_ms(lambda: real(*args, iou_thres=0.7, max_det=MAX_DET))
    n_ids = len({i for trk in tracks for i in trk[:, 4].tolist()})
    print(f"phase video (b, c): yolo11s-fce {IMGSZ} bf16, one frame a batch, conf 0.1: predict(stream=True) on "
          f"the AVI launches {predict_launches}, {n_det / n:.1f} detections a frame equal to a predict on the plain "
          f"decoder's arrays (max|d| {dmax:.1e}, limit 1e-3), {predict_fps:.2f} frames/s; ByteTrack on the AVI "
          f"launches {track_launches}, {n_ids} ids, tracks bit-equal to the plain path's (arrays, plain NMS) on "
          f"all {n} frames, the NMS kernel bit-equal to the plain version on each; {track_fps:.2f} frames/s "
          f"through YOLO.track (host clock, decode included); NMS kernel on frame 0's candidates {nms_ms:.4f} ms "
          f"(CUDA graph) [{card}]", flush=True)
    del yolo

    obb = task_matching_model(YOLO("yolo11s-obb.yaml", device="cuda"), "obb").to(torch.bfloat16)
    obb.track(plain[:1], imgsz=IMGSZ)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    obb_out = obb.track(str(short), imgsz=IMGSZ)
    torch.cuda.synchronize()
    obb_fps = VIDEO_OBB_FRAMES / (time.perf_counter() - t0)
    obb_launches = read_launches()
    k = VIDEO_OBB_FRAMES
    check(obb_launches == no_jpeg(fused_stem=k, pick_suppress=0) | {"jpeg_idct": k, "jpeg_color": k},
          f"OBB track on the AVI: launches {obb_launches}, expected the stem and JPEG kernels once for each of {k}")
    check(len(obb_out) == k, f"OBB track: {len(obb_out)} frames of {k}")
    for res, trk in obb_out:
        check(res.obb is not None and trk.ndim == 2 and trk.shape[1] == 7 and bool(np.isfinite(trk).all()),
              "OBB track: tracks not finite (M, 7)")
    n_obb = sum(len(t) for _, t in obb_out)
    check(n_obb > 0, "OBB track: no track on any frame")
    print(f"phase video (d): ByteTrack of yolo11s-obb {IMGSZ} bf16 (the axis-aligned hulls) on the first {k} frames "
          f"as an AVI: launches {obb_launches}, {n_obb / k:.1f} finite tracks a frame, {obb_fps:.2f} frames/s; "
          f"phase video {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del obb
    return ({"video_predict": predict_launches, "video_track": track_launches, "video_obb_track": obb_launches},
            {"decode_ms": decode_ms, "predict_fps": predict_fps, "track_fps": track_fps, "nms_ms": nms_ms}, short)



# ------------------------------------------------------------ phase classify
CLS_NC, CLS_TRAIN, CLS_VAL = 3, 8, 4  # classes; train and val images a class
CLS_BATCH = 12  # 24 train images: 2 steps an epoch; the 12 val images in one batch
CLS_EPOCHS = 2
CLS_TOL = 1e-4  # probabilities, card vs CPU: float32 in both (TF32 off), sums in another order


def write_cls_dataset(root: Path) -> Path:
    """A class-folder dataset of JPEGs (``jpeg_bytes``, q90 4:2:0) of
    200-400 px noise, each class tinted in its own channel:
    ``root/cls/{train,val}/class<c>/<i>.jpg``."""
    rng = np.random.RandomState(SEED + 11)
    for split, n in (("train", CLS_TRAIN), ("val", CLS_VAL)):
        for c in range(CLS_NC):
            folder = root / "cls" / split / f"class{c}"
            folder.mkdir(parents=True)
            for i in range(n):
                h, w = rng.randint(200, 401, 2)
                img = rng.randint(0, 120, (h, w, 3)).astype(np.uint8)
                img[..., c] += 120
                (folder / f"{i}.jpg").write_bytes(jpeg_bytes(img, 90, "420"))
    return root / "cls"


def calibrated_classifier(yolo, data: Path):
    """Seed-0 weights with every BatchNorm's running statistics set from one
    train-mode forward of the train split (val transform, momentum 1 for
    that pass): the eval logits are O(1), so an image's top-1 has a margin
    (at the raw init they are ~1e-5 and every image a near-tie)."""
    from fce_yolo_tpu_torch.data.classify import ClassificationDataset, classify_collate

    ds = ClassificationDataset(data / "train", imgsz=224, mode="val", device="cuda")
    x = torch.from_numpy(classify_collate([ds[i] for i in range(len(ds))])["img"]).cuda().permute(0, 3, 1, 2)
    bns = [m for m in yolo.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momentum = bns[0].momentum
    with torch.no_grad():
        for m in bns:
            m.momentum = 1.0
        yolo.model.train()(x.float() / 255.0)
        for m in bns:
            m.momentum = momentum
    yolo.model.eval()
    return yolo


def phase_classify(root: Path, short_avi: Path, card: str) -> dict:
    """yolo11s-cls at 224 px (float32, seed-0 weights, ``calibrated_classifier``)
    on a 3-class dataset of JPEGs it writes: ``YOLO.predict`` on the val
    directory (both JPEG kernels once an image; the probabilities within
    CLS_TOL of a CPU copy's, the same top-1) and on phase video's short AVI;
    ``YOLO.val`` (top-1 equal to predict's per-image hits); ``YOLO.train``
    bf16 for 2 epochs of 2 steps (finite losses, the JPEG kernels once an
    image read, ``best`` reloaded with its names giving the run's top-1).
    Returns the launches by path."""
    from fce_yolo_tpu_torch import YOLO

    t_phase = time.perf_counter()
    data = write_cls_dataset(root)
    val_dir = data / "val"
    n_val, n_train = CLS_NC * CLS_VAL, CLS_NC * CLS_TRAIN
    yolo = calibrated_classifier(YOLO("yolo11s-cls.yaml", device="cuda", nc=CLS_NC), data)
    yolo.predict(str(val_dir / "class0"), batch=CLS_BATCH)  # warm-up: the folded copy, cuDNN's set-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.predict(str(val_dir), batch=CLS_BATCH)
    torch.cuda.synchronize()
    predict_ips = n_val / (time.perf_counter() - t0)
    predict_launches = read_launches()
    check(predict_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": n_val, "jpeg_color": n_val},
          f"classify predict: launches {predict_launches}, expected both JPEG kernels once for each of {n_val}")
    cpu = YOLO("yolo11s-cls.yaml", device="cpu", nc=CLS_NC)
    cpu.model.load_state_dict(yolo.model.state_dict())
    ref = cpu.predict(str(val_dir), batch=CLS_BATCH)
    check([r.path for r in res] == [r.path for r in ref], "classify predict: paths differ from the CPU's")
    probs, ref_probs = np.stack([r.probs.data for r in res]), np.stack([r.probs.data for r in ref])
    dmax = float(np.abs(probs - ref_probs).max())
    top2 = np.sort(ref_probs, 1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    check(bool(np.isfinite(probs).all()) and dmax <= CLS_TOL, f"classify predict: card vs CPU probs differ by {dmax}")
    check(margin > 2 * CLS_TOL and [r.probs.top1 for r in res] == [r.probs.top1 for r in ref],
          f"classify predict: top-1 differs from the CPU's (smallest margin {margin:.2e})")
    hits = np.mean([r.probs.top1 == int(Path(r.path).parent.name.removeprefix("class")) for r in res])

    reset_launches()
    on_avi = list(yolo.predict(str(short_avi), stream=True))
    avi_launches = read_launches()
    k = VIDEO_OBB_FRAMES
    check(avi_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": k, "jpeg_color": k},
          f"classify predict on the AVI: launches {avi_launches}")
    check([r.path for r in on_avi] == [f"{short_avi}#frame{i}" for i in range(k)]
          and all(r.probs is not None and np.isfinite(r.probs.data).all() for r in on_avi),
          "classify predict on the AVI: names or probabilities")

    reset_launches()
    t0 = time.perf_counter()
    val = yolo.val(str(data), batch=CLS_BATCH, verbose=False)
    torch.cuda.synchronize()
    val_ips = n_val / (time.perf_counter() - t0)
    val_launches = read_launches()
    check(val_launches == predict_launches, f"classify val: launches {val_launches}")
    check(abs(val["metrics/accuracy_top1"] - hits) < 1e-9, f"classify val: top-1 {val} against predict's {hits}")

    reset_launches()
    t0 = time.perf_counter()
    out = yolo.train(data=str(data), epochs=CLS_EPOCHS, batch=CLS_BATCH, imgsz=224, project=str(root / "runs_cls"),
                     verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    reads = CLS_EPOCHS * (n_train + n_val)
    check(train_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": reads, "jpeg_color": reads},
          f"classify train: launches {train_launches}, expected a decode for each of {reads} image reads")
    check(out["epochs_run"] == CLS_EPOCHS and all(np.isfinite(r["train/loss"]) for r in out["results"]),
          f"classify train: {out['results']}")
    best = YOLO(str(Path(out["save_dir"]) / "weights" / "best"), device="cuda")
    check(best.task == "classify" and best.names == yolo.names == {c: f"class{c}" for c in range(CLS_NC)},
          f"classify best: task {best.task}, names {best.names}")
    best_top1 = best.val(str(data), imgsz=224, batch=CLS_BATCH, verbose=False)["metrics/accuracy_top1"]
    check(best_top1 == out["best_fitness"], f"classify best: top-1 {best_top1} against the run's {out['best_fitness']}")
    print(f"phase classify: yolo11s-cls 224 f32, {CLS_NC} classes, {n_train} train and {n_val} val JPEGs of 200-400 "
          f"px: predict on the val directory launches {predict_launches}, probabilities within {dmax:.1e} of the "
          f"CPU copy's (limit {CLS_TOL}; smallest top-1 margin {margin:.3f}), the same top-1, {predict_ips:.1f} img/s; "
          f"on the short AVI launches {avi_launches}; val top-1 {val['metrics/accuracy_top1']:.3f} top-5 "
          f"{val['metrics/accuracy_top5']:.3f} (= predict's hits), launches {val_launches}, {val_ips:.1f} img/s; "
          f"train bf16 B={CLS_BATCH} {CLS_EPOCHS} epochs, losses "
          f"{[round(r['train/loss'], 4) for r in out['results']]}, top-1 {[r['metrics/accuracy_top1'] for r in out['results']]}, "
          f"launches {train_launches}, {train_s:.1f} s ("
          + ", ".join(f"{sp['img_per_s']:.1f} img/s" for sp in out["speed"])
          + f"); best reloaded with its names gives top-1 {best_top1:.3f}; phase classify "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"classify_predict": predict_launches, "classify_avi": avi_launches, "classify_val": val_launches,
            "classify_train": train_launches}


# ------------------------------------------------------------ phase families
FAMILIES = (  # every v3/v5/v6/v8/v9/yolo12 YAML the port ships (fce_yolo_tpu_torch/cfg/models/)
    "yolov3", "yolov3-spp", "yolov3-tiny", "yolov5", "yolov5-p6", "yolov6",
    "yolov8", "yolov8-p2", "yolov8-p6", "yolov8-ghost", "yolov8-ghost-p2", "yolov8-ghost-p6",
    "yolov8-seg", "yolov8-seg-p6", "yolov8-pose", "yolov8-pose-p6", "yolov8-obb",
    "yolov8-cls", "yolov8-cls-resnet50", "yolov8-cls-resnet101",
    "yolov9t", "yolov9s", "yolov9m", "yolov9c", "yolov9e", "yolov9c-seg", "yolov9e-seg",
    "yolo12", "yolo12-seg", "yolo12-pose", "yolo12-obb", "yolo12-cls",
)
FAMILY_BATCH = 2  # phase families (a): one forward of each YAML


def shapes_of(out) -> object:
    """The nested shapes of a forward's output dict."""
    if isinstance(out, dict):
        return {k: shapes_of(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [shapes_of(v) for v in out]
    return tuple(out.shape)


def finite(out) -> bool:
    if isinstance(out, dict):
        return all(finite(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return all(finite(v) for v in out)
    return bool(torch.isfinite(out).all())


def family_forwards(card: str, names: tuple = FAMILIES, phase: str = "families (a)") -> dict:
    """(a) Every YAML of ``names`` at its first scale (full width where it has
    none) built on the card, one forward at B=2, 640 px (224 for classify),
    float32 then bf16: output shapes equal to the same graph's on the meta
    device (the host's parse; no memory, no arithmetic), finite, and
    ``param_count`` equal to the meta build's. Returns {name: ms}."""
    from fce_yolo_tpu_torch.cfg.models import load_model_dict
    from fce_yolo_tpu_torch.nn.model import build_model, param_count

    times = {}
    for name in names:
        d, _ = load_model_dict(f"{name}.yaml")
        scale = next(iter(d["scales"])) if d.get("scales") else None
        ref, spec, strides = build_model(d, scale=scale, device="meta")
        size = 224 if spec.task == "classify" else IMGSZ
        with torch.inference_mode():
            want = shapes_of(ref(torch.empty(FAMILY_BATCH, 3, size, size, device="meta")))
        x = torch.from_numpy(np.random.RandomState(SEED + 20).rand(FAMILY_BATCH, 3, size, size).astype(np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _, _ = build_model(d, scale=scale, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        row = {"build_ms": (t1 - t0) * 1e3}
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype)
            with torch.inference_mode():
                t0 = time.perf_counter()
                out = model(x.cuda().to(dtype, memory_format=torch.channels_last))
                torch.cuda.synchronize()
                row[f"{str(dtype)[6:]}_ms"] = (time.perf_counter() - t0) * 1e3
            check(shapes_of(out) == want, f"phase {phase} {name} {dtype}: shapes {shapes_of(out)} != {want}")
            check(finite(out), f"phase {phase} {name} {dtype}: output not finite")
        check(param_count(model) == param_count(ref), f"phase {phase} {name}: {param_count(model)} parameters "
              f"on the card, {param_count(ref)} on the host")
        times[name] = row
        label = name if not scale or name.endswith(scale) else name + scale  # yolov8 -> yolov8n; yolov10n as it is
        print(f"phase {phase}: {label} {spec.task} {param_count(model):,} params, strides {strides}, "
              f"B={FAMILY_BATCH} {size} px: build {row['build_ms']:.1f} ms, first forward float32 "
              f"{row['float32_ms']:.1f} ms, bfloat16 {row['bfloat16_ms']:.1f} ms (host clock, cuDNN's set-up "
              f"included) [{card}]", flush=True)
        del model, out
    torch.cuda.empty_cache()
    return times


def first_val_images(root: Path, n: int) -> dict:
    """The first ``n`` of phase val's PNG images under ``root``, as both
    splits of a data dict with VAL_NC names."""
    files = [str(f) for f in sorted((root / "images" / "val").glob("*.png"))[:n]]
    return {"path": str(root), "train": files, "val": files, "names": [f"class{i}" for i in range(VAL_NC)]}


def family_val(name: str, data: dict, card: str) -> tuple[dict, tuple]:
    """(d) ``YOLO.val`` of ``name`` in float32 on the first FAMILY_IMAGES of
    phase val's PNG images: the NMS kernel once a batch and no stem; then every batch again with the
    kernel and with its plain version (``val_batches_vs_plain``: idx/ok equal,
    P, R, mAP equal from both and above zero), equal to ``YOLO.val``'s."""
    from fce_yolo_tpu_torch import YOLO

    yolo = matching_model(YOLO(name, device="cuda"))
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    img_s = FAMILY_IMAGES / (time.perf_counter() - t0)
    launches = read_launches()
    n_batches = -(-FAMILY_IMAGES // VAL_BATCH)
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_batches), f"{name} val: launches {launches}")
    mk = val_batches_vs_plain(yolo, data)[-1]
    got = tuple(res["metrics"].mean_results())
    check(np.allclose(got, mk, rtol=0, atol=1e-9), f"{name} val: YOLO.val's {got} != the per-batch {mk}")
    print(f"phase families (d): {name} val {IMGSZ} f32 B={VAL_BATCH} on {FAMILY_IMAGES} PNG images, launches "
          f"{launches}; "
          f"NMS kernel idx/ok equal to the plain version on every batch; P/R/mAP50/mAP50-95 "
          f"{tuple(round(v, 6) for v in mk)} equal from both and to YOLO.val's; {img_s:.1f} img/s through YOLO.val "
          f"(host clock, incl. PNG decode) [{card}]", flush=True)
    return launches, mk


def family_train(name: str, root: Path, card: str, phase: str = "families (e)") -> dict:
    """(e) One ``YOLO.train`` epoch (bf16, AdamW, B=16, no plots) of ``name``
    on the first FAMILY_IMAGES val images as both splits: finite losses, the
    epoch's val with the NMS kernel once a batch (none for a v10 model: its val takes ``preds6`` as they
    are), no stem."""
    from fce_yolo_tpu_torch import YOLO

    yolo = matching_model(YOLO(name, device="cuda"))
    n_val = -(-FAMILY_IMAGES // VAL_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.train(first_val_images(root, FAMILY_IMAGES), epochs=1, batch=VAL_BATCH, imgsz=IMGSZ,
                     project=str(root / "runs_families"), plots=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    end2end = yolo.spec.layers[-1].name == "v10Detect"
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0 if end2end else n_val),
          f"{name} train: launches {launches}")
    r, sp = res["results"][0], res["speed"][0]
    check(res["epochs_run"] == 1 and all(np.isfinite(r[k]) for k in ("train/box_loss", "train/cls_loss",
                                                                     "train/dfl_loss")), f"{name} train: {r}")
    times = train_step_times(step_batch(train_data(root))[0], VAL_NC, name, bf16s=(True,))
    print(f"phase {phase}: {name} YOLO.train {IMGSZ} bf16 B={VAL_BATCH} AdamW, 1 epoch of "
          f"{FAMILY_IMAGES // VAL_BATCH} steps, launches {launches}; loss box/cls/dfl {r['train/box_loss']:.4f}/"
          f"{r['train/cls_loss']:.4f}/{r['train/dfl_loss']:.4f}, val mAP50 {r['metrics/mAP50(B)']:.6f}; "
          f"{sp['img_per_s']:.2f} img/s, step {sp['step_ms']:.1f} ms (the epoch's mean, its first step's set-up "
          f"included), loader wait {sp['loader_wait_ms']:.1f} ms, val {sp['val_s']:.2f} s; {wall:.1f} s in all; "
          f"the step on a batch on the card: first {times['first_step_ms_bf16']:.1f} ms (host clock), then "
          f"{times['step_ms_bf16']:.1f} ms (CUDA events, 5 after 2), peak {times['peak_gib_bf16']:.2f} GiB "
          f"[{card}]", flush=True)
    return launches


def phase_families(root: Path, data: str, card: str) -> dict:
    """The v3, v5, v6, v8, v9 and yolo12 families: (a) every YAML built and
    run once in float32 and bf16; (b) ``YOLO.predict`` of yolov8s and yolo12s
    at B=16, 640 px, bf16 on phase e2e's images (yolo12s takes the stem,
    held against its plain version on the fed batch; yolov8s does not; NMS
    once a batch, idx/ok equal to the plain version's); (c) yolov8s-seg,
    -pose and -obb predict likewise; (d) ``YOLO.val`` of yolov8s and yolo12s
    on the first FAMILY_IMAGES of phase val's images; (e) one ``YOLO.train``
    epoch of each on them. Returns each path's launches."""
    t_phase = time.perf_counter()
    paths = {}
    times = family_forwards(card)
    imgs = e2e_images(SEED + 1, E2E_BATCHES)
    for task, name, stem in (("detect", "yolov8s.yaml", False), ("detect", "yolo12s.yaml", True),
                             ("segment", "yolov8s-seg.yaml", False), ("pose", "yolov8s-pose.yaml", False),
                             ("obb", "yolov8s-obb.yaml", False)):
        p = task_predict(task, card, name=name, imgs=imgs if task == "detect" else None, stem=stem)
        torch.cuda.empty_cache()
        paths[f"families_predict_{name.removesuffix('.yaml')}"] = p["launches"]
        stem_note = (f"stem on the fed batch max|d|/max|ref|={p['stem_rel']:.3e} (limit 0.02), per-row max/median="
                     f"{p['stem_spread']:.2f} (limit 3); preds kernel vs plain path max|d|={p['dmax']:.3e} (limit "
                     f"{p['bound']:.3e}) corr={p['corr']:.6f}; " if stem else "no stem (layer 2 is not C3k2 e=0.25); ")
        nms_note = (f"NMS kernel idx/ok and outputs equal to the plain version on the fed batch ({p['kept']} kept)"
                    if task != "obb" else "rotated NMS in torch ops (no kernel)")
        print(f"phase families ({'b' if task == 'detect' else 'c'}): {name} predict {IMGSZ} bf16 B={E2E_BATCH}, "
              f"{p['n_images']} images, {p['n_det']} detections, launches {p['launches']}; {stem_note}{nms_note}; "
              f"{p['img_s']:.1f} img/s through YOLO.predict (host clock, incl. letterbox); {p['ms']:.2f} ms/batch "
              f"device path vs {p['ms_plain']:.2f} {'plain stem' if stem else 'from a float batch'} (CUDA events) "
              f"[{card}]", flush=True)
    for name in ("yolov8s.yaml", "yolo12s.yaml"):
        paths[f"families_val_{name.removesuffix('.yaml')}"] = family_val(name, first_val_images(root, FAMILY_IMAGES),
                                                                         card)[0]
        torch.cuda.empty_cache()
    for name in ("yolov8s.yaml", "yolo12s.yaml"):
        paths[f"families_train_{name.removesuffix('.yaml')}"] = family_train(name, root, card)
        torch.cuda.empty_cache()
    slowest = max(times, key=lambda k: sum(times[k].values()))
    print(f"phase families: {len(times)} YAMLs built and run (slowest {slowest}: "
          f"{sum(times[slowest].values()):.0f} ms); phase families {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return paths


# ------------------------------------------------------------ phase v10
V10_FAMILY = ("yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x")
V10_CHECK_IMAGES = 4  # (b) the card's float32 preds6 against the CPU's on the first images of phase e2e's
V10_TOL = 1e-4  # (b) card vs CPU, float32 in both (TF32 off): scores absolute, boxes of the largest coordinate
V10_TIE = 2e-5  # (b) scores this close may trade places between card and CPU (sums in another order)
V10_VAL_TOL = 1e-3  # (c) P, R, mAP50, mAP50-95, card vs CPU
COORD_TOL = 1e-5  # (g) CoordAtt and CoordCrossAtt outputs, card vs CPU, of the largest


def preds6_agree(card6: np.ndarray, cpu6: np.ndarray, what: str) -> tuple[int, int]:
    """V10Detect's ``preds6`` from the card and the CPU: scores equal position
    by position within V10_TOL, and rows (class, box) in the same order,
    except inside runs of CPU scores within V10_TIE of each other, which are
    compared as sets of rows; the last run of an image is not compared (its
    ties reach past the top-k cut, so either side may hold rows the other
    left out). Returns (the rows compared, the rows in runs of ties)."""
    check(card6.shape == cpu6.shape, f"{what}: preds6 {card6.shape} vs {cpu6.shape}")
    dscore = float(np.abs(card6[..., 4] - cpu6[..., 4]).max())
    check(dscore <= V10_TOL, f"{what}: scores differ by {dscore} (limit {V10_TOL})")
    tol = V10_TOL * float(np.abs(cpu6[..., :4]).max())
    compared = tied = 0
    for a, b in zip(card6, cpu6):
        cut = np.flatnonzero(np.diff(b[:, 4]) < -V10_TIE) + 1
        for ra, rb in list(zip(np.split(a, cut), np.split(b, cut)))[:-1]:
            compared += len(rb)
            tied += len(rb) if len(rb) > 1 else 0
            left = list(range(len(rb)))
            for row in ra:
                j = next((j for j in left if rb[j, 5] == row[5] and np.abs(rb[j, :4] - row[:4]).max() <= tol), None)
                check(j is not None, f"{what}: the card's row {row} has no CPU row of its class within {tol:.3e}")
                left.remove(j)
    check(compared >= card6.shape[0] * card6.shape[1] // 2, f"{what}: only {compared} rows apart from the last ties")
    return compared, tied


def v10_predict(card: str) -> dict:
    """(b) yolov10s (seed-0 weights): ``preds6`` of phase e2e's first images
    in float32 on the card (TF32 off) against a CPU copy (``preds6_agree``);
    then ``YOLO.predict`` in bf16 at B=16 on phase e2e's images: no stem
    (layer 2 is C2f) and no NMS (the head's top-k is the result), finite
    boxes inside each image. Returns the launches."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model

    yolo = YOLO("yolov10s.yaml", device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # the seed's class logits are ~1e-4: scaled to O(1), few of the top scores tie
        for branch in yolo.model.detect.one2one_cv3:
            branch[-1].weight.mul_(1e4)
    check(stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ)) is None, "yolov10s must not take the fused stem")
    imgs = e2e_images(SEED + 1, E2E_BATCHES)
    first = letterboxed(imgs[:V10_CHECK_IMAGES])
    x = first.permute(0, 3, 1, 2).float() / 255.0
    cpu = YOLO("yolov10s.yaml", device="cpu")
    cpu.model.load_state_dict(yolo.model.state_dict())
    with torch.inference_mode():
        card6 = yolo._inference_model()(x)["preds6"].cpu().numpy()
        cpu6 = cpu._inference_model()(x.cpu())["preds6"].numpy()
    compared, tied = preds6_agree(card6, cpu6, "v10 predict float32")
    dscore = float(np.abs(card6[..., 4] - cpu6[..., 4]).max())

    yolo.to(torch.bfloat16).fuse()
    yolo.predict(imgs[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    n_det = 0
    for r, img in zip(yolo.predict(imgs, imgsz=IMGSZ, batch=E2E_BATCH, stream=True), imgs):
        h, w = img.shape[:2]
        n_det += len(r)
        check(0 < len(r) <= MAX_DET and bool(np.isfinite(r.boxes.data).all())
              and bool(((r.boxes.xyxy >= 0) & (r.boxes.xyxy <= np.array([w, h, w, h]))).all()),
              f"v10 predict: {len(r)} boxes, finite and inside the image")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"yolov10s predict: launches {launches}")
    predictor = DetectionPredictor(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=E2E_BATCH)
    batch = letterboxed(imgs[:E2E_BATCH])
    with torch.inference_mode():
        ms = cuda_ms(lambda: predictor.infer(batch), iters=5)
    print(f"phase v10 (b): yolov10s preds6 of {V10_CHECK_IMAGES} images float32 (TF32 off) card vs CPU: scores within "
          f"{dscore:.2e} (limit {V10_TOL}); of {card6.shape[0] * card6.shape[1]} rows, {compared} above each image's "
          f"last run of ties compared: classes and boxes (limit {V10_TOL} of the largest) in the same order, "
          f"{tied} of them inside runs of scores within {V10_TIE} (compared as sets); YOLO.predict {IMGSZ} bf16 B={E2E_BATCH}, {len(imgs)} images, {n_det} "
          f"detections, launches {launches} (no stem: layer 2 is C2f; no NMS: preds6 are the detections); "
          f"{len(imgs) / wall:.1f} img/s through YOLO.predict (host clock, incl. letterbox); {ms:.2f} ms/batch model "
          f"+ top-k on the device (CUDA events) [{card}]", flush=True)
    return launches


def v10_val(data: str, card: str) -> dict:
    """(c) ``YOLO.val`` of yolov10s (float32, ``matching_model``: both head
    sets raised) on phase val's 64 PNG images, end to end: no NMS, no stem;
    P, R, mAP50 and mAP50-95 (mAP50 above zero) within V10_VAL_TOL of a CPU
    copy's val of the same images. Returns the launches."""
    from fce_yolo_tpu_torch import YOLO

    yolo = matching_model(YOLO("yolov10s.yaml", device="cuda"))
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    img_s = VAL_IMAGES / (time.perf_counter() - t0)
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"yolov10s val: launches {launches}")
    cpu = YOLO("yolov10s.yaml", device="cpu")
    cpu.model.load_state_dict(yolo.model.state_dict())
    t0 = time.perf_counter()
    ref = cpu.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, workers=8, verbose=False)
    cpu_s = time.perf_counter() - t0
    got, want = tuple(res["metrics"].mean_results()), tuple(ref["metrics"].mean_results())
    check(np.allclose(got, want, rtol=0, atol=V10_VAL_TOL) and got[2] > 0,
          f"yolov10s val: P/R/mAP {got} on the card, {want} on the CPU (limit {V10_VAL_TOL}, mAP50 above 0)")
    print(f"phase v10 (c): yolov10s val {IMGSZ} f32 B={VAL_BATCH} on {VAL_IMAGES} PNG images, end to end (preds6, "
          f"no NMS), launches {launches}; P/R/mAP50/mAP50-95 {tuple(round(v, 6) for v in got)} on the card, "
          f"{tuple(round(v, 6) for v in want)} on the CPU (limit {V10_VAL_TOL}); {img_s:.1f} img/s through YOLO.val "
          f"(host clock, incl. PNG decode); the CPU val {cpu_s:.1f} s [{card}]", flush=True)
    return launches


def cls_resnet18(root: Path, card: str) -> dict:
    """(e) yolo11-cls-resnet18 at 224 px (float32, seed-0 weights,
    ``calibrated_classifier``) on phase classify's JPEG folders: ``YOLO.predict``
    on the val directory (both JPEG kernels once an image; probabilities
    within CLS_TOL of a CPU copy's, the same top-1), ``YOLO.val`` (top-1
    equal to predict's hits), one ``YOLO.train`` epoch in bf16 (finite loss,
    the trunk's BatchNorm statistics moved). Returns the launches by path."""
    from fce_yolo_tpu_torch import YOLO

    data = root / "cls"
    n_val, n_train = CLS_NC * CLS_VAL, CLS_NC * CLS_TRAIN
    yolo = calibrated_classifier(YOLO("yolo11-cls-resnet18.yaml", device="cuda", nc=CLS_NC), data)
    val_dir = data / "val"
    yolo.predict(str(val_dir / "class0"), batch=CLS_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.predict(str(val_dir), batch=CLS_BATCH)
    torch.cuda.synchronize()
    predict_ips = n_val / (time.perf_counter() - t0)
    predict_launches = read_launches()
    check(predict_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": n_val, "jpeg_color": n_val},
          f"cls-resnet18 predict: launches {predict_launches}")
    cpu = YOLO("yolo11-cls-resnet18.yaml", device="cpu", nc=CLS_NC)
    cpu.model.load_state_dict(yolo.model.state_dict())
    ref = cpu.predict(str(val_dir), batch=CLS_BATCH)
    probs, ref_probs = np.stack([r.probs.data for r in res]), np.stack([r.probs.data for r in ref])
    dmax = float(np.abs(probs - ref_probs).max())
    top2 = np.sort(ref_probs, 1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    check(bool(np.isfinite(probs).all()) and dmax <= CLS_TOL, f"cls-resnet18 predict: card vs CPU differ by {dmax}")
    check(margin > 2 * CLS_TOL and [r.probs.top1 for r in res] == [r.probs.top1 for r in ref],
          f"cls-resnet18 predict: top-1 differs from the CPU's (smallest margin {margin:.2e})")
    hits = np.mean([r.probs.top1 == int(Path(r.path).parent.name.removeprefix("class")) for r in res])
    reset_launches()
    t0 = time.perf_counter()
    val = yolo.val(str(data), batch=CLS_BATCH, verbose=False)
    torch.cuda.synchronize()
    val_ips = n_val / (time.perf_counter() - t0)
    val_launches = read_launches()
    check(val_launches == predict_launches, f"cls-resnet18 val: launches {val_launches}")
    check(abs(val["metrics/accuracy_top1"] - hits) < 1e-9, f"cls-resnet18 val: top-1 {val} against predict's {hits}")
    bn = yolo.model.model[0].m.bn1.running_mean.clone()
    reset_launches()
    t0 = time.perf_counter()
    out = yolo.train(data=str(data), epochs=1, batch=CLS_BATCH, imgsz=224, project=str(root / "runs_resnet18"),
                     verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    reads = n_train + n_val
    check(train_launches == no_jpeg(fused_stem=0, pick_suppress=0) | {"jpeg_idct": reads, "jpeg_color": reads},
          f"cls-resnet18 train: launches {train_launches}")
    check(out["epochs_run"] == 1 and np.isfinite(out["results"][0]["train/loss"])
          and not torch.equal(yolo.model.model[0].m.bn1.running_mean, bn), f"cls-resnet18 train: {out['results']}")
    print(f"phase v10 (e): yolo11-cls-resnet18 224 f32 on phase classify's {n_train} + {n_val} JPEGs: predict launches "
          f"{predict_launches}, probabilities within {dmax:.1e} of the CPU copy's (limit {CLS_TOL}; smallest top-1 "
          f"margin {margin:.3f}), the same top-1, {predict_ips:.1f} img/s; val top-1 "
          f"{val['metrics/accuracy_top1']:.3f} "
          f"(= predict's hits), {val_ips:.1f} img/s; train bf16 B={CLS_BATCH} 1 epoch, loss "
          f"{out['results'][0]['train/loss']:.4f}, launches {train_launches}, {train_s:.1f} s "
          f"({out['speed'][0]['img_per_s']:.1f} img/s) [{card}]", flush=True)
    return {"cls_resnet18_predict": predict_launches, "cls_resnet18_val": val_launches,
            "cls_resnet18_train": train_launches}


def v10_tta(card: str) -> tuple[dict, dict]:
    """(f) ``predict_augment`` of yolo11s-fce (bf16, folded, seed-0 weights
    without the class prior) on phase e2e's first 16 images: 15,049
    merged candidates an image (8000 + 6069 + 980), then ``batched_nms``
    (predict's settings; K = 1024 after the top-k): the NMS kernel once, no
    stem (the augmented passes run the plain graph); the kernel's idx/ok
    equal to the plain version's on the same candidates, timed there.
    Returns the launches and the kernel's times on this path."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.nn.tta import predict_augment
    from fce_yolo_tpu_torch.ops.nms import batched_nms, pick_suppress, pick_suppress_reference

    yolo = YOLO("yolo11s-fce.yaml", device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    yolo.to(torch.bfloat16).fuse()
    batch = letterboxed(e2e_images(SEED + 1, 1)[:E2E_BATCH])
    x = (batch.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
    kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=MAX_DET, multi_label=False)

    def path():
        return batched_nms(predict_augment(yolo.model, x), **kw)

    with torch.inference_mode():
        merged = predict_augment(yolo.model, x)  # warm-up: cuDNN's plans at the three sizes
        check(tuple(merged.shape) == (E2E_BATCH, 8000 + 6069 + 980, 84), f"TTA: merged {tuple(merged.shape)}")
        torch.cuda.synchronize()
        reset_launches()
        out = path()
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == no_jpeg(fused_stem=0, pick_suppress=1), f"TTA: launches {launches}")
        calls: list = []
        outs = kernel_vs_plain(lambda: {k: v.cpu().numpy() for k, v in batched_nms(merged, **kw).items()}, calls,
                               NMS_K, 0.7, MAX_DET, "TTA")
        kept = int(outs["kernel"]["valid"].sum())
        check(kept > 0 and bool((out["valid"].cpu().numpy() == outs["kernel"]["valid"]).all()), "TTA: detections")
        args = calls[-1][0]
        ms = graph_ms(lambda: pick_suppress(*args, iou_thres=0.7, max_det=MAX_DET))
        plain_ms = cuda_ms(lambda: pick_suppress_reference(*args, 0.7, MAX_DET), iters=3, warmup=1)
        path_ms = cuda_ms(path, iters=3)
        single_ms = cuda_ms(lambda: batched_nms(yolo.model(x)["preds"], **kw), iters=3)
    bound_ms, bound_by = nms_bound(E2E_BATCH, NMS_K, kept)
    print(f"phase v10 (f): TTA yolo11s-fce {IMGSZ} bf16 B={E2E_BATCH}: scales (1, 0.83, 0.67), flips (-, lr, -), "
          f"{merged.shape[1]} merged candidates an image; batched_nms launches {launches}; NMS kernel idx/ok equal "
          f"to the plain version on the top {NMS_K} candidates ({kept} kept); kernel {ms:.4f} ms on the device "
          f"(CUDA graph), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); the TTA path "
          f"{path_ms:.2f} ms/batch against {single_ms:.2f} single-scale (CUDA events) [{card}]", flush=True)
    return launches, {"tta_ms": ms, "tta_plain_ms": plain_ms, "tta_bound_ms": bound_ms}


def coord_blocks(card: str) -> None:
    """(g) CoordAtt (reduction 32) and CoordCrossAtt (reduction 8, 4 heads) at
    256 channels on a (16, 256, 80, 80) float32 map (P3 of a 640 px image at
    B=16), seeded weights and random BatchNorm statistics: the card's output
    within COORD_TOL of the largest of the CPU's (TF32 off), timed."""
    from fce_yolo_tpu_torch.nn.fce import CoordAtt, CoordCrossAtt
    from fce_yolo_tpu_torch.nn.model import init_weights

    gen = torch.Generator().manual_seed(SEED + 30)
    x = torch.rand(16, 256, 80, 80, generator=gen)
    for name, module in (("CoordAtt", CoordAtt(256, 256, 32)), ("CoordCrossAtt", CoordCrossAtt(256, 256, 8, 4))):
        init_weights(module, torch.Generator().manual_seed(SEED), bias_prior=False)
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
        module.eval()
        with torch.inference_mode():
            ref = module(x)
            card_module = module.cuda()
            xc = x.cuda()
            out = card_module(xc).cpu()
            ms = cuda_ms(lambda: card_module(xc))
        rel = float((out - ref).abs().max()) / float(ref.abs().max())
        check(bool(torch.isfinite(out).all()) and rel <= COORD_TOL, f"{name}: card vs CPU {rel:.3e} of the largest")
        print(f"phase v10 (g): {name} (16, 256, 80, 80) f32: card vs CPU max|d|/max|ref| {rel:.2e} (limit "
              f"{COORD_TOL}); {ms:.3f} ms a forward (CUDA events) [{card}]", flush=True)


def phase_v10(root: Path, data: str, card: str) -> tuple[dict, dict]:
    """YOLOv10 and the last packaged blocks: (a) the six v10 YAMLs built and
    run once in float32 and bf16; (b) yolov10s ``preds6`` card vs CPU and
    ``YOLO.predict`` at B=16 bf16 (no stem, no NMS); (c) its end-to-end
    ``YOLO.val``, card vs CPU; (d) one ``YOLO.train`` epoch with the dual
    loss; (e) yolo11-cls-resnet18 predict, val and train; (f) TTA through
    the NMS kernel; (g) CoordAtt and CoordCrossAtt, card vs CPU. Returns the
    launches by path and the NMS kernel's times on the TTA path."""
    t_phase = time.perf_counter()
    times = family_forwards(card, V10_FAMILY, "v10 (a)")
    paths = {"v10_predict": v10_predict(card)}
    torch.cuda.empty_cache()
    paths["v10_val"] = v10_val(data, card)
    torch.cuda.empty_cache()
    paths["v10_train"] = family_train("yolov10s.yaml", root, card, phase="v10 (d)")
    torch.cuda.empty_cache()
    paths.update(cls_resnet18(root, card))
    torch.cuda.empty_cache()
    paths["tta"], tta = v10_tta(card)
    coord_blocks(card)
    print(f"phase v10: {len(times)} YAMLs built and run; phase v10 {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return paths, tta


RTDETR_FAMILY = ("rtdetr-l.yaml", "rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml",
                 "yolov8l-rtdetr.yaml")
RTDETR_BUILD_BATCH = 2  # (a) one bf16 forward of each YAML
RTDETR_CHECK_IMAGES = 2  # (b) card float32 preds against the CPU's
RTDETR_TOL = 1e-3  # (b) preds (normalized xywh and sigmoid scores), card vs CPU, float32 in both (TF32 off)
RTDETR_TIE = 1e-4  # (b) encoder scores this close may trade places in the top-k between card and CPU
RTDETR_PREDICT_IMAGES = 32  # (b) two batches of E2E_BATCH
RTDETR_VAL_IMAGES, RTDETR_VAL_BATCH = 16, 8  # (c) the first of phase val's images
RTDETR_TRAIN_IMAGES, RTDETR_TRAIN_BATCH = 8, 4  # (d) one epoch of two steps


def kernel_profile(call) -> tuple[list[tuple[str, int, float]], float]:
    """The CUDA kernels one ``call`` launches (torch.profiler, device
    activity only): [(name, launches, device ms)] by time, and the total ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "device_time_total", 0) / 1e3) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows)


def rtdetr_split(rows: list, total: float) -> dict:
    """Shares of the device time by kind of kernel, by name: deformable
    sampling (``grid_sampler``), attention (the SDPA kernels), the
    encoder's top-k (the sorts), convolutions, other matmuls, norms,
    softmax, concatenations and copies, elementwise, reductions, other."""
    import re

    kinds = {"deformable_sampling": r"grid_sampler", "attention": r"fmha|flash|attention|efficient",
             "topk_sort": r"sort|radix|topk", "conv": r"fprop|conv|implicit|winograd|cudnn",
             "gemm": r"gemm|xmma|cutlass|nvjet|wgmma", "norm": r"norm", "softmax": r"softmax",
             "cat_copy": r"CatArray|copy", "elementwise": r"elementwise", "reduce": r"reduce"}
    out = {k: 0.0 for k in (*kinds, "other")}
    for name, _, ms in rows:
        out[next((k for k, pat in kinds.items() if re.search(pat, name, re.I)), "other")] += ms
    return {k: round(v / max(total, 1e-9), 4) for k, v in out.items()}


def rtdetr_forwards(card: str) -> dict:
    """(a) Each RT-DETR YAML built on the card at IMGSZ (seed weights) and
    one bf16 eval forward at B=2: finite ``preds`` (B, 300, 84). Returns
    {name: (build ms, first forward ms, parameters)}."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.model import param_count

    out = {}
    x = torch.rand(RTDETR_BUILD_BATCH, 3, IMGSZ, IMGSZ, device="cuda", generator=torch.Generator("cuda").manual_seed(
        SEED)).to(torch.bfloat16)
    for name in RTDETR_FAMILY:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yolo = YOLO(name, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        yolo.to(torch.bfloat16)
        with torch.inference_mode():
            preds = yolo.model(x)["preds"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(yolo.task == "rtdetr" and tuple(preds.shape) == (RTDETR_BUILD_BATCH, 300, 4 + VAL_NC)
              and bool(torch.isfinite(preds).all()), f"{name}: preds {tuple(preds.shape)}")
        out[name] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, param_count(yolo.model))
        del yolo, preds
        torch.cuda.empty_cache()
    print("phase rtdetr (a): " + "; ".join(f"{n} built in {b:.0f} ms, first bf16 forward B={RTDETR_BUILD_BATCH} "
                                           f"{IMGSZ} {f:.0f} ms, {p:,} parameters" for n, (b, f, p) in out.items())
          + f" [{card}]", flush=True)
    return out


def rtdetr_card_vs_cpu(yolo, imgs: list) -> tuple[float, int, float]:
    """(b) ``preds`` of rtdetr-l in float32 on the card (TF32 off) and on a
    CPU copy, on the same letterboxed images. The CPU runs first and its
    encoder top-k is handed to the card's decoder, so both decode the same
    queries; the card's own top-k is recorded beside it: where the two
    differ, the card's scores at the CPU's indices must be its own top
    scores within RTDETR_TIE (a near-tie traded places, nothing more).
    Returns (max |card - cpu| of preds, positions of the top-k where the
    card's own index differs, the largest such score gap)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn import heads as H

    x = letterboxed(imgs).cpu().permute(0, 3, 1, 2).float() / 255.0
    cpu = YOLO("rtdetr-l.yaml", device="cpu")
    cpu.model.load_state_dict(yolo.model.state_dict())
    real, seen = H.stable_topk, {}

    def cpu_topk(s, k):
        seen["cpu"] = real(s, k)
        return seen["cpu"]

    def card_topk(s, k):
        seen["card"], seen["card_scores"] = real(s, k), s
        return seen["cpu"][0].to(s.device), seen["cpu"][1].to(s.device)

    try:
        H.stable_topk = cpu_topk
        with torch.inference_mode():
            ref = cpu._inference_model()(x)["preds"].numpy()
        H.stable_topk = card_topk
        with torch.inference_mode():
            got = yolo._inference_model()(x.cuda())["preds"].cpu().numpy()
    finally:
        H.stable_topk = real
    err = float(np.abs(got - ref).max())
    check(err <= RTDETR_TOL, f"rtdetr-l preds card vs CPU: {err} (limit {RTDETR_TOL})")
    own_v, own_i = (t.cpu() for t in seen["card"])
    cpu_i = seen["cpu"][1]
    at_cpu = torch.gather(seen["card_scores"].cpu(), 1, cpu_i).sort(dim=1, descending=True).values
    gap = float((at_cpu - own_v).abs().max())
    check(gap <= RTDETR_TIE, f"rtdetr-l top-k card vs CPU: the CPU's queries score {gap} below the card's own")
    return err, int((own_i != cpu_i).sum()), gap


def rtdetr_predict(card: str) -> dict:
    """(b) rtdetr-l (seed weights): card vs CPU in float32
    (``rtdetr_card_vs_cpu``), then ``YOLO.predict`` in bf16 at B=16 on 32
    of phase e2e's images: no stem (layer 0 is HGStem) and no NMS (the
    queries are the detections); device ms a batch (CUDA events), img/s
    (host clock) and one batch under torch.profiler: kernels launched and
    the split of the device time. Returns the launches."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model

    yolo = YOLO("rtdetr-l.yaml", device="cuda")
    check(stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ)) is None, "rtdetr-l must not take the fused stem")
    imgs = e2e_images(SEED + 1, RTDETR_PREDICT_IMAGES // E2E_BATCH)[:RTDETR_PREDICT_IMAGES]
    err, moved, gap = rtdetr_card_vs_cpu(yolo, imgs[:RTDETR_CHECK_IMAGES])

    yolo.to(torch.bfloat16).fuse()
    yolo.predict(imgs[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    n_det = 0
    for r, img in zip(yolo.predict(imgs, imgsz=IMGSZ, batch=E2E_BATCH, conf=0.0, stream=True), imgs):
        h, w = img.shape[:2]
        n_det += len(r)
        check(len(r) == MAX_DET and bool(np.isfinite(r.boxes.data).all())
              and bool(((r.boxes.xyxy >= 0) & (r.boxes.xyxy <= np.array([w, h, w, h]))).all())
              and bool((np.diff(r.boxes.conf) <= 0).all()),
              f"rtdetr predict: {len(r)} rows, finite, inside the image, by descending score")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"rtdetr-l predict: launches {launches}")
    predictor = DetectionPredictor(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=E2E_BATCH)
    batch = letterboxed(imgs[:E2E_BATCH])
    with torch.inference_mode():
        ms = cuda_ms(lambda: predictor.infer(batch), iters=5)
        rows, total = kernel_profile(lambda: predictor.infer(batch))
    split = rtdetr_split(rows, total)
    top = "; ".join(f"{n[:110]} x{c} {t:.3f} ms" for n, c, t in rows[:10])
    print(f"phase rtdetr (b): rtdetr-l preds of {RTDETR_CHECK_IMAGES} images float32 (TF32 off) card vs CPU within "
          f"{err:.2e} (limit {RTDETR_TOL}) on the CPU's queries; the card's own top-{MAX_DET} differs at {moved} "
          f"places, its scores there within {gap:.2e} (limit {RTDETR_TIE}); YOLO.predict {IMGSZ} bf16 B={E2E_BATCH}, "
          f"{len(imgs)} images, {n_det} rows at conf 0, launches {launches} (no stem, no NMS); {len(imgs) / wall:.1f} "
          f"img/s through YOLO.predict (host clock, incl. letterbox); {ms:.2f} ms/batch on the device (CUDA events); "
          f"one batch under torch.profiler: {sum(c for _, c, _ in rows)} kernel launches, {total:.2f} ms of device "
          f"time ({1 - total / ms:.1%} of the batch's {ms:.2f} ms idle), split {split}; top kernels: {top} [{card}]",
          flush=True)
    return launches


def rtdetr_val(data: str, card: str) -> dict:
    """(c) ``YOLO.val`` of rtdetr-l (float32, seed weights) on the first 16
    of phase val's PNG images, B=8: no NMS, no stem, finite metrics; img/s
    (host clock) and device ms a batch (model and decode, CUDA events).
    Returns the launches."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset

    d = check_det_dataset(data)
    files = sorted(Path(d["val"]).glob("*.png"))[:RTDETR_VAL_IMAGES]
    sub = {"path": d["path"], "val": [str(f) for f in files], "names": d["names"]}
    yolo = YOLO("rtdetr-l.yaml", device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=sub, imgsz=IMGSZ, batch=RTDETR_VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    img_s = RTDETR_VAL_IMAGES / (time.perf_counter() - t0)
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"rtdetr-l val: launches {launches}")
    mk = tuple(res["metrics"].mean_results())
    check(all(np.isfinite(mk)) and len(res["metrics"].stats["conf"]) == RTDETR_VAL_IMAGES,
          f"rtdetr-l val: {mk}")
    validator = yolo._validator(imgsz=IMGSZ, batch_size=RTDETR_VAL_BATCH)
    batch = letterboxed([img for i, img, _ in val_images() if i < RTDETR_VAL_BATCH])
    with torch.inference_mode():
        ms = cuda_ms(lambda: validator.nms(validator.forward(batch)), iters=3)
    print(f"phase rtdetr (c): rtdetr-l val {IMGSZ} f32 B={RTDETR_VAL_BATCH} on {RTDETR_VAL_IMAGES} PNG images, "
          f"launches {launches} (no NMS: the queries are the detections); P/R/mAP50/mAP50-95 "
          f"{tuple(round(v, 6) for v in mk)}; {img_s:.1f} img/s through YOLO.val (host clock, incl. PNG decode); "
          f"{ms:.2f} ms a batch on the device (model and decode, CUDA events) [{card}]", flush=True)
    return launches


def rtdetr_train(data: str, root: Path, card: str) -> dict:
    """(d) ``YOLO.train`` of rtdetr-l (seed weights, bf16 autocast, AdamW,
    the contrastive-denoising groups) for one epoch of two steps at B=4 on
    8 of phase val's images, no val and no plots: finite losses, weights
    moved; step ms, the Hungarian matching's host ms a step and the peak
    memory. Returns the launches."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset

    d = check_det_dataset(data)
    files = [str(f) for f in sorted(Path(d["val"]).glob("*.png"))[:RTDETR_TRAIN_IMAGES]]
    sub = {"path": d["path"], "train": files, "val": files, "names": d["names"]}
    yolo = YOLO("rtdetr-l.yaml", device="cuda")
    before = {k: v.clone() for k, v in yolo.model.state_dict().items() if v.is_floating_point()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.train(sub, epochs=1, batch=RTDETR_TRAIN_BATCH, imgsz=IMGSZ, workers=4, val=False, plots=False,
                     project=str(root / "runs_rtdetr"), verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"rtdetr-l train: launches {launches}")
    r, sp = res["results"][0], res["speed"][0]
    moved = sum(int(not torch.equal(v, before[k])) for k, v in yolo.model.state_dict().items() if k in before)
    check(res["epochs_run"] == 1 and np.isfinite(r["train/box_loss"]) and np.isfinite(r["train/cls_loss"])
          and moved > len(before) // 2, f"rtdetr-l train: {r}, {moved} of {len(before)} tensors moved")
    step = rtdetr_step_times(yolo, sub)
    print(f"phase rtdetr (d): rtdetr-l YOLO.train {IMGSZ} bf16 B={RTDETR_TRAIN_BATCH} AdamW with the denoising "
          f"groups, 1 epoch of {RTDETR_TRAIN_IMAGES // RTDETR_TRAIN_BATCH} steps, launches {launches}; loss box/cls "
          f"{r['train/box_loss']:.4f}/{r['train/cls_loss']:.4f}, {moved} of {len(before)} tensors moved; the epoch's "
          f"mean step {sp['step_ms']:.1f} ms (its first step's set-up included), loader wait "
          f"{sp['loader_wait_ms']:.1f} ms; peak {peak:.2f} GiB; {wall:.1f} s in all; then the step on one batch, "
          f"{step['steps']} after {step['warmup']} (host clock, each step ends in its syncs): "
          f"{step['step_ms']:.1f} ms, "
          f"of which the host waits {step['wait_ms']:.1f} ms for the matching costs (the forward queued before them) "
          f"and the Hungarian matching itself (SciPy, 7 layers x {RTDETR_TRAIN_BATCH} images) takes "
          f"{step['match_ms']:.2f} ms; peak {step['peak_gib']:.2f} GiB; one step under torch.profiler: "
          f"{step['launches']} kernel launches, {step['device_ms']:.2f} ms of device time "
          f"({1 - step['device_ms'] / step['step_ms']:.1%} of the step idle), split {step['split']}; top kernels: "
          f"{step['top']} [{card}]", flush=True)
    return launches


def rtdetr_step_times(yolo, data: dict, warmup: int = 2, steps: int = 5) -> dict:
    """The bf16 train step of ``yolo`` (forward, ``detr_loss`` with its
    matching, backward, AdamW, EMA) on the first batch of ``data``'s train
    split with its denoising groups, as ``YOLO.train`` makes them: mean ms of
    ``steps`` after ``warmup`` on the host clock, the host's wait for the
    matching costs and the assignments' ms, the peak memory, and one more
    step under torch.profiler (launches, device ms, ``rtdetr_split``)."""
    from fce_yolo_tpu_torch.api import _detr_training
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    d = check_det_dataset(data)
    ds = YOLODataset(d["train"], imgsz=IMGSZ, mode="train", nc=d["nc"], device="cuda")
    task_loss, keys, model_kwargs, hook = _detr_training(yolo.spec, d["nc"], IMGSZ)
    b = hook(dict(next(iter(DataLoader(ds, batch_size=RTDETR_TRAIN_BATCH, workers=4)))))
    bdev = {k: torch.from_numpy(b[k]).cuda() for k in ("img", "cls", "bboxes", "mask", *keys)}
    opt = Optimizer(OptimCfg(optimizer="AdamW", batch_size=RTDETR_TRAIN_BATCH, nbs=RTDETR_TRAIN_BATCH,
                             nc=d["nc"]), yolo.model)
    state = create_train_state(yolo.model, opt)
    step = make_train_step(yolo.model, opt, DetectionLossCfg(nc=d["nc"]), bf16=True, task_loss=task_loss,
                           model_kwargs=model_kwargs)
    for _ in range(warmup):
        step(state, bdev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wait = match = 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        _, m = step(state, bdev)
        wait, match = wait + m["match_wait_s"], match + m["match_host_s"]
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1e3 / steps, "wait_ms": wait * 1e3 / steps,
           "match_ms": match * 1e3 / steps, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "steps": steps, "warmup": warmup}
    rows, total = kernel_profile(lambda: step(state, bdev))
    out.update(launches=sum(c for _, c, _ in rows), device_ms=total, split=rtdetr_split(rows, total),
               top="; ".join(f"{n[:90]} x{c} {t:.3f} ms" for n, c, t in rows[:6]))
    return out


def phase_rtdetr(root: Path, data: str, card: str) -> dict:
    """RT-DETR: (a) the five YAMLs built and run once in bf16; (b) rtdetr-l
    card vs CPU and ``YOLO.predict`` at B=16 bf16 with its profile; (c) its
    ``YOLO.val``; (d) a two-step ``YOLO.train`` with the denoising groups.
    No kernel of the port is on these paths: the launches by path are all 0."""
    t_phase = time.perf_counter()
    rtdetr_forwards(card)
    paths = {"rtdetr_predict": rtdetr_predict(card)}
    torch.cuda.empty_cache()
    paths["rtdetr_val"] = rtdetr_val(data, card)
    torch.cuda.empty_cache()
    paths["rtdetr_train"] = rtdetr_train(data, root, card)
    torch.cuda.empty_cache()
    print(f"phase rtdetr: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths


# ------------------------------------------------------------------ phase world
WORLD_FAMILY = ("yolov8s-world.yaml", "yolov8s-worldv2.yaml", "yoloe-v8s.yaml", "yoloe-v8s-seg.yaml",
                "yoloe-11s.yaml", "yoloe-11s-seg.yaml")
WORLD_BUILD_BATCH = 2  # (a) one bf16 forward of each YAML
WORLD_CHECK_IMAGES = 2  # (b) card float32 preds against the CPU's
WORLD_TOL = 1e-4  # (b) preds, card vs CPU, float32 in both (TF32 off): scores absolute, boxes of the largest coordinate
CLIP_TOL = 1e-4  # (b) the CLIP towers' unit embeddings, card vs CPU, absolute
WORLD_PREDICT_IMAGES = 32  # (c) two batches of E2E_BATCH
WORLD_VAL_IMAGES, WORLD_VAL_BATCH = 16, 8  # (e) the first of phase val's images
WORLD_TRAIN_IMAGES, WORLD_TRAIN_BATCH = 8, 4  # (f) one epoch of two steps, then the step alone on one batch


def class_names(n: int = VAL_NC) -> list[str]:
    """phase val's class names, whose hash embeddings are the bound text."""
    return [f"class{i}" for i in range(n)]


def bind_text(model, names: list[str]) -> None:
    """Bind the hash embeddings of ``names`` on an open-vocabulary model, as
    a facade's ``set_classes`` does."""
    from fce_yolo_tpu_torch.nn.text_model import HashTextEncoder

    model.txt_feats = torch.from_numpy(HashTextEncoder().encode_text(names)[None]).to(next(model.parameters()).device)


def spread_scores(yolo) -> None:
    """Spread the seeded model's class scores, so that NMS keeps detections
    and its comparisons hold something: the contrastive heads' bias to 0
    (from -10), and a BNContrastiveHead's BatchNorm made to give unit
    variance on its input of two random images (the seeded graph shrinks its
    activations layer by layer, to ~1e-5 at the heads, below the BatchNorm's
    eps). Bind the text first: World's neck reads it."""
    head = yolo.model.detect
    feats: dict[int, torch.Tensor] = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, k=k: feats.__setitem__(k, o.float()))
             for k, m in enumerate(head.cv3)]
    x = torch.rand(2, 3, IMGSZ, IMGSZ, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED + 12))
    with torch.no_grad():
        yolo.model.eval()(x.to(next(yolo.model.parameters()).dtype))
        for h in hooks:
            h.remove()
        for k, h in enumerate(head.cv4):
            h.bias.zero_()
            if hasattr(h, "norm"):  # unit variance out, whatever the eps
                var = feats[k].var((0, 2, 3))
                h.norm.running_mean.copy_(feats[k].mean((0, 2, 3)))
                h.norm.running_var.copy_(var)
                h.norm.weight.copy_(torch.sqrt(var + h.norm.eps) / torch.sqrt(var))


def world_forwards(card: str) -> dict:
    """(a) Each World/YOLOE YAML built on the card at s (seed weights), the
    hash text of 80 names bound, one bf16 eval forward at B=2: finite
    ``preds`` (B, 8400, 4 + 80 [+ 32 mask coefficients]) at 640 px. Returns {name:
    (build ms, first forward ms, parameters)}."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.model import param_count

    out = {}
    x = torch.rand(WORLD_BUILD_BATCH, 3, IMGSZ, IMGSZ, device="cuda", generator=torch.Generator("cuda").manual_seed(
        SEED)).to(torch.bfloat16)
    for name in WORLD_FAMILY:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yolo = YOLO(name, device="cuda")
        bind_text(yolo.model, class_names())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        yolo.to(torch.bfloat16)
        with torch.inference_mode():
            preds = yolo.model(x)["preds"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_out = 4 + VAL_NC + (32 if "seg" in name else 0)
        anchors = sum((IMGSZ // s) ** 2 for s in (8, 16, 32))
        check(yolo.scale == "s" and yolo.spec.needs_text and tuple(preds.shape) == (WORLD_BUILD_BATCH, anchors, n_out)
              and bool(torch.isfinite(preds).all()), f"{name}: preds {tuple(preds.shape)}")
        out[name] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, param_count(yolo.model))
        del yolo, preds
        torch.cuda.empty_cache()
    print("phase world (a): " + "; ".join(f"{n} built in {b:.0f} ms, first bf16 forward B={WORLD_BUILD_BATCH} {IMGSZ} "
                                          f"{f:.0f} ms, {p:,} parameters" for n, (b, f, p) in out.items())
          + f"; hash text of {VAL_NC} names bound [{card}]", flush=True)
    return out


def world_card_vs_cpu(card: str) -> dict:
    """(b) yolov8s-worldv2 and yoloe-11s (seed weights, scores spread):
    float32 ``preds`` of 2 letterboxed images on the card (TF32 off) against a
    CPU copy: the class scores within WORLD_TOL absolute, the boxes within
    WORLD_TOL of the largest coordinate (as phase v10's V10_TOL); then the CLIP text and
    vision towers at ViT-B/32 size from one seeded random state dict, the
    card's unit embeddings against the CPU's within CLIP_TOL, each timed."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.clip_vision import CLIPVisionTower
    from fce_yolo_tpu_torch.nn.text_model import CLIPTextTower

    x = letterboxed(e2e_images(SEED + 8, 1)[:WORLD_CHECK_IMAGES]).permute(0, 3, 1, 2).float() / 255.0
    errs = {}
    for name in ("yolov8s-worldv2.yaml", "yoloe-11s.yaml"):
        card_m = YOLO(name, device="cuda")
        bind_text(card_m.model, class_names())
        spread_scores(card_m)
        cpu_m = YOLO(name, device="cpu")
        cpu_m.model.load_state_dict(card_m.model.state_dict())
        bind_text(cpu_m.model, class_names())
        with torch.inference_mode():
            ref = cpu_m.model.eval()(x.cpu())["preds"].numpy()
            got = card_m.model.eval()(x)["preds"].cpu().numpy()
        dscore = float(np.abs(got[..., 4:] - ref[..., 4:]).max())
        dbox = float(np.abs(got[..., :4] - ref[..., :4]).max()) / float(np.abs(ref[..., :4]).max())
        check(dscore <= WORLD_TOL and dbox <= WORLD_TOL and float(ref[..., 4:].std()) > 1e-3,
              f"{name}: preds card vs CPU: scores {dscore}, boxes {dbox} of the largest (limit {WORLD_TOL}), "
              f"score spread {ref[..., 4:].std()}")
        errs[name] = (dscore, dbox)
        del card_m, cpu_m
    rng = np.random.RandomState(SEED + 9)
    tokens = rng.randint(1, 49406, (8, 77))
    tokens[:, 0], tokens[np.arange(8), rng.randint(3, 77, 8)] = 49406, 49407  # start and end of text
    tokens = torch.from_numpy(tokens)
    imgs = torch.from_numpy(rng.normal(0, 1, (8, 3, 224, 224)).astype(np.float32))
    towers = {}
    for what, tower, inp in (("text", CLIPTextTower().reset_parameters(SEED), tokens),
                             ("vision", CLIPVisionTower().reset_parameters(SEED), imgs)):
        with torch.inference_mode():
            ref = tower.eval()(inp).numpy()
            tower.cuda()
            got = tower(inp.cuda()).cpu().numpy()
            ms = cuda_ms(lambda: tower(inp.cuda()), iters=5)
        err = float(np.abs(got - ref).max())
        check(err <= CLIP_TOL and np.allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-4),
              f"CLIP {what} tower card vs CPU {err} (limit {CLIP_TOL})")
        towers[what] = (err, ms, sum(p.numel() for p in tower.parameters()))
        del tower
    tower_notes = [f"{w} {e:.2e} (limit {CLIP_TOL}), {n:,} parameters, {ms:.2f} ms for 8 inputs float32 (CUDA events)"
                   for w, (e, ms, n) in towers.items()]
    print(f"phase world (b): float32 (TF32 off) preds of {WORLD_CHECK_IMAGES} images card vs CPU, scores absolute "
          "and boxes of the largest coordinate: " + "; ".join(f"{n} scores {e[0]:.2e}, boxes {e[1]:.2e}"
                                                               for n, e in errs.items())
          + f" (limit {WORLD_TOL}); CLIP towers (ViT-B/32, "
          "seeded random) card vs CPU: " + "; ".join(tower_notes) + f" [{card}]", flush=True)
    return errs


def world_predict(name: str, facade, card: str) -> dict:
    """(c) ``facade.set_classes`` of 80 names, then ``YOLO.predict`` in bf16
    (folded, seed weights, scores spread) at B=16 on 32 random arrays through
    ``task_predict``: the stem kernel once a batch on yoloe-11s (held against
    ``stem_reference`` on the first batch, the kernel path's preds against
    the plain path's), none on yolov8s-worldv2 (layer 2 is C2f); the NMS
    kernel once a batch, equal to the plain version on the first. The bound
    text reaches the kernel path: another binding moves its scores. Then
    one batch under torch.profiler. Returns the launches."""
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, stem_spec_from_model, stem_weights

    yolo = facade(name, device="cuda")
    yolo.set_classes(class_names())
    spread_scores(yolo)
    yolo.to(torch.bfloat16).fuse()
    stem = "yoloe-11" in name
    imgs = e2e_images(SEED + 10, 2)[:WORLD_PREDICT_IMAGES]
    p = task_predict("detect", card, name=name, imgs=imgs, stem=stem, yolo=yolo)
    batch = letterboxed(imgs[:E2E_BATCH])
    moved = None
    if stem:
        spec = stem_spec_from_model(yolo.spec, (IMGSZ, IMGSZ))
        weights = stem_weights(fold_stem_params(yolo.model, spec), spec)
        bound = yolo.model.txt_feats
        with torch.inference_mode():
            a = apply_with_fused_stem(yolo.model, batch, spec, weights)["preds"][..., 4:].float()
            yolo.model.txt_feats = bound.flip(1)  # the same names in another order
            b = apply_with_fused_stem(yolo.model, batch, spec, weights)["preds"][..., 4:].float()
        yolo.model.txt_feats = bound
        moved = float((a - b.flip(-1)).abs().max()), float((a - b).abs().max())
        check(moved[0] <= 0.02 and moved[1] > 0.01, f"{name}: the kernel path's scores do not follow the bound text "
              f"(reordered: {moved[0]}, as bound: {moved[1]})")
    predictor = DetectionPredictor(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=E2E_BATCH)
    with torch.inference_mode():
        rows, total = kernel_profile(lambda: predictor.infer(batch))
    split = rtdetr_split(rows, total)
    top = "; ".join(f"{n[:100]} x{c} {t:.3f} ms" for n, c, t in rows[:8])
    stem_note = (f"stem on the fed batch max|d|/max|ref|={p['stem_rel']:.3e} (limit 0.02), per-row max/median="
                 f"{p['stem_spread']:.2f} (limit 3); preds kernel vs plain path max|d|={p['dmax']:.3e} (limit "
                 f"{p['bound']:.3e}) corr={p['corr']:.6f}; the kernel path's scores with the names bound in reverse "
                 f"order: reversed back within {moved[0]:.2e}, as bound {moved[1]:.2e} away; ") if stem else \
        "no stem (layer 2 is C2f); "
    print(f"phase world (c): {name} set_classes({VAL_NC} names) predict {IMGSZ} bf16 B={E2E_BATCH}, {p['n_images']} "
          f"images, {p['n_det']} detections, launches {p['launches']}; {stem_note}NMS kernel idx/ok and outputs "
          f"equal to the plain version on the fed batch ({p['kept']} kept); {p['img_s']:.1f} img/s through "
          f"YOLO.predict (host clock, incl. letterbox); {p['ms']:.2f} ms/batch "
          f"{'stem kernel+' if stem else ''}model+NMS vs "
          f"{p['ms_plain']:.2f} plain (CUDA events); one batch under torch.profiler: {sum(c for _, c, _ in rows)} "
          f"kernel launches, {total:.2f} ms of device time ({1 - total / p['ms']:.1%} of the batch's {p['ms']:.2f} ms "
          f"idle), split {split}; top kernels: {top} [{card}]", flush=True)
    return p["launches"]


def world_visual_prompt(card: str) -> dict:
    """(d) ``YOLOE.predict(img, visual_prompts=...)`` of yoloe-11s in float32
    (TF32 off) on one 480x640 image with three prompt boxes of two classes:
    the NMS kernel once, no stem; the detections' classes are the prompts';
    the same call with the plain NMS gives the same rows. Returns the launches."""
    from fce_yolo_tpu_torch import YOLOE

    yolo = YOLOE("yoloe-11s.yaml", device="cuda")
    spread_scores(yolo)
    img = e2e_images(SEED + 11, 0)[0]
    vp = {"bboxes": np.array([[40, 40, 200, 220], [300, 100, 600, 400], [20, 300, 120, 460]], np.float32),
          "cls": np.array([5, 17, 5])}
    yolo.predict(img, visual_prompts=vp, imgsz=IMGSZ)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    r = yolo.predict(img, visual_prompts=vp, imgsz=IMGSZ, conf=0.0)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=1), f"yoloe-11s visual-prompt predict: launches {launches}")
    check(len(r) == MAX_DET and set(r.boxes.cls.astype(int)) <= {5, 17} and bool(np.isfinite(r.boxes.data).all()),
          f"yoloe-11s visual-prompt predict: {len(r)} rows, classes {set(r.boxes.cls.astype(int))}")
    kernel_vs_plain(lambda: {"rows": yolo.predict(img, visual_prompts=vp, imgsz=IMGSZ, conf=0.0)[0].boxes.data},
                    [], NMS_K, 0.7, MAX_DET, "yoloe-11s visual-prompt predict")
    print(f"phase world (d): yoloe-11s visual-prompt predict {IMGSZ} f32 on one 480x640 image, 3 prompt boxes of "
          f"classes 5 and 17, launches {launches} (no stem: the f32 model takes the plain layers 0-2); {len(r)} rows "
          f"at conf 0, classes {sorted(set(r.boxes.cls.astype(int)))}, equal with the plain NMS; {ms:.1f} ms a call "
          f"(host clock, incl. letterbox and the prompt masks) [{card}]", flush=True)
    return launches


def world_val(data: str, card: str) -> dict:
    """(e) ``YOLOWorld.val`` of yolov8s-worldv2 (float32, seed weights,
    scores spread, the 80 names bound) on the first 16 of phase val's PNG
    images at B=8: the NMS kernel once a batch, no stem; the first batch
    again with the kernel and with its plain version, equal. Returns the launches."""
    from fce_yolo_tpu_torch import YOLOWorld
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset

    d = check_det_dataset(data)
    files = sorted(Path(d["val"]).glob("*.png"))[:WORLD_VAL_IMAGES]
    sub = {"path": d["path"], "val": [str(f) for f in files], "names": d["names"]}
    yolo = YOLOWorld("yolov8s-worldv2.yaml", device="cuda")
    yolo.set_classes(class_names())
    spread_scores(yolo)
    reset_launches()
    t0 = time.perf_counter()
    res = yolo.val(data=sub, imgsz=IMGSZ, batch=WORLD_VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    img_s = WORLD_VAL_IMAGES / (time.perf_counter() - t0)
    launches = read_launches()
    n_batches = WORLD_VAL_IMAGES // WORLD_VAL_BATCH
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_batches), f"yolov8s-worldv2 val: launches {launches}")
    mk = tuple(res["metrics"].mean_results())
    check(all(np.isfinite(mk)), f"yolov8s-worldv2 val: {mk}")
    val = yolo._validator(imgsz=IMGSZ, batch_size=WORLD_VAL_BATCH)
    batch = next(iter(val.get_dataloader(sub)))
    img = torch.from_numpy(batch["img"]).cuda()
    with torch.inference_mode():
        preds = val.forward(img)
    outs = kernel_vs_plain(lambda: val.to_host(val.nms(preds)), [], NMS_K_VAL, val.iou, val.max_det,
                           "yolov8s-worldv2 val batch 1")
    with torch.inference_mode():
        ms = cuda_ms(lambda: val.nms(val.forward(img)), iters=3)
    print(f"phase world (e): yolov8s-worldv2 YOLOWorld.val {IMGSZ} f32 B={WORLD_VAL_BATCH} on {WORLD_VAL_IMAGES} PNG "
          f"images, the {VAL_NC} names bound, launches {launches}; P/R/mAP50/mAP50-95 "
          f"{tuple(round(v, 6) for v in mk)}; "
          f"the first batch's NMS equal from the kernel and the plain version "
          f"({int(outs['kernel']['valid'].sum())} kept); {img_s:.1f} img/s through YOLO.val (host clock, incl. PNG "
          f"decode); {ms:.2f} ms a batch on the device (model and NMS, CUDA events) [{card}]", flush=True)
    return launches


def world_train(data: str, root: Path, card: str) -> dict:
    """(f) Two trainings of one epoch of two steps at B=4 in bf16 (AdamW, no
    val, no plots) on 8 of phase val's images as both splits:
    ``YOLOWorldTrainable.train_multimodal`` of yolov8s-worldv2 (M = 80
    sampled texts a sample) and ``YOLOE.train_visual_prompt`` of yoloe-11s
    (the ground truth's 80 P3 masks a sample; every parameter outside
    ``savpe`` bit-equal after). Finite losses and peak memory; then the
    step alone on one batch (``world_step_times``). Returns the launches by
    training."""
    from fce_yolo_tpu_torch import YOLOE
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset
    from fce_yolo_tpu_torch.models.world import YOLOWorldTrainable

    d = check_det_dataset(data)
    files = [str(f) for f in sorted(Path(d["val"]).glob("*.png"))[:WORLD_TRAIN_IMAGES]]
    sub = {"path": d["path"], "train": files, "val": files, "names": d["names"]}
    out, notes = {}, []
    runs = (("multimodal", YOLOWorldTrainable("yolov8s-worldv2.yaml", device="cuda"),
             f"yolov8s-worldv2, M={VAL_NC} sampled texts"),
            ("visual_prompt", YOLOE("yoloe-11s.yaml", device="cuda"), "yoloe-11s, freeze except:savpe"))
    for what, yolo, about in runs:
        before = {k: v.clone() for k, v in yolo.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        run = yolo.train_multimodal if what == "multimodal" else yolo.train_visual_prompt
        res = run(sub, epochs=1, batch=WORLD_TRAIN_BATCH, imgsz=IMGSZ, workers=4, val=False, plots=False,
                  project=str(root / f"runs_world_{what}"), verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[f"world_train_{what}"] = launches = read_launches()
        check(launches == no_jpeg(fused_stem=0, pick_suppress=0), f"world train {what}: launches {launches}")
        r, sp = res["results"][0], res["speed"][0]
        moved = {k for k, v in yolo.model.named_parameters() if not torch.equal(v, before[k])}
        check(res["epochs_run"] == 1 and np.isfinite(r["train/box_loss"]) and np.isfinite(r["train/cls_loss"])
              and len(moved) > 0, f"world train {what}: {r}, {len(moved)} tensors moved")
        outside = sorted(k for k in moved if ".savpe." not in k)
        if what == "visual_prompt":
            check(not outside, f"visual-prompt training moved parameters outside savpe: {outside[:5]}")
        frozen_note = " (all in savpe; the rest bit-equal)" if what == "visual_prompt" else ""
        step = world_step_times(yolo, sub, what)
        notes.append(f"{what} ({about}): loss box/cls/dfl {r['train/box_loss']:.4f}/{r['train/cls_loss']:.4f}/"
                     f"{r['train/dfl_loss']:.4f}, {len(moved)} of {len(before)} parameters moved{frozen_note}; "
                     f"the epoch's mean step {sp['step_ms']:.1f} ms (its first step's set-up included), loader wait "
                     f"{sp['loader_wait_ms']:.1f} ms; peak {peak:.2f} GiB; {wall:.1f} s in all; then the step on "
                     f"one batch, {step['steps']} after {step['warmup']} (host clock, each step ends in its sync): "
                     f"{step['step_ms']:.1f} ms, peak {step['peak_gib']:.2f} GiB")
        del yolo, before
        torch.cuda.empty_cache()
    print(f"phase world (f): YOLO.train {IMGSZ} bf16 B={WORLD_TRAIN_BATCH} AdamW, 1 epoch of "
          f"{WORLD_TRAIN_IMAGES // WORLD_TRAIN_BATCH} steps, launches none of the kernels: " + "; ".join(notes)
          + f" [{card}]", flush=True)
    return out


def world_step_times(yolo, data: dict, what: str, warmup: int = 2, steps: int = 5) -> dict:
    """The bf16 train step of ``yolo`` after its training in (f) (forward
    with the batch's ``txt_feats`` or ``visual_prompts``, the detection loss
    over its K class slots, backward, AdamW, EMA; ``freeze=["except:savpe"]``
    for the visual-prompt one) on the first batch of ``data``'s train split
    as the training's dataset makes it: mean ms of ``steps`` after ``warmup``
    on the host clock, and the peak memory."""
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader
    from fce_yolo_tpu_torch.data.multimodal import YOLOMultiModalDataset, YOLOVisualPromptDataset
    from fce_yolo_tpu_torch.models.world import dataset_names
    from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    d = check_det_dataset(data)
    if what == "multimodal":
        ds = YOLOMultiModalDataset(d["train"], imgsz=IMGSZ, mode="train", device="cuda", names=dataset_names(data),
                                   max_samples=min(d["nc"], 80))
        key, freeze = "txt_feats", None
    else:
        ds = YOLOVisualPromptDataset(d["train"], imgsz=IMGSZ, mode="train", device="cuda", nc=d["nc"])
        key, freeze = "visual_prompts", ["except:savpe"]
    b = next(iter(DataLoader(ds, batch_size=WORLD_TRAIN_BATCH, workers=4)))
    bdev = {k: torch.from_numpy(b[k]).cuda() for k in ("img", "cls", "bboxes", "mask", key)}
    opt = Optimizer(OptimCfg(optimizer="AdamW", batch_size=WORLD_TRAIN_BATCH, nbs=WORLD_TRAIN_BATCH, nc=d["nc"]),
                    yolo.model, freeze=freeze)
    state = create_train_state(yolo.model, opt)
    step = make_train_step(yolo.model, opt, DetectionLossCfg(nc=d["nc"], strides=tuple(yolo.strides)), bf16=True)
    for _ in range(warmup):
        state, m = step(state, bdev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, bdev)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(m["loss"])), f"world train {what}: the step alone gave loss {m['loss']}")
    return {"step_ms": (time.perf_counter() - t0) * 1e3 / steps, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "steps": steps, "warmup": warmup}


def phase_world(root: Path, data: str, card: str) -> dict:
    """YOLO-World and YOLOE: (a) the six YAMLs built and run once in bf16;
    (b) card vs CPU and the CLIP towers; (c) ``YOLOE``/``YOLOWorld``
    text predict at B=16 bf16 through the stem (yoloe-11s) and NMS kernels;
    (d) a visual-prompt predict; (e) ``YOLOWorld.val``; (f) the multimodal and
    visual-prompt trainings. Returns each path's launches."""
    from fce_yolo_tpu_torch import YOLOE, YOLOWorld

    t_phase = time.perf_counter()
    world_forwards(card)
    world_card_vs_cpu(card)
    torch.cuda.empty_cache()
    paths = {"world_predict_yoloe": world_predict("yoloe-11s.yaml", YOLOE, card)}
    torch.cuda.empty_cache()
    paths["world_predict_world"] = world_predict("yolov8s-worldv2.yaml", YOLOWorld, card)
    torch.cuda.empty_cache()
    paths["world_visual_prompt"] = world_visual_prompt(card)
    paths["world_val"] = world_val(data, card)
    torch.cuda.empty_cache()
    paths.update(world_train(data, root, card))
    print(f"phase world: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths


WEIGHTS_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_checkpoint"
WEIGHTS_PREDICTIONS = WEIGHTS_FIXTURE.parent / "jax_checkpoint_predictions.npz"
WEIGHTS_TOL = {"xyxy": 1e-2, "conf": 1e-4, "preds": 1e-4}  # card float32 (TF32 off) vs JAX's float32 on a CPU
ZSTD_ITERS = 20  # phase weights (c): C++ decodes of the fixture's largest chunk, timed together


def leaf_bytes(x) -> bytes:
    """A checkpoint leaf's bytes (numpy, or a bfloat16 tensor)."""
    return x.view(torch.int16).numpy().tobytes() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x).tobytes()


def weights_pt(root: Path, card: str) -> tuple[dict, float]:
    """(a) An Ultralytics-layout ``.pt`` of yolo11s-fce (80 classes; seed
    weights without the class prior): the trainer's ``{"model": fp16,
    "ema": fp32, "epoch", "train_args"}``, the Detect head's
    ``dfl.conv.weight`` and the ``num_batches_tracked`` buffers included;
    ``YOLO(path)`` on the card, its weights equal to the ``ema`` tensors,
    then ``task_predict`` of it in bf16 at B=16 (the stem and NMS kernels
    launched once, each held against its plain version). Returns the
    launches and the load ms."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.model import init_weights

    src = YOLO("yolo11s-fce.yaml", device="cpu")
    init_weights(src.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    ema = {k: v.clone() for k, v in src.model.state_dict().items()}
    ema[f"model.{len(src.model.model) - 1}.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    half = {k: v.half() if v.is_floating_point() else v for k, v in ema.items()}
    path = root / "yolo11s-fce.pt"
    torch.save({"model": half, "ema": ema, "epoch": 299, "train_args": {"model": "yolo11s-fce.yaml", "imgsz": IMGSZ}},
               path)
    del src
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yolo = YOLO(str(path), device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    got = yolo.model.state_dict()
    differ = [k for k in got if not k.endswith("num_batches_tracked") and not torch.equal(got[k].cpu(), ema[k])]
    check(not differ, f"phase weights (a): {len(differ)} tensors differ from the .pt's ema, e.g. {differ[:3]}")
    check(any(not torch.equal(half[k].float(), ema[k]) for k in got if ema[k].is_floating_point()),
          "phase weights (a): the fp16 model entry should differ from the ema")
    yolo.to(torch.bfloat16).fuse()
    p = task_predict("detect", card, name="yolo11s-fce.pt", imgs=e2e_images(SEED + 9, 1)[:E2E_BATCH], yolo=yolo)
    check(p["launches"] == no_jpeg(fused_stem=1, pick_suppress=1), f"phase weights (a): launches {p['launches']}")
    print(f"phase weights (a): YOLO('yolo11s-fce.pt') on the card in {load_ms:.1f} ms ({path.stat().st_size} bytes, "
          f"{len(got)} tensors equal to the ema's); bf16 predict of {p['n_images']} images at B={E2E_BATCH}: "
          f"launches {p['launches']}, {p['n_det']} detections, stem on the fed batch max|d|/max|ref|="
          f"{p['stem_rel']:.3e} (limit 0.02) per-row max/median={p['stem_spread']:.2f} (limit 3), kernel path preds "
          f"vs plain max|d|={p['dmax']:.3e} (limit {p['bound']:.3e}) corr={p['corr']:.6f}, NMS idx/ok equal to "
          f"the plain version's ({p['kept']} kept); device {p['ms']:.2f} ms a batch, plain stem {p['ms_plain']:.2f}; "
          f"{p['img_s']:.1f} img/s [{card}]", flush=True)
    del yolo
    torch.cuda.empty_cache()
    return p["launches"], load_ms


def weights_fixture(card: str) -> tuple[dict, int, float]:
    """(b) The committed JAX checkpoint (``tests/fixtures/jax_checkpoint``,
    written by the JAX package's ``save_checkpoint``: a narrow yolo11-fce
    user YAML, bfloat16 params) read by ``YOLO(path)`` on the card, zstd
    through the C++ decoder; every leaf byte-equal to the Python decoder's
    read; ``YOLO.predict`` in float32 through the NMS kernel (the stem is
    not eligible at 16-128 channels) within ``WEIGHTS_TOL`` of the JAX
    facade's stored predictions. Returns the predict's launches, the
    decoder's calls in ``YOLO(path)`` and the load ms."""
    import contextlib

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.augment import letterbox
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model
    from fce_yolo_tpu_torch.utils import zstd
    from fce_yolo_tpu_torch.utils.checkpoint import load_jax_checkpoint

    ref = np.load(WEIGHTS_PREDICTIONS)
    imgsz = int(ref["imgsz"])
    zstd.decompress_host.launches = 0
    t0 = time.perf_counter()
    with contextlib.chdir(WEIGHTS_FIXTURE.parents[2]):  # meta.json names its YAML relative to the repo
        yolo = YOLO(str(WEIGHTS_FIXTURE), device="cuda")
    load_ms = (time.perf_counter() - t0) * 1e3
    calls = zstd.decompress_host.launches
    check(calls > 0, "phase weights (b): YOLO(fixture) ran no C++ zstd decode")
    tree, _ = load_jax_checkpoint(WEIGHTS_FIXTURE, collections=None, device="cuda")
    t0 = time.perf_counter()
    plain, _ = load_jax_checkpoint(WEIGHTS_FIXTURE, collections=None, device="cpu")
    plain_s = time.perf_counter() - t0

    def leaves(t, prefix=""):
        for k, v in t.items():
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    a, b = dict(leaves(tree)), dict(leaves(plain))
    differ = [k for k in a if leaf_bytes(a[k]) != leaf_bytes(b[k])]
    check(a.keys() == b.keys() and not differ, f"phase weights (b): C++ and Python reads differ: {differ[:3]}")
    check(stem_spec_from_model(yolo.spec, (imgsz, imgsz)) is None, "phase weights (b): the narrow model took the stem")

    rng = np.random.RandomState(int(ref["seed"]))
    imgs = [rng.randint(0, 256, tuple(sh), np.uint8) for sh in ref["shapes"]]
    reset_launches()
    res = yolo.predict(imgs, imgsz=imgsz, conf=float(ref["conf"]), batch=len(imgs))
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == no_jpeg(fused_stem=0, pick_suppress=1), f"phase weights (b): launches {launches}")
    counts = [len(r) for r in res]
    check(counts == ref["det_counts"].tolist(), f"phase weights (b): detections {counts}, JAX {ref['det_counts']}")
    det = np.concatenate([np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1) for r in res])
    d_xyxy = float(np.abs(det[:, :4] - ref["det"][:, :4]).max())
    d_conf = float(np.abs(det[:, 4] - ref["det"][:, 4]).max())
    check(np.array_equal(det[:, 5], ref["det"][:, 5]) and d_xyxy <= WEIGHTS_TOL["xyxy"]
          and d_conf <= WEIGHTS_TOL["conf"], f"phase weights (b): predictions off JAX's: boxes {d_xyxy}, conf {d_conf}")
    x = np.stack([letterbox(im, imgsz, scaleup=False)[0][..., ::-1] for im in imgs]).astype(np.float32) / 255.0
    with torch.inference_mode():
        preds = yolo.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).cuda())["preds"].float().cpu().numpy()
    d_preds = float(np.abs(preds - ref["preds"]).max()) / float(np.abs(ref["preds"]).max())
    check(d_preds <= WEIGHTS_TOL["preds"], f"phase weights (b): raw preds off JAX's by {d_preds:.3e} of the largest")
    print(f"phase weights (b): YOLO(jax_checkpoint) on the card in {load_ms:.1f} ms ({calls} C++ zstd decodes; "
          f"{len(a)} leaves byte-equal to the Python decoder's read, which took {plain_s * 1e3:.1f} ms); the narrow "
          f"model is not eligible for the stem (16-128 channels); float32 predict of {len(imgs)} images at {imgsz} px: "
          f"launches {launches}, detections {counts} as JAX's, classes equal, boxes within {d_xyxy:.3e} px (limit "
          f"{WEIGHTS_TOL['xyxy']}), scores within {d_conf:.3e} (limit {WEIGHTS_TOL['conf']}), raw preds within "
          f"{d_preds:.3e} of the largest (limit {WEIGHTS_TOL['preds']}) [{card}]", flush=True)
    return launches, calls, load_ms


def weights_decode_speed(card: str) -> dict:
    """(c) ``fce_zstd_decompress`` against the Python decoder on the
    fixture's largest chunk (host clock), MB/s of decoded bytes, and the
    time a yolo11s-fce checkpoint's float32 leaves would take at those
    rates (an extrapolation: its chunks are not read here)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.utils import zstd
    from fce_yolo_tpu_torch.utils.ocdbt import OcdbtStore

    launches = zstd.decompress_host.launches
    store = OcdbtStore(WEIGHTS_FIXTURE / "tree", "cuda")
    key = max((k for k in store.list() if not k.endswith(".zarray")), key=lambda k: len(store.read(k)))
    frame = store.read(key)
    out = zstd.decompress_host(frame)
    t0 = time.perf_counter()
    for _ in range(ZSTD_ITERS):
        zstd.decompress_host(frame, len(out))
    ms = (time.perf_counter() - t0) * 1e3 / ZSTD_ITERS
    zstd.decompress_host.launches = launches  # timing calls are not the path's
    t0 = time.perf_counter()
    plain = zstd.decompress_plain(frame)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(plain == out, f"phase weights (c): the decoders differ on {key}")
    mb_s, plain_mb_s = len(out) / ms / 1e3, len(out) / plain_ms / 1e3
    s_bytes = sum(v.numel() * 4 for k, v in YOLO("yolo11s-fce.yaml", device="cpu").model.state_dict().items()
                  if not k.endswith("num_batches_tracked"))
    bound_ms = 1e3 * (len(frame) + len(out)) / HBM_BYTES_PER_S
    print(f"phase weights (c): zstd on {key} ({len(frame)} -> {len(out)} bytes): C++ {ms:.3f} ms ({mb_s:.1f} MB/s), "
          f"Python {plain_ms:.1f} ms ({plain_mb_s:.2f} MB/s), bytes bound on the card {bound_ms:.5f} ms; extrapolated: "
          f"a yolo11s-fce checkpoint ({s_bytes} bytes of float32 leaves) decodes in {s_bytes / mb_s / 1e6:.3f} s "
          f"through C++, {s_bytes / plain_mb_s / 1e6:.1f} s through Python [{card}]", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "mb_s": mb_s, "plain_mb_s": plain_mb_s, "chunk": key, "chunk_bytes": len(out),
            "yolo11s_fce_bytes": s_bytes, "yolo11s_fce_s_extrapolated": s_bytes / mb_s / 1e6}


def phase_weights(root: Path, card: str) -> tuple[dict, dict]:
    """Weights in: (a) a ``.pt`` at full width, (b) the JAX checkpoint
    fixture, (c) the zstd decoders' speed. Returns the paths' launches and
    the ``fce_zstd_decompress`` record."""
    t_phase = time.perf_counter()
    pt_launches, pt_ms = weights_pt(root, card)
    fixture_launches, calls, fixture_ms = weights_fixture(card)
    record = weights_decode_speed(card)
    record.update(launches=calls, pt_load_ms=pt_ms, fixture_load_ms=fixture_ms)
    print(f"phase weights: phase {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"weights_pt": pt_launches, "weights_jax": fixture_launches}, record


# ------------------------------------------------------------ phase cli
CLI_PREDICT_IMAGES = 16  # (c) predict reads the first JPEGs of phase jpeg's 64, one a batch as the CLI does
CLI_MAX_DET = 5  # (c) at most this many detections (so crops) an image
CLI_TUNE_ITERATIONS = 2  # (f) YOLO.tune: iterations of one epoch each
PROFILE_CALLS = 3 + 20  # (d) profile_inference: warmup and timed batches, one stem and one NMS launch each


class call_count:
    """Within the block, count the calls of ``module``'s function ``name``
    (not a kernel wrapper: a wrapper's own count must stay its launches)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.n += 1
            return self.real(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def cli_data(root: Path) -> str:
    """Phase jpeg's 64 JPEGs as both splits, as a data YAML file (what the CLI takes)."""
    names = "".join(f"  - class{i}\n" for i in range(VAL_NC))
    path = root / "jpeg" / "cli.yaml"
    path.write_text(f"path: {root / 'jpeg'}\ntrain: images/val\nval: images/val\nnames:\n{names}")
    return str(path)


def cli_run(argv: list[str]):
    """``entrypoint(argv)`` with the counts at 0 and the JPEG reads counted;
    returns (its result, launches, JPEG decodes, seconds)."""
    from fce_yolo_tpu_torch.cfg import entrypoint
    from fce_yolo_tpu_torch.data import avi, imread

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with call_count(imread, "decode_jpeg") as files, call_count(avi, "decode_jpeg") as frames:
        out = entrypoint(argv)
    torch.cuda.synchronize()
    return out, read_launches(), files.n + frames.n, time.perf_counter() - t0


def phase_cli(root: Path, short_avi: Path, e2e_img_s: float, train_img_s: list[float], card: str) -> dict:
    """The command line (``python -m fce_yolo_tpu_torch``, ``cfg/__init__.py::entrypoint``)
    with no ``device=`` (the card), each mode with the counts at 0:
    (a) ``checks`` in a subprocess names the card;
    (b) ``detect train`` of yolo11s-fce from phase val's matching weights
    (saved as a checkpoint, so that boxes score ~0.73 and mAP is above
    zero), 640 px, B=16, 1 epoch with val, on phase jpeg's 64 JPEGs as both
    splits: NMS once a val batch, both JPEG kernels once a read (64 train
    items without mosaic in a 1-epoch run, 64 val images), ``jpeg_fdct``
    once a train mosaic written, the epoch's fitness above zero;
    (c) ``val`` and ``predict ... save=True save_txt=True save_crop=True``
    of its ``best``: val's metrics equal to the run's, NMS once a val batch,
    held against its plain version on the val's first batch
    (``nms_kernel_vs_plain``); predict at the default conf on 16 JPEGs one
    a batch: NMS and both JPEG kernels once an image, ``jpeg_fdct`` once a
    written plot or crop;
    (d) ``benchmark model=yolo11s-fce.yaml batch=16``: the native row
    (``profile_inference``, bf16) with the stem and NMS kernels once a batch
    over the warmup and timed batches, the stem held against its plain
    version on the benchmark's first batch; the ``stablehlo`` row as the
    port's ``torch_export`` (exported, read back, timed: no kernel), the
    ``saved_model`` and ``tflite`` rows FAILED, naming TensorFlow;
    (e) ``track ... save=True`` of (b)'s matching checkpoint on phase
    video's short AVI: NMS, both JPEG kernels and ``jpeg_fdct`` once a
    frame, tracks drawn;
    (f) ``YOLO.tune`` of 2 iterations of 1 epoch: both runs finished (the
    tuner scores a failed run 0 and goes on, so each run is watched), the
    CSV's rows, NMS once a val batch of each run and ``jpeg_fdct`` once a
    train mosaic written; both JPEG kernels once a decode counted (the
    mixup and cutmix donors a run reads depend on its mutated
    hyperparameters, so the decodes are counted, not predicted).
    Returns each mode's launches, keyed "cli_<mode>"."""
    import os

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data import imread as reader
    from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator

    t_phase = time.perf_counter()
    paths, secs = {}, {}
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "fce_yolo_tpu_torch", "checks"], cwd=repo, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(repo)})
    secs["checks"] = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(0)
    check(res.returncode == 0 and f"cuda:0 {kind}" in res.stdout,
          f"phase cli (a): `checks` did not name the card: rc {res.returncode}\n{res.stdout}\n{res.stderr[-2000:]}")
    devices = next(line for line in res.stdout.splitlines() if line.startswith("devices"))
    print(f"phase cli (a): python -m fce_yolo_tpu_torch checks: {' '.join(devices.split())} ({secs['checks']:.1f} s, "
          f"a process of its own) [{card}]", flush=True)

    data = cli_data(root)
    project = root / "cli_runs"
    n_val = -(-VAL_IMAGES // VAL_BATCH)
    matching = matching_model(YOLO("yolo11s-fce.yaml", device="cuda")).save(root / "cli_matching")
    out, launches, reads, secs["train"] = cli_run(
        ["detect", "train", f"data={data}", f"model={matching}", f"imgsz={IMGSZ}", "epochs=1",
         f"batch={VAL_BATCH}", "val=True", f"project={project}", "name=train", "verbose=False"])
    paths["cli_train"] = launches
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_val, jpeg_fdct=train_plots(n_val))
          | {"jpeg_idct": reads, "jpeg_color": reads} and reads == 2 * VAL_IMAGES,
          f"phase cli (b) train: launches {launches}, {reads} JPEG reads")
    rows = out["results"]
    check(out["epochs_run"] == len(rows) == 1 and rows[0]["fitness"] > 0 and all(
        np.isfinite(rows[0][k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")),
        f"phase cli (b) train: {rows}")
    best = Path(out["save_dir"]) / "weights" / "best"
    check((best / "meta.json").exists() and (best.parent / "last" / "meta.json").exists(), "phase cli (b): weights")
    sp = out["speed"][0]
    print(f"phase cli (b): detect train yolo11s-fce from the matching weights {IMGSZ} B={VAL_BATCH}, 1 epoch on the {VAL_IMAGES} JPEGs as both "
          f"splits, launches {launches}; {sp['img_per_s']:.2f} img/s in the epoch (phase train on PNG: "
          f"{', '.join(f'{v:.2f}' for v in train_img_s)}), loader wait {sp['loader_wait_ms']:.1f} ms, step "
          f"{sp['step_ms']:.1f} ms a step, val {sp['val_s']:.2f} s; fitness {rows[0]['fitness']:.6f}; "
          f"{secs['train']:.1f} s [{card}]", flush=True)

    captured: list[torch.Tensor] = []
    real_nms = DetectionValidator.nms

    def capturing_nms(self, preds):  # keeps each val batch's preds for the check after the run
        captured.append(preds.detach().clone())
        return real_nms(self, preds)

    DetectionValidator.nms = capturing_nms
    try:
        metrics, launches, reads, secs["val"] = cli_run(
            ["detect", "val", f"model={best}", f"data={data}", f"imgsz={IMGSZ}", f"batch={VAL_BATCH}",
             "verbose=False"])
    finally:
        DetectionValidator.nms = real_nms
    paths["cli_val"] = launches
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_val) | {"jpeg_idct": VAL_IMAGES, "jpeg_color": VAL_IMAGES}
          and reads == VAL_IMAGES, f"phase cli (c) val: launches {launches}, {reads} reads")
    check(all(abs(metrics[k] - rows[0][k]) <= 1e-6 for k in metrics),
          f"phase cli (c): val of best {metrics} vs {rows}")
    again = YOLO(str(best), device="cuda")
    val = DetectionValidator(again.model, again.names, imgsz=IMGSZ, batch_size=VAL_BATCH)  # the CLI's NMS settings
    calls: list = []
    check(len(captured) == n_val, f"phase cli (c): {len(captured)} val batches seen")
    nms_kernel_vs_plain(val, captured[0], calls)
    del captured, again, val
    print(f"phase cli (c): detect val of best, launches {launches}; NMS kernel idx/ok equal to the plain version on "
          f"the first val batch; metrics {({k: round(v, 6) for k, v in metrics.items()})} equal to the run's; "
          f"{VAL_IMAGES / secs['val']:.1f} img/s, {secs['val']:.1f} s [{card}]", flush=True)

    src = root / "cli_predict"
    src.mkdir()
    for f in sorted((root / "jpeg" / "images" / "val").iterdir())[:CLI_PREDICT_IMAGES]:
        (src / f.name).write_bytes(f.read_bytes())
    results, launches, reads, secs["predict"] = cli_run(
        ["detect", "predict", f"model={best}", f"source={src}", f"imgsz={IMGSZ}",
         f"max_det={CLI_MAX_DET}", "save=True", "save_txt=True", "save_crop=True", f"project={project}",
         "name=predict", "verbose=False"])
    paths["cli_predict"] = launches
    n_det = sum(len(r) for r in results)
    out_dir = project / "predict"
    crops = list((out_dir / "crops").rglob("*.jpg"))
    labels = sorted((out_dir / "labels").glob("*.txt"))
    check(launches == {"fused_stem": 0, "pick_suppress": CLI_PREDICT_IMAGES, "jpeg_idct": CLI_PREDICT_IMAGES,
                       "jpeg_color": CLI_PREDICT_IMAGES, "jpeg_fdct": CLI_PREDICT_IMAGES + n_det, "webp_color": 0}
          and reads == CLI_PREDICT_IMAGES, f"phase cli (c) predict: launches {launches}, {n_det} detections")
    check(len(results) == CLI_PREDICT_IMAGES and 0 < n_det <= CLI_PREDICT_IMAGES * CLI_MAX_DET
          and len(crops) == n_det and len(labels) == CLI_PREDICT_IMAGES
          and sum(len(p.read_text().splitlines()) for p in labels) == n_det
          and len(list(out_dir.glob("*.jpg"))) == CLI_PREDICT_IMAGES,
          f"phase cli (c) predict: {n_det} detections, {len(crops)} crops, {len(labels)} label files")
    first = reader.imread(out_dir / f"{Path(results[0].path).stem}.jpg", device="cuda")
    check(first.shape == results[0].orig_img.shape, f"phase cli (c): saved plot {first.shape}")
    print(f"phase cli (c): detect predict of best on {CLI_PREDICT_IMAGES} JPEGs (conf 0.25, max_det {CLI_MAX_DET}, "
          f"save, save_txt, save_crop), launches {launches}; {n_det} detections, {len(crops)} crops, "
          f"{len(labels)} label files; {CLI_PREDICT_IMAGES / secs['predict']:.1f} img/s with the writes, "
          f"{secs['predict']:.1f} s [{card}]", flush=True)

    fed: list = []
    real_infer = DetectionPredictor.infer

    def keeping_infer(self, batch_u8):  # keeps the benchmark's first batch and its predictor's stem
        if not fed:
            fed.append((self, batch_u8.clone()))
        return real_infer(self, batch_u8)

    DetectionPredictor.infer = keeping_infer
    try:
        rows, launches, reads, secs["benchmark"] = cli_run(
            ["detect", "benchmark", "model=yolo11s-fce.yaml", f"imgsz={IMGSZ}", f"batch={E2E_BATCH}"])
    finally:
        DetectionPredictor.infer = real_infer
    paths["cli_benchmark"] = launches
    check(launches == no_jpeg(fused_stem=PROFILE_CALLS, pick_suppress=PROFILE_CALLS) and reads == 0,
          f"phase cli (d) benchmark: launches {launches}, expected the stem and NMS {PROFILE_CALLS} times each")
    native = rows[0]
    check(native["format"] == "torch (native)" and native["status"] == "OK" and native["batch"] == E2E_BATCH
          and native["images/sec"] > 0, f"phase cli (d): native row {native}")
    exported = rows[1]
    check(len(rows) == 4 and exported["format"] == "torch_export" and exported["status"] == "OK"
          and exported["ms/img"] > 0 and all(
              r["status"].startswith(f"FAILED: NotImplementedError: '{r['format']}' needs TensorFlow") for r in rows[2:]),
          f"phase cli (d): export rows {rows[1:]}")
    pred, batch = fed[0]
    check(pred._stem is not None and tuple(batch.shape) == (E2E_BATCH, IMGSZ, IMGSZ, 3),
          "phase cli (d): the benchmark's predictor did not take the stem")
    _, stem_rel, stem_spread = check_stem(batch, pred._stem[1], pred._stem[0], "phase cli (d)")
    del fed, pred, batch
    print(f"phase cli (d): detect benchmark yolo11s-fce {IMGSZ} B={E2E_BATCH} bf16, launches {launches}; native row "
          f"{native['images/sec']} images/sec, {native['ms/img']} ms/img (phase e2e's YOLO.predict on arrays: "
          f"{e2e_img_s:.1f} img/s); export rows: torch_export (stablehlo's) {exported['images/sec']} images/sec, "
          f"{exported['ms/img']} ms/img (the f32 program at B=1 through AutoBackend), "
          f"{[r['format'] for r in rows[2:]]} FAILED naming TensorFlow; stem on the "
          f"benchmark's first batch max|d|/max|ref|={stem_rel:.3e} (limit 0.02), per-row max/median={stem_spread:.2f} "
          f"(limit 3); {secs['benchmark']:.1f} s [{card}]", flush=True)

    n_frames = VIDEO_OBB_FRAMES
    out, launches, reads, secs["track"] = cli_run(
        ["detect", "track", f"model={matching}", f"source={short_avi}", f"imgsz={IMGSZ}", "save=True",
         f"project={project}", "name=track"])
    paths["cli_track"] = launches
    check(launches == {"fused_stem": 0, "pick_suppress": n_frames, "jpeg_idct": n_frames, "jpeg_color": n_frames,
                       "jpeg_fdct": n_frames, "webp_color": 0} and reads == n_frames,
          f"phase cli (e) track: launches {launches}, {reads} frames read")
    saved = sorted((project / "track").glob("*.jpg"))
    check(len(out) == n_frames and [p.name for p in saved] == [f"{i:06d}.jpg" for i in range(n_frames)]
          and all(np.isfinite(t).all() for _, t in out) and sum(len(t) for _, t in out) > 0,
          f"phase cli (e): {len(out)} frames, {len(saved)} saved, {sum(len(t) for _, t in out)} track rows")
    frame = reader.imread(saved[0], device="cuda")
    check(frame.shape == out[0][0].orig_img.shape, f"phase cli (e): saved frame {frame.shape}")
    print(f"phase cli (e): detect track (ByteTrack, conf 0.25) of the matching checkpoint on the {n_frames}-frame "
          f"AVI, save=True, "
          f"launches {launches}; {sum(len(t) for _, t in out)} track rows, {n_frames} annotated frames of "
          f"{frame.shape[1]}x{frame.shape[0]}; {n_frames / secs['track']:.2f} frames/s with the writes, "
          f"{secs['track']:.1f} s [{card}]", flush=True)

    runs: list = []
    real_train = YOLO.train

    def watched_train(self, *a, **kw):  # the tuner scores a failed run 0 and goes on: record each run's end
        try:
            r = real_train(self, *a, **kw)
        except Exception as e:
            runs.append(e)
            raise
        runs.append(r)
        return r

    cwd = os.getcwd()
    YOLO.train = watched_train
    tuner = root / "cli_tune"
    tuner.mkdir()
    os.chdir(tuner)  # the tuner writes runs/tune under the working directory
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with call_count(reader, "decode_jpeg") as files:
            tuned = YOLO("yolo11s-fce.yaml", device="cuda").tune(data=data, iterations=CLI_TUNE_ITERATIONS, epochs=1,
                                                                 imgsz=IMGSZ, batch=VAL_BATCH)
        torch.cuda.synchronize()
        secs["tune"] = time.perf_counter() - t0
        launches = read_launches()
    finally:
        YOLO.train = real_train
        os.chdir(cwd)
    paths["cli_tune"] = launches
    failed = [r for r in runs if isinstance(r, Exception)]
    check(len(runs) == CLI_TUNE_ITERATIONS and not failed, f"phase cli (f): tuner runs {runs}")
    csv_rows = (tuner / "runs" / "tune" / "tune_results.csv").read_text().splitlines()
    check(len(csv_rows) == 1 + CLI_TUNE_ITERATIONS and all(
        float(line.split(",")[0]) == round(max(r["best_fitness"], 0.0), 5) for line, r in zip(csv_rows[1:], runs)),
        f"phase cli (f): tune_results.csv {csv_rows} vs the runs' fitness {[r['best_fitness'] for r in runs]}")
    check(launches == no_jpeg(fused_stem=0, pick_suppress=n_val * CLI_TUNE_ITERATIONS,
                              jpeg_fdct=train_plots(n_val) * CLI_TUNE_ITERATIONS)
          | {"jpeg_idct": files.n, "jpeg_color": files.n} and files.n >= 2 * VAL_IMAGES * CLI_TUNE_ITERATIONS,
          f"phase cli (f) tune: launches {launches}, {files.n} JPEG reads")
    check(sorted(Path(p).name for p in tuned["plots"]) == ["tune_fitness.png", "tune_scatter_plots.png"]
          and (tuner / "runs" / "tune" / "best_hyperparameters.yaml").exists(), f"phase cli (f): {tuned['plots']}")
    print(f"phase cli (f): YOLO.tune yolo11s-fce {IMGSZ} B={VAL_BATCH}, {CLI_TUNE_ITERATIONS} iterations of 1 epoch, "
          f"launches {launches}; both runs finished, fitness {[round(r['best_fitness'], 6) for r in runs]}, best "
          f"{tuned['best_fitness']:.6f}; {files.n} JPEG reads (mixup and cutmix donors); {secs['tune']:.1f} s [{card}]",
          flush=True)
    print(f"phase cli: seconds a mode {({k: round(v, 1) for k, v in secs.items()})}; phase cli "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths


DEPLOY_REQUESTS = 16  # (a) phase jpeg's first JPEGs, decoded on the card, one request each over two connections
DEPLOY_BATCH = 16  # (b) the torch_export programs' static batch
DEPLOY_TOL = 1e-4  # (b) a program's preds against the eager f32 model, of max|ref|
NATIVE_IMGSZ = 320  # (c) fy_infer is a CPU interpreter (~5 s a 320 px forward of yolo11s-fce); 320 px keeps the phase short
NATIVE_RTOL, NATIVE_ATOL = 1e-3, 2e-3  # (c) --raw against the card's f32 preds (tests/test_native_infer.py:72)
NATIVE_CONF = 0.8  # (c) image mode: ~20 detections of the calibrated head, well inside the predictor's 1024 candidates
NATIVE_BOX_TOL, NATIVE_SCORE_TOL = 1e-2, 1e-4  # (c) image mode's rows against YOLO.predict's in keep order: px, score


def recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    return buf


def serve_requests(port: int, imgs: list[np.ndarray]) -> tuple[dict, dict]:
    """The images as requests over two connections at once: the even ones
    through ``RemoteModel``, the odd ones over a raw socket (which then
    sends a zero header, on which the server closes). Returns each image's
    rows and the ms of its round trip."""
    import socket
    import threading

    from fce_yolo_tpu_torch.utils.remote import RemoteModel

    rows, ms, errors = {}, {}, []

    def remote(idx):
        try:
            with RemoteModel(f"tcp://127.0.0.1:{port}") as client:
                for i in idx:
                    t0 = time.perf_counter()
                    rows[i] = client(imgs[i])
                    ms[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # raised below, in the main thread
            errors.append(e)

    def raw(idx):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
                for i in idx:
                    h, w = imgs[i].shape[:2]
                    t0 = time.perf_counter()
                    s.sendall(struct.pack("<II", h, w) + imgs[i].tobytes())
                    (n,) = struct.unpack("<I", recv_exact(s, 4))
                    rows[i] = np.frombuffer(recv_exact(s, 24 * n), "<f4").reshape(n, 6)
                    ms[i] = (time.perf_counter() - t0) * 1e3
                s.sendall(struct.pack("<II", 0, 0))
                check(s.recv(1) == b"", "phase deploy (a): the server kept a connection open after h=0")
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=remote, args=(range(0, len(imgs), 2),)),
               threading.Thread(target=raw, args=(range(1, len(imgs), 2),))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors and not any(t.is_alive() for t in threads), f"phase deploy (a): clients failed: {errors}")
    return rows, ms


class capture_nms:
    """Within the block, keep each call of the custom op
    ``fce_yolo_tpu_torch::pick_suppress`` that runs (its candidates, IoU
    threshold, max_det and idx/ok), from a dispatch mode: the op runs as it
    would, so a loaded program's own call is seen."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = []
        op = torch.ops.fce_yolo_tpu_torch.pick_suppress.default

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is op:
                    calls.append(([a.clone() for a in args[:3]], args[3], args[4], [o.clone() for o in out]))
                return out

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def spread_head(yolo, img: np.ndarray) -> None:
    """Class convs whose logits spread on ``img`` (uint8 RGB): each of
    classes 0-2 a whitened random projection of its conv's input over the
    image's anchors (scores ~0.5-0.9), the other classes off (bias -20).
    With seed-0 weights every anchor scores within ~1e-5 of the others, and
    two float paths then keep different boxes; on a noise image without flat
    regions the scores are distinct."""
    head = yolo.model.detect
    feats: list = []
    hooks = [b[-1].register_forward_hook(lambda m, i, o: feats.append(i[0].detach().float())) for b in head.cv3]
    try:
        with torch.inference_mode():
            yolo.model.eval()(torch.from_numpy(img).to(yolo.device).permute(2, 0, 1)[None].float() / 255.0)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for branch, f in zip(head.cv3, feats):
            conv = branch[-1]
            c = f.shape[1]
            mu, sd = f.mean((0, 2, 3)).cpu(), f.std((0, 2, 3)).cpu() + 1e-12
            w = torch.randn(conv.out_channels, c, generator=gen) * 0.5 / c ** 0.5 / sd
            bias = -(w * mu).sum(1)
            w[3:], bias[3:] = 0.0, -20.0
            conv.weight.copy_(w[:, :, None, None])
            conv.bias.copy_(bias)


def phase_deploy(root: Path, card: str) -> dict:
    """Deployment (``serve.py``, ``engine/exporter.py``, ``engine/export_native.py``,
    ``nn/autobackend.py``), each part with the counts at 0:
    (a) ``InferenceServer`` of a bf16 yolo11s-fce (phase val's matching
    weights) on 127.0.0.1, port 0: 16 of phase jpeg's JPEGs decoded on the
    card sent at once over ``RemoteModel`` and a raw socket; each response's
    rows equal to ``YOLO.predict`` on the same array, the stem kernel (at
    B=1) and the NMS kernel once a request;
    (b) ``YOLO.export(format="torch_export")`` of the f32 model at 640 px,
    B=16, without and with NMS, loaded by ``AutoBackend`` on the card: preds
    within 1e-4 of max|ref| of the eager model; with NMS the kernel launched
    once a call from inside the program, through the custom op, its idx/ok
    equal to ``pick_suppress_reference`` on the candidates the program gave
    it; device ms a batch by CUDA events beside the eager model's;
    (c) ``format="native"`` at full width and 320 px, ``fy_infer`` built by
    g++ here: ``--raw`` within rtol 1e-3, atol 2e-3 of the card's f32 preds;
    image mode's rows on a 320x320 noise image equal in count and class to
    ``YOLO.predict(imgsz=320)``'s in keep order, boxes within 0.01 px and
    scores within 1e-4 (the head spread by ``spread_head``);
    (d) ``entrypoint("detect export ... format=torch_export")`` with no
    ``device=``, the artifact read back by ``YOLO(path)`` on the card and
    predicting. (``benchmark``'s export rows ran in phase cli (d).)
    Returns each part's launches, keyed "deploy_<part>"."""
    import os
    import subprocess as sp

    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.cfg import entrypoint
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.nn.autobackend import AutoBackend, fy_infer_binary
    from fce_yolo_tpu_torch.ops.nms import batched_nms, pick_suppress_reference
    from fce_yolo_tpu_torch.serve import InferenceServer

    t_phase = time.perf_counter()
    paths, secs = {}, {}
    out_dir = root / "deploy"
    files = sorted((root / "jpeg" / "images" / "val").iterdir())[:DEPLOY_REQUESTS]
    imgs = [imread(f, device="cuda") for f in files]

    t0 = time.perf_counter()
    served = matching_model(YOLO("yolo11s-fce.yaml", device="cuda")).to(torch.bfloat16)
    srv = InferenceServer(served, host="127.0.0.1", port=0, imgsz=IMGSZ).start()
    try:
        torch.cuda.synchronize()
        reset_launches()
        rows, ms = serve_requests(srv.port, imgs)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        srv.stop()
    secs["serve"] = time.perf_counter() - t0
    paths["deploy_serve"] = launches
    check(launches == no_jpeg(fused_stem=DEPLOY_REQUESTS, pick_suppress=DEPLOY_REQUESTS),
          f"phase deploy (a): launches {launches}, expected the stem and NMS once a request")
    for i, img in enumerate(imgs):
        ref = served.predict(img, imgsz=IMGSZ)[0].boxes.data.astype("<f4")
        check(np.array_equal(rows[i], ref), f"phase deploy (a): request {i}: {len(rows[i])} rows, YOLO.predict "
                                            f"{len(ref)}, max|d| {np.abs(rows[i] - ref).max() if len(ref) == len(rows[i]) and len(ref) else '-'}")
    t = np.array([ms[i] for i in range(len(imgs))])
    print(f"phase deploy (a): InferenceServer bf16 yolo11s-fce {IMGSZ} px, {len(imgs)} requests (phase jpeg's JPEGs, "
          f"{imgs[0].shape[1]}x{imgs[0].shape[0]} and up) at once over RemoteModel and a raw socket, launches "
          f"{launches}; every response's rows equal to YOLO.predict on the same array "
          f"({sum(len(r) for r in rows.values())} rows); ms a request median {np.median(t):.2f}, min {t.min():.2f}, "
          f"max {t.max():.2f}, spread (p90 - p10) {np.percentile(t, 90) - np.percentile(t, 10):.2f}; "
          f"{secs['serve']:.1f} s [{card}]", flush=True)
    del served

    t0 = time.perf_counter()
    f32 = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))
    x = letterboxed(imgs[:DEPLOY_BATCH])
    t1 = time.perf_counter()
    p_raw = f32.export(format="torch_export", imgsz=IMGSZ, batch=DEPLOY_BATCH, out_dir=out_dir / "raw")
    p_nms = f32.export(format="torch_export", imgsz=IMGSZ, batch=DEPLOY_BATCH, nms=True, out_dir=out_dir / "nms")
    secs["export_s"] = (time.perf_counter() - t1) / 2
    b_raw, b_nms = AutoBackend(p_raw, device="cuda"), AutoBackend(p_nms, device="cuda")
    eager = f32._inference_model()

    def eager_preds():
        with torch.inference_mode():
            return eager(x.permute(0, 3, 1, 2).float() / 255.0)["preds"]

    ref = eager_preds()
    got = b_raw(x)
    err = float((got - ref).abs().max() / ref.abs().max())
    check(got.shape == ref.shape and err <= DEPLOY_TOL, f"phase deploy (b): program preds {tuple(got.shape)}, "
                                                         f"max|d|/max|ref| {err:.3e} (limit {DEPLOY_TOL})")
    torch.cuda.synchronize()
    reset_launches()
    with capture_nms() as cap:
        dets = b_nms(x)
    torch.cuda.synchronize()
    launches = read_launches()
    paths["deploy_export"] = launches
    check(launches == no_jpeg(fused_stem=0, pick_suppress=1) and len(cap.calls) == 1,
          f"phase deploy (b): launches {launches}, {len(cap.calls)} custom-op calls; expected the NMS kernel once")
    (cb, cs, cv), iou, max_det, (idx, ok) = cap.calls[0]
    ridx, rok = pick_suppress_reference(cb, cs, cv, iou, max_det)
    check(torch.equal(idx, ridx) and torch.equal(ok, rok),
          f"phase deploy (b): the program's NMS kernel differs from the plain version ({int((idx != ridx).sum())} idx)")
    check(set(dets) == {"boxes", "scores", "classes", "valid"} and tuple(dets["boxes"].shape) == (DEPLOY_BATCH, 300, 4)
          and int(dets["valid"].sum()) > 0, f"phase deploy (b): the NMS program gave {({k: tuple(v.shape) for k, v in dets.items()})}")
    with torch.inference_mode():
        t_eager = cuda_ms(eager_preds)
        t_eager_nms = cuda_ms(lambda: batched_nms(eager_preds(), conf_thres=0.25, iou_thres=0.7, max_det=300))
    t_raw, t_nms = cuda_ms(lambda: b_raw(x)), cuda_ms(lambda: b_nms(x))
    secs["export"] = time.perf_counter() - t0
    print(f"phase deploy (b): YOLO.export torch_export f32 yolo11s-fce {IMGSZ} px B={DEPLOY_BATCH} "
          f"({secs['export_s']:.1f} s an export), loaded by AutoBackend on the card: preds max|d|/max|ref|={err:.3e} "
          f"(limit {DEPLOY_TOL}); with nms=True launches {launches}, the kernel through the custom op, idx/ok equal to "
          f"the plain version on the program's candidates (K={cb.shape[1]}, {int(ok.sum())} kept); device ms a batch "
          f"by CUDA events: program {t_raw:.3f} vs eager {t_eager:.3f}, with NMS {t_nms:.3f} vs eager + batched_nms "
          f"{t_eager_nms:.3f}; {secs['export']:.1f} s [{card}]", flush=True)
    del b_raw, b_nms, got, ref, dets, x

    t0 = time.perf_counter()
    noise = np.random.RandomState(SEED + 7).randint(0, 256, (NATIVE_IMGSZ, NATIVE_IMGSZ, 3), np.uint8)  # RGB
    spread_head(f32, noise)
    t1 = time.perf_counter()
    ir = Path(f32.export(format="native", imgsz=NATIVE_IMGSZ, out_dir=out_dir / "native"))
    secs["native_export"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    exe = fy_infer_binary()
    secs["g++"] = time.perf_counter() - t1
    xr = np.random.RandomState(SEED).rand(1, NATIVE_IMGSZ, NATIVE_IMGSZ, 3).astype(np.float32)
    xr.tofile(out_dir / "in.f32")
    reset_launches()
    t1 = time.perf_counter()
    sp.run([str(exe), str(ir), str(ir.with_suffix(".fybin")), "--raw", str(out_dir / "in.f32"), str(out_dir / "out.f32")],
           check=True, capture_output=True, timeout=300)
    secs["fy_infer_raw"] = time.perf_counter() - t1
    with torch.inference_mode():
        card_preds = f32._inference_model()(torch.from_numpy(xr).cuda().permute(0, 3, 1, 2))["preds"].cpu().numpy()
    raw = np.fromfile(out_dir / "out.f32", np.float32).reshape(card_preds.shape)
    worst = float((np.abs(raw - card_preds) - NATIVE_RTOL * np.abs(card_preds)).max())
    check(np.allclose(raw, card_preds, rtol=NATIVE_RTOL, atol=NATIVE_ATOL),
          f"phase deploy (c): fy_infer --raw vs the card, max(|d| - rtol|ref|) {worst:.3e} (atol {NATIVE_ATOL})")
    ppm = out_dir / "noise.ppm"
    ppm.write_bytes(f"P6\n{NATIVE_IMGSZ} {NATIVE_IMGSZ}\n255\n".encode() + noise.tobytes())
    t1 = time.perf_counter()
    res = sp.run([str(exe), str(ir), str(ir.with_suffix(".fybin")), str(ppm), str(NATIVE_CONF), "0.7"], check=True,
                 capture_output=True, text=True, timeout=300)
    secs["fy_infer_image"] = time.perf_counter() - t1
    cpp = np.array([[float(v) for v in line.split()[:6]] for line in res.stdout.splitlines()], np.float32).reshape(-1, 6)
    py = f32.predict(np.ascontiguousarray(noise[..., ::-1]), imgsz=NATIVE_IMGSZ, conf=NATIVE_CONF, iou=0.7)[0].boxes.data
    torch.cuda.synchronize()
    launches = read_launches()
    paths["deploy_native"] = launches
    check(launches == no_jpeg(fused_stem=0, pick_suppress=1), f"phase deploy (c): launches {launches}")
    check(len(cpp) == len(py) > 0 and np.array_equal(cpp[:, 5], py[:, 5])
          and np.abs(cpp[:, :4] - py[:, :4]).max() <= NATIVE_BOX_TOL
          and np.abs(cpp[:, 4] - py[:, 4]).max() <= NATIVE_SCORE_TOL,
          f"phase deploy (c): fy_infer image mode {len(cpp)} rows vs YOLO.predict {len(py)}:\n{cpp[:5]}\n{py[:5]}")
    secs["native"] = time.perf_counter() - t0
    print(f"phase deploy (c): YOLO.export native yolo11s-fce full width at {NATIVE_IMGSZ} px (fy_infer is a CPU "
          f"interpreter: 320 px keeps the phase short; {ir.stat().st_size} + {ir.with_suffix('.fybin').stat().st_size} "
          f"bytes, {secs['native_export']:.1f} s), fy_infer built by g++ in {secs['g++']:.1f} s: --raw within rtol "
          f"{NATIVE_RTOL}, atol {NATIVE_ATOL} of the card's f32 preds (max(|d| - rtol|ref|) {worst:.2e}), "
          f"{secs['fy_infer_raw']:.2f} s a forward on the host; image mode on a {NATIVE_IMGSZ}x{NATIVE_IMGSZ} noise "
          f"image: {len(cpp)} rows equal in class to YOLO.predict's in keep order, boxes max|d| "
          f"{np.abs(cpp[:, :4] - py[:, :4]).max():.2e} px (limit {NATIVE_BOX_TOL}), scores "
          f"{np.abs(cpp[:, 4] - py[:, 4]).max():.2e} (limit {NATIVE_SCORE_TOL}); {secs['native']:.1f} s [{card}]",
          flush=True)
    del f32, eager

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    cwd = os.getcwd()
    os.chdir(out_dir)  # the command line writes the artifact in the working directory
    try:
        path = str(Path(entrypoint(["detect", "export", "model=yolo11s-fce.yaml", f"imgsz={IMGSZ}",
                                    "format=torch_export"])).resolve())
    finally:
        os.chdir(cwd)
    back = YOLO(path)
    results = back.predict(imgs[0])
    torch.cuda.synchronize()
    launches = read_launches()
    paths["deploy_cli"] = launches
    check(Path(path).suffix == ".pt2" and back.backend.device.type == "cuda" and back.backend.imgsz == IMGSZ
          and len(results) == 1 and np.isfinite(results[0].boxes.data).all(),
          f"phase deploy (d): export wrote {path}, backend on {back.backend.device}")
    check(launches == no_jpeg(fused_stem=0, pick_suppress=1), f"phase deploy (d): launches {launches}")
    secs["cli"] = time.perf_counter() - t0
    print(f"phase deploy (d): detect export model=yolo11s-fce.yaml format=torch_export (no device=) -> {Path(path).name}, "
          f"read back by YOLO(path) on the card and predicting ({len(results[0].boxes)} rows), launches {launches}; "
          f"{secs['cli']:.1f} s [{card}]", flush=True)
    print(f"phase deploy: seconds a part {({k: round(v, 1) for k, v in secs.items()})}; phase deploy "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths


DRAW_FRAMES = 8  # phase draw (b): phase track's first frames, 720x1280 (one predict batch)
DRAW_SIZES = ((37, 53), (480, 640), (720, 1280), (1080, 1920))  # phase draw (a), and a 720x1280 gray image
DRAW_TRAIN_BATCH = 21  # phase draw (c): the 64 images in 3 steps (the train loader drops the rest)


def fdct_bound(h: int, w: int, gray: bool) -> float:
    """ms to read the image once and write its coefficients once at HBM speed."""
    from fce_yolo_tpu_torch.data.jpeg_write import plane_grids

    coef = sum(bh * bw * 64 for bh, bw in plane_grids(h, w, gray))
    return (h * w * (1 if gray else 3) + 2 * coef) / HBM_BYTES_PER_S * 1e3


def fdct_check(card: str) -> dict:
    """(a) ``jpeg_fdct_kernel`` against ``jpeg_fdct_reference`` at DRAW_SIZES
    and on a gray frame: the int16 coefficients equal, and ``encode_jpeg`` on
    the card byte-equal to the plain writer; the kernel timed from a CUDA
    graph beside its bound, the plain version and the host entropy stage
    (``fce_jpeg_entropy``) on the host clock. Returns the record's numbers
    (at 720x1280, the slice's frames) and the others by size."""
    from fce_yolo_tpu_torch.data import jpeg_write as JW

    rng = np.random.RandomState(SEED + 30)
    rec: dict = {}
    cases = [(f"{h}x{w}", jpeg_test_image(rng, h, w)) for h, w in DRAW_SIZES]
    cases.append(("720x1280 gray", jpeg_test_image(rng, 720, 1280)[..., 1].copy()))
    for name, img in cases:
        gray = img.ndim == 2
        d = torch.from_numpy(img).cuda()
        coef = JW.jpeg_fdct(d).cpu().numpy()
        t0 = time.perf_counter()
        ref = JW.jpeg_fdct_reference(img)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(coef.shape == ref.shape and bool((coef == ref).all()),
              f"phase draw (a) {name}: jpeg_fdct differs from jpeg_fdct_reference in {int((coef != ref).sum())} "
              "coefficients")
        buf, plain = JW.encode_jpeg(img, device="cuda"), JW.encode_jpeg_reference(img)
        check(buf == plain, f"phase draw (a) {name}: the card's file differs from the plain writer's")
        ms = graph_ms(lambda: JW.jpeg_fdct(d))
        t0 = time.perf_counter()
        for _ in range(3):
            JW.entropy_encode_host(coef, img.shape[0], img.shape[1], gray)
        entropy_ms = (time.perf_counter() - t0) * 1e3 / 3
        bound = fdct_bound(img.shape[0], img.shape[1], gray)
        print(f"phase draw (a) {name}: jpeg_fdct coefficients equal to the plain version ({coef.size} int16), file "
              f"byte-equal to the plain writer ({len(buf)} bytes); kernel {ms:.4f} ms (CUDA graph; bound {bound:.5f} "
              f"ms, bytes), plain {plain_ms:.1f} ms (numpy), host entropy + markers {entropy_ms:.2f} ms [{card}]",
              flush=True)
        rec[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "entropy_ms": entropy_ms, "bytes": len(buf)}
    main = rec["720x1280"]
    return {"max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "entropy_ms": main["entropy_ms"],
            "by_size": {k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms", "entropy_ms")} for k, v in rec.items()}}


def phase_draw(root: Path, frames: list, card: str) -> tuple[dict, dict]:
    """Outlines, drawing and image writing:
    (a) ``fdct_check``;
    (b) the slice's path: yolo11s-seg (bf16, ``task_matching_model``'s
    weights, so masks exist) ``YOLO.predict`` at B=16 on DRAW_FRAMES of phase
    track's 720x1280 frames, then per result ``Masks.xy``, ``plot()``,
    ``save()``, ``save_txt()`` and ``save_crop()``, the counts at 0: the stem
    and NMS kernels once a batch, ``jpeg_fdct`` once a saved JPEG; every file
    byte-equal to the plain writer's encode of the same array and decoded by
    the port's own decoder on the card;
    (c) ``YOLO.val(plots_dir=...)`` of phase val's float32 model on phase
    jpeg's JPEG copy of the 64 images (its mosaics written and decoded, its
    six figures timed one by one and read back at their pixel size, the NMS
    kernel bit-equal to the plain version on every batch; img/s beside a val
    without plots), and ``YOLO.train`` for 1 epoch of 3 steps with
    ``plots=True`` (``train_batch0..2.jpg`` written and decoded,
    ``results.png`` read back).
    Returns (launches by path, the jpeg_fdct record)."""
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.data.jpeg import decode_jpeg
    from fce_yolo_tpu_torch.data.jpeg_write import encode_jpeg, encode_jpeg_reference
    from fce_yolo_tpu_torch.engine.validator import DetectionValidator
    from fce_yolo_tpu_torch.nn.model import init_weights
    from fce_yolo_tpu_torch.utils import plotting
    from fce_yolo_tpu_torch.utils.annotator import save_one_box
    from fce_yolo_tpu_torch.utils.chart import Figure

    t_phase = time.perf_counter()
    record = fdct_check(card)

    frames = frames[:DRAW_FRAMES]
    yolo = YOLO(TASK_MODELS["segment"], device="cuda")
    init_weights(yolo.model, torch.Generator().manual_seed(SEED), bias_prior=False)
    task_matching_model(yolo, "segment")
    yolo.to(torch.bfloat16).fuse()
    yolo.predict(frames[:E2E_BATCH], imgsz=IMGSZ, batch=E2E_BATCH)  # warm-up
    out_dir = root / "draw"
    (out_dir / "crops").mkdir(parents=True)
    torch.cuda.synchronize()
    reset_launches()
    t_all = time.perf_counter()
    results = yolo.predict(frames, imgsz=IMGSZ, batch=E2E_BATCH)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t_all
    xy_s = plot_s = save_s = 0.0
    saved: list[tuple[Path, np.ndarray]] = []
    n_det = n_pts = 0
    for i, r in enumerate(results):
        t0 = time.perf_counter()
        outlines = r.masks.xy
        t1 = time.perf_counter()
        arr = r.plot()
        t2 = time.perf_counter()
        r.save(str(out_dir / f"frame{i:02d}.jpg"))
        t3 = time.perf_counter()
        r.save_txt(str(out_dir / f"frame{i:02d}.txt"), save_conf=True)
        r.save_crop(str(out_dir / "crops"), file_name=f"frame{i:02d}.jpg")
        xy_s, plot_s, save_s = xy_s + t1 - t0, plot_s + t2 - t1, save_s + t3 - t2
        n_det += len(r)
        n_pts += sum(len(o) for o in outlines)
        check(len(outlines) == len(r) and all(o.ndim == 2 and o.shape[1] == 2 for o in outlines),
              f"phase draw (b) frame {i}: outlines {[o.shape for o in outlines]}")
        saved.append((out_dir / f"frame{i:02d}.jpg", arr))
        for j, row in enumerate(r.boxes.data):
            name = r.names.get(int(row[5]), str(int(row[5])))
            saved.append((out_dir / "crops" / name / f"frame{i:02d}{j}.jpg",
                          save_one_box(row[:4], r.orig_img, square=False, save=False)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = read_launches()
    n = len(frames)
    n_batches = -(-n // E2E_BATCH)
    check(n_det > 0 and n_pts > 0, f"phase draw (b): {n_det} detections and {n_pts} outline points: nothing drawn")
    check(launches == no_jpeg(fused_stem=n_batches, pick_suppress=n_batches, jpeg_fdct=len(saved)),
          f"phase draw (b): launches {launches}, expected the stem and NMS once a batch and jpeg_fdct once for each "
          f"of {len(saved)} files")
    n_bytes = 0
    for path, arr in saved:
        buf = path.read_bytes()
        n_bytes += len(buf)
        check(buf == encode_jpeg_reference(arr), f"phase draw (b): {path.name} differs from the plain writer's")
        check(decode_jpeg(buf, path.name, "cuda").shape == arr.shape, f"phase draw (b): {path.name} decodes wrong")
    plots = [arr for path, arr in saved if path.parent == out_dir]
    t0 = time.perf_counter()
    for arr in plots:  # the encode alone, after the counts: a plot's JPEG through the card
        encode_jpeg(arr, device="cuda")
    encode_ms = (time.perf_counter() - t0) * 1e3 / len(plots)
    per = 1e3 / n
    print(f"phase draw (b): yolo11s-seg {IMGSZ} bf16 B={E2E_BATCH} on {n} frames of 720x1280: {n_det} detections, "
          f"{n_pts} outline points; launches {launches}; {len(saved)} JPEGs ({n} plots, {len(saved) - n} crops, "
          f"{n_bytes} bytes) byte-equal to the plain writer and decoded on the card; ms a frame: predict "
          f"{predict_s * per:.1f}, outlines (Masks.xy) {xy_s * per:.1f}, plot {plot_s * per:.1f}, save (plot "
          f"again, encode, write) {save_s * per:.1f}, of it the JPEG encode {encode_ms:.1f} (timed alone after); "
          f"{n / wall:.2f} frames/s with outlines, plot, save, save_txt and save_crop (host clock) [{card}]",
          flush=True)
    del yolo, results
    torch.cuda.empty_cache()

    data = str(root / "jpeg" / "data.yaml")  # phase jpeg's JPEG copy of phase val's images
    yolo = matching_model(YOLO("yolo11s-fce.yaml", device="cuda"))
    yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    n_val = -(-VAL_IMAGES // VAL_BATCH)
    captured: list[torch.Tensor] = []
    real_nms = DetectionValidator.nms

    def capturing_nms(self, preds):  # keeps each val batch's preds for the check after the run
        captured.append(preds.detach().clone())
        return real_nms(self, preds)

    DetectionValidator.nms = capturing_nms
    try:
        with figure_times(plotting, ("plot_confusion_matrix", "plot_pr_curve", "plot_mc_curve")) as figs:
            reset_launches()
            t0 = time.perf_counter()
            yolo.val(data=data, imgsz=IMGSZ, batch=VAL_BATCH, verbose=False, plots_dir=str(root / "val_plots"))
            torch.cuda.synchronize()
            plots_s = time.perf_counter() - t0
            val_launches = read_launches()
    finally:
        DetectionValidator.nms = real_nms
    check(val_launches == {"fused_stem": 0, "pick_suppress": n_val, "jpeg_fdct": 2, "webp_color": 0,
                           "jpeg_idct": VAL_IMAGES,
                           "jpeg_color": VAL_IMAGES},
          f"phase draw (c) val: launches {val_launches}, expected NMS once a batch (K={NMS_K_VAL}), a decode an "
          "image and two mosaics written")
    val = DetectionValidator(yolo.model, yolo.names, imgsz=IMGSZ, batch_size=VAL_BATCH)  # YOLO.val's NMS settings
    check(len(captured) == n_val, f"phase draw (c): {len(captured)} val batches seen")
    calls: list = []
    for preds in captured:
        nms_kernel_vs_plain(val, preds, calls)
    del captured, val
    side = int(np.ceil(VAL_BATCH ** 0.5)) * IMGSZ
    for f in ("val_batch0_labels.jpg", "val_batch0_pred.jpg"):
        img = decode_jpeg((root / "val_plots" / f).read_bytes(), f, "cuda")
        check(img.shape == (side, side, 3), f"phase draw (c): {f} is {img.shape}")
    sizes = {"confusion_matrix.png": (7, 6), "confusion_matrix_normalized.png": (7, 6), "PR_curve.png": (9, 6),
             "F1_curve.png": (9, 6), "P_curve.png": (9, 6), "R_curve.png": (9, 6)}  # inches, all at dpi 150
    check(sorted(figs.ms) == sorted(sizes), f"phase draw (c): figures drawn {sorted(figs.ms)}")
    for f, inches in sizes.items():
        read_figure(root / "val_plots" / f, Figure(inches).pixel_size(150))
    print(f"phase draw (c) figures: YOLO.val(plots_dir) drew " + ", ".join(f"{f} {ms:.1f} ms" for f, ms in figs.ms.items())
          + f" ({sum(figs.ms.values()):.1f} ms in all, host clock), each read back at its size; NMS kernel idx/ok "
          f"equal to the plain version on all {n_val} batches [{card}]", flush=True)
    train_dir = root / "draw_train"
    reset_launches()
    res = yolo.train(train_data(root / "jpeg"), epochs=1, batch=DRAW_TRAIN_BATCH, imgsz=IMGSZ, val=False,
                     project=str(train_dir), plots=True, verbose=False)
    torch.cuda.synchronize()
    train_launches = read_launches()
    save_dir = Path(res["save_dir"])
    written = sorted(p.name for p in save_dir.glob("train_batch*.jpg"))
    check(written == [f"train_batch{i}.jpg" for i in range(3)] and train_launches["jpeg_fdct"] == 3,
          f"phase draw (c) train: {written}, launches {train_launches}")
    for f in written:
        check(decode_jpeg((save_dir / f).read_bytes(), f, "cuda").ndim == 3, f"phase draw (c): {f} does not decode")
    read_figure(save_dir / "results.png")
    print(f"phase draw (c): YOLO.val(plots_dir) on {VAL_IMAGES} JPEGs, launches {val_launches}: "
          f"{VAL_IMAGES / plots_s:.1f} img/s with plots vs {VAL_IMAGES / plain_s:.1f} without (host clock); "
          f"YOLO.train 1 epoch of 3 steps (B={DRAW_TRAIN_BATCH}) wrote and decoded {', '.join(written)}; "
          f"phase {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del yolo
    torch.cuda.empty_cache()
    return {"draw": launches, "draw_val": val_launches, "draw_train": train_launches}, record


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
    clock = PhaseClock()
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
    clock("build")

    stem = phase_stem(yolo.model, spec, yolo_m.model, spec_m, card)
    clock("stem")
    del yolo_m
    nms = phase_nms(card)
    clock("nms")
    predict, e2e_img_s = phase_e2e(yolo, spec, card)
    clock("e2e")
    del yolo
    with tempfile.TemporaryDirectory() as tmp:
        val_data = write_val_dataset(Path(tmp))
        val, nms_val, val_out = phase_val(val_data, card)
        clock("val")
        phase_loss(val_out, card)
        clock("loss")
        png = val_out["png"]
        del val_out
        jpeg_paths, jpeg, jpeg_d = phase_jpeg(Path(tmp), png, card)
        clock("jpeg")
        formats, webp_color, webp_decode = phase_formats(Path(tmp), png, jpeg_d, card)
        clock("formats")
        train, train_img_s = phase_train(Path(tmp), card)
        clock("train")
        experiments = phase_experiments(Path(tmp), card)
        clock("experiments")
        tasks = phase_tasks(Path(tmp), card)
        clock("tasks")
        task_train = phase_task_train(Path(tmp), card)
        clock("task_train")
        track, stem_b1, frames = phase_track(Path(tmp), card)
        clock("track")
        video, video_times, short_avi = phase_video(Path(tmp), frames, card)
        clock("video")
        draw, fdct = phase_draw(Path(tmp), frames, card)
        clock("draw")
        solutions = phase_solutions(Path(tmp), frames, short_avi, card)
        clock("solutions")
        del frames
        classify = phase_classify(Path(tmp), short_avi, card)
        clock("classify")
        families = phase_families(Path(tmp), val_data, card)
        clock("families")
        v10, tta = phase_v10(Path(tmp), val_data, card)
        clock("v10")
        rtdetr = phase_rtdetr(Path(tmp), val_data, card)
        clock("rtdetr")
        world = phase_world(Path(tmp), val_data, card)
        clock("world")
        weights, zstd_record = phase_weights(Path(tmp), card)
        clock("weights")
        cli = phase_cli(Path(tmp), short_avi, e2e_img_s, train_img_s, card)
        clock("cli")
        deploy = phase_deploy(Path(tmp), card)
        clock("deploy")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paths = {"predict": predict, "val": val, "train": train, "experiments": experiments, **jpeg_paths, **formats,
             **tasks, **task_train, "track": track, **video, **classify, **draw, **solutions, **families, **v10,
             **rtdetr, **world, **weights, **cli, **deploy}

    def launches(name: str) -> dict:
        return {"launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()}}

    kernels = [
        {"name": "fused_stem", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/stem.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_stem.py:309", **launches("fused_stem"), **{k: stem[k] for k in keys},
         **stem_b1},
        {"name": "pick_suppress", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "fce_yolo_tpu/ops/pallas_nms.py:33", **launches("pick_suppress"), **{k: nms[k] for k in keys},
         **nms_val, "video_b1_ms": video_times["nms_ms"], **tta},
    ] + [{"name": name, "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/jpeg.cu",
          "replaces": "fce_yolo_tpu/utils/patches.py:18", **launches(name), **jpeg[name],
          "video_frame_decode_ms": video_times["decode_ms"]}
         for name in ("jpeg_idct", "jpeg_color")] + [
        {"name": "jpeg_fdct", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/jpeg.cu",
         "replaces": "fce_yolo_tpu/utils/patches.py:30", **launches("jpeg_fdct"), **fdct},
        {"name": "fce_zstd_decompress", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/zstd.cu",
         "replaces": "fce_yolo_tpu/utils/checkpoint.py:53", **zstd_record},
        {"name": "webp_color", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/webp.cu",
         "replaces": "fce_yolo_tpu/utils/patches.py:18", **launches("webp_color"), **webp_color},
        {"name": "fce_webp_decode", "route": "cuda", "source": "fce_yolo_tpu_torch/csrc/webp.cu",
         "replaces": "fce_yolo_tpu/utils/patches.py:18", **webp_decode}]
    print(f"phase seconds: {clock.secs}; the whole script {sum(clock.secs.values()):.1f} s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
