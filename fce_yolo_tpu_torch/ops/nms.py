"""Static-shape batched NMS (reference ``fce_yolo_tpu/ops/nms.py:32-229``).

1. Candidate selection: hierarchical top-K over (anchors [x classes]),
   ``_select_candidates``; the sort is stable so ties keep the lower index
   first, which is ``lax.top_k``'s order.
2. Class separation by shifting boxes ``class_id * 7680`` pixels.
3. Greedy suppression, ``pick_suppress``: the custom op
   ``fce_yolo_tpu_torch::pick_suppress``, which dispatches by device to the
   CUDA kernels of ``csrc/nms.cu`` (sort, IoU bitmask, one-warp scan) for
   CUDA tensors and to their plain version ``pick_suppress_reference`` for
   CPU tensors. Same keep-set and emit order as torchvision's greedy NMS.
   Being an op, it stays one node in a ``torch.export`` program.

Rotated boxes (``rotated_batched_nms``, reference nms.py:232-319) take the
same candidates and suppress with a K x K probabilistic IoU in one pass
(Fast-NMS: a suppressed box still suppresses), as torch ops on any device:
the JAX package has no kernel for it either.

Outputs are fixed (B, max_det, ...) tensors with invalid rows zeroed.
"""

from __future__ import annotations

import torch

from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.ops.boxes import xywh2xyxy
from fce_yolo_tpu_torch.ops.iou import probiou

MAX_WH = 7680.0  # class offset (reference utils/nms.py:143-149)
K_MAX = 10240  # the scan's removed-bitset: 32 lanes x 10 words x 32 bits (csrc/nms.cu kMaxK)


def mask_words(k: int) -> int:
    """Words of one row of the kernel's IoU bitmask: ceil(K / 32) rounded up
    to whole 16-byte groups (csrc/nms.cu ``mask_words``)."""
    return 4 * -(-k // 128)


def pick_suppress_reference(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                            iou_thres: float, max_det: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain batched greedy NMS (the JAX ``_pick_suppress``, vectorised over
    the batch like ``pallas_pick_suppress``).

    Args: boxes (B, K, 4) xyxy with class offsets, scores (B, K), valid (B, K).
    Returns idx (B, max_det) int32 and ok (B, max_det) bool, descending score.
    The IoU is computed op by op in the JAX order so that every rounding
    matches: inter / (((a_i + a_j) - inter) + 1e-7).
    """
    b, k, _ = boxes.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    neg_inf = float("-inf")
    live = torch.where(valid, scores.float(), torch.full_like(x1, neg_inf))
    idx = torch.zeros(b, max_det, dtype=torch.int32, device=boxes.device)
    ok = torch.zeros(b, max_det, dtype=torch.bool, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    cols = torch.arange(k, device=boxes.device)
    for t in range(max_det):
        i = live.argmax(dim=1)  # first index of the max, like jnp.argmax
        ok_t = live[rows, i] > neg_inf
        if not bool(ok_t.any()):
            break
        px1, py1, px2, py2, pa = (v[rows, i, None] for v in (x1, y1, x2, y2, area))
        iw = (torch.minimum(px2, x2) - torch.maximum(px1, x1)).clamp(min=0)
        ih = (torch.minimum(py2, y2) - torch.maximum(py1, y1)).clamp(min=0)
        inter = iw * ih
        iou = inter / (pa + area - inter + 1e-7)
        kill = (iou > iou_thres) | (cols[None] == i[:, None])
        live = torch.where(ok_t[:, None] & kill, neg_inf, live)
        idx[:, t] = torch.where(ok_t, i, 0).to(torch.int32)
        ok[:, t] = ok_t
    return idx, ok


def pick_suppress(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  iou_thres: float = 0.45, max_det: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS through the custom op ``fce_yolo_tpu_torch::pick_suppress``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors. Takes
    f32 (B, K, 4) boxes, f32 (B, K) scores and bool (B, K) valid, all on one
    device; raises otherwise."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if scores.shape != (b, k) or valid.shape != (b, k):
        raise ValueError(f"scores/valid must be {(b, k)}, got {tuple(scores.shape)}/{tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("pick_suppress takes float32 boxes and scores and a bool valid mask")
    if not (boxes.device == scores.device == valid.device):
        raise ValueError("boxes, scores and valid must be on one device")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    return torch.ops.fce_yolo_tpu_torch.pick_suppress(boxes, scores, valid, float(iou_thres), int(max_det))


pick_suppress.launches = 0


@torch.library.custom_op("fce_yolo_tpu_torch::pick_suppress", mutates_args=(), device_types="cpu")
def _pick_suppress_op(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                      max_det: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version. A ``torch.export`` program
    holds the op as one node, so a loaded program runs the kernel on the card."""
    return pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)


@_pick_suppress_op.register_kernel("cuda")
def _pick_suppress_cuda(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                        max_det: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CUDA tensors: ``csrc/nms.cu``'s three kernels (sort, IoU
    bitmask, one-warp scan); counts a launch on ``pick_suppress``."""
    b, k, _ = boxes.shape
    if not (boxes.is_contiguous() and scores.is_contiguous() and valid.is_contiguous()):
        raise ValueError("pick_suppress takes contiguous tensors")
    if not (1 <= k <= K_MAX and 1 <= b <= 65535 and max_det >= 1):
        raise ValueError(f"B={b}, K={k}, max_det={max_det} outside the kernel's range "
                         f"(1 <= K <= {K_MAX}, 1 <= B <= 65535)")
    dev = boxes.device
    idx = torch.empty(b, max_det, dtype=torch.int32, device=dev)
    ok = torch.empty(b, max_det, dtype=torch.bool, device=dev)
    # scratch: boxes in score order, their original indices, live counts, the IoU bitmask
    sboxes = torch.empty(b, k, 4, dtype=torch.float32, device=dev)
    order = torch.empty(b, k, dtype=torch.int32, device=dev)
    count = torch.empty(b, dtype=torch.int32, device=dev)
    mask = torch.empty(b, k, mask_words(k), dtype=torch.int32, device=dev)
    lib = kbuild.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (t.data_ptr() for t in (boxes, scores, valid, idx, ok, sboxes, order, count, mask))
        err = lib.fce_pick_suppress(*ptrs, b, k, max_det, float(iou_thres), stream)
    kbuild.check(err, "fce_pick_suppress")
    pick_suppress.launches += 1  # a launch the kernel took
    return idx, ok


@_pick_suppress_op.register_fake
def _pick_suppress_fake(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                        max_det: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shapes for tracing (``torch.export``): int32 and bool (B, max_det)."""
    b = boxes.shape[0]
    return boxes.new_empty((b, max_det), dtype=torch.int32), boxes.new_empty((b, max_det), dtype=torch.bool)


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order (lower index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_candidates(boxes: torch.Tensor, scores: torch.Tensor, pre_nms_topk: int,
                       multi_label: bool):
    """Hierarchical top-K (reference nms.py:75): top anchors by max class
    score, then (multi-label) top pairs among those anchors' class rows.

    boxes (B, N, 4), scores (B, N, nc) -> (cand_boxes (B, K, 4), top_scores,
    cls_idx, anchor_idx), each (B, K).
    """
    b, n, nc = scores.shape
    k = min(pre_nms_topk, n * nc if multi_label else n)
    if multi_label and nc > 1:
        ka = min(pre_nms_topk, n)
        _, pool = _topk(scores.amax(dim=-1), ka)  # (B, Ka)
        pool_scores = torch.gather(scores, 1, pool[..., None].expand(-1, -1, nc))
        top_scores, top_idx = _topk(pool_scores.reshape(b, -1), k)
        anchor_idx = torch.gather(pool, 1, top_idx // nc)
        cls_idx = top_idx % nc
    else:
        best_cls = scores.argmax(dim=-1)
        top_scores, anchor_idx = _topk(scores.amax(dim=-1), k)
        cls_idx = torch.gather(best_cls, 1, anchor_idx)
    cand_boxes = torch.gather(boxes, 1, anchor_idx[..., None].expand(-1, -1, 4))
    return cand_boxes, top_scores, cls_idx, anchor_idx


def batched_nms(
    prediction: torch.Tensor,
    *,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    multi_label: bool = True,
    agnostic: bool = False,
    nc: int | None = None,
) -> dict[str, torch.Tensor]:
    """Batched NMS over decoded head output (reference nms.py:160).

    ``prediction``: (B, N, 4 + nc [+ E]) xywh boxes, class scores and optional
    extra per-anchor channels; pass ``nc`` when extras are present and they
    are gathered per kept detection into ``extra``. Returns ``boxes`` (B,
    max_det, 4), ``scores``, ``classes`` (int32, -1 when empty), ``valid``.
    """
    prediction = prediction.float()
    boxes = xywh2xyxy(prediction[..., :4])
    if nc is None:
        scores, extra = prediction[..., 4:], None
    else:
        scores = prediction[..., 4: 4 + nc]
        extra = prediction[..., 4 + nc:] if prediction.shape[-1] > 4 + nc else None

    cand_boxes, top_scores, cls_idx, anchor_idx = _select_candidates(
        boxes, scores, pre_nms_topk, multi_label)
    valid = top_scores > conf_thres
    offset = torch.zeros_like(top_scores) if agnostic else cls_idx.float() * MAX_WH
    shifted = (cand_boxes + offset[..., None]).contiguous()
    idx, kept = pick_suppress(shifted, top_scores.contiguous(), valid.contiguous(),
                              iou_thres=iou_thres, max_det=max_det)
    idx = idx.long()

    def take(a: torch.Tensor) -> torch.Tensor:
        return torch.gather(a, 1, idx)

    out = {
        "boxes": torch.where(kept[..., None], torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4)), 0.0),
        "scores": torch.where(kept, take(top_scores), 0.0),
        "classes": torch.where(kept, take(cls_idx), -1).to(torch.int32),
        "valid": kept,
    }
    if extra is not None:
        kept_anchor = take(anchor_idx)
        e = extra.shape[-1]
        out["extra"] = torch.where(
            kept[..., None], torch.gather(extra, 1, kept_anchor[..., None].expand(-1, -1, e)), 0.0)
    return out


def _fast_nms_rotated(obb: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                      max_det: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fast-NMS over score-sorted rotated candidates (reference nms.py:232-265):
    candidate j survives iff no earlier valid candidate has probiou >= the
    threshold with it.

    Args: obb (B, K, 5) xywhr with class offsets on cx/cy, scores (B, K)
    descending, valid (B, K). Returns idx (B, max_det) int64 and kept (B,
    max_det) bool, in descending score.
    """
    b, k = scores.shape
    iou = probiou(obb[:, :, None, :], obb[:, None, :, :])  # (B, K, K)
    order = torch.arange(k, device=obb.device)
    higher = (order[:, None] < order[None, :])[None] & valid[:, :, None]
    keep = valid & ~((iou >= iou_thres) & higher).any(dim=1)
    kept_scores = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, idx = _topk(kept_scores, min(max_det, k))
    if top.shape[1] < max_det:  # fewer candidates than max_det
        pad = max_det - top.shape[1]
        idx = torch.nn.functional.pad(idx, (0, pad))
        top = torch.nn.functional.pad(top, (0, pad), value=float("-inf"))
    return idx, top > float("-inf")


def rotated_batched_nms(
    prediction: torch.Tensor,
    *,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    multi_label: bool = True,
    agnostic: bool = False,
    nc: int,
) -> dict[str, torch.Tensor]:
    """Rotated-box NMS with probiou suppression (reference nms.py:268-319).

    ``prediction``: (B, N, 4 + nc + E) rotated xywh, class scores and extras
    whose first channel is the angle. Returns ``boxes`` (B, max_det, 4) as
    (cx, cy, w, h), ``scores``, ``classes``, ``valid`` and ``extra`` (the
    angle and any further channels of each kept detection).
    """
    prediction = prediction.float()
    boxes, scores, extra = prediction[..., :4], prediction[..., 4: 4 + nc], prediction[..., 4 + nc:]
    cand_boxes, top_scores, cls_idx, anchor_idx = _select_candidates(boxes, scores, pre_nms_topk, multi_label)
    cand_angle = torch.gather(extra[..., 0], 1, anchor_idx)
    valid = top_scores > conf_thres
    off = torch.zeros_like(top_scores) if agnostic else cls_idx.float() * MAX_WH
    obb = torch.cat([cand_boxes[..., :2] + off[..., None], cand_boxes[..., 2:4], cand_angle[..., None]], dim=-1)
    idx, kept = _fast_nms_rotated(obb, top_scores, valid, iou_thres, max_det)
    e = extra.shape[-1]
    kept_anchor = torch.gather(anchor_idx, 1, idx)
    return {
        "boxes": torch.where(kept[..., None], torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4)), 0.0),
        "scores": torch.where(kept, torch.gather(top_scores, 1, idx), 0.0),
        "classes": torch.where(kept, torch.gather(cls_idx, 1, idx), -1).to(torch.int32),
        "valid": kept,
        "extra": torch.where(kept[..., None], torch.gather(extra, 1, kept_anchor[..., None].expand(-1, -1, e)), 0.0),
    }
