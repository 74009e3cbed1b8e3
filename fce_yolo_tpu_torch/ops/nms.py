"""Static-shape batched NMS (reference ``fce_yolo_tpu/ops/nms.py:32-229``).

1. Candidate selection: hierarchical top-K over (anchors [x classes]),
   ``_select_candidates``; the sort is stable so ties keep the lower index
   first, which is ``lax.top_k``'s order.
2. Class separation by shifting boxes ``class_id * 7680`` pixels.
3. Greedy suppression, ``pick_suppress``: the CUDA kernel ``csrc/nms.cu``
   for CUDA tensors, its plain version ``pick_suppress_reference`` for CPU
   tensors. Same keep-set and emit order as torchvision's greedy NMS.

Outputs are fixed (B, max_det, ...) tensors with invalid rows zeroed.
"""

from __future__ import annotations

import torch

from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.ops.boxes import xywh2xyxy

MAX_WH = 7680.0  # class offset (reference utils/nms.py:143-149)
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use


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
    """Batched greedy NMS: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Takes f32 (B, K, 4) boxes, f32 (B, K) scores
    and bool (B, K) valid, all contiguous on one device; raises otherwise."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if scores.shape != (b, k) or valid.shape != (b, k):
        raise ValueError(f"scores/valid must be {(b, k)}, got {tuple(scores.shape)}/{tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("pick_suppress takes float32 boxes and scores and a bool valid mask")
    if not (boxes.device == scores.device == valid.device):
        raise ValueError("boxes, scores and valid must be on one device")
    if boxes.device.type == "cpu":
        return pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous() and valid.is_contiguous()):
        raise ValueError("pick_suppress takes contiguous tensors")
    if k < 1 or max_det < 1 or 6 * k * 4 > _SMEM_LIMIT:
        raise ValueError(f"K={k}, max_det={max_det} outside the kernel's range (1 <= K <= 9685)")
    idx = torch.empty(b, max_det, dtype=torch.int32, device=boxes.device)
    ok = torch.empty(b, max_det, dtype=torch.bool, device=boxes.device)
    lib = kbuild.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fce_pick_suppress(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                                    idx.data_ptr(), ok.data_ptr(), b, k, max_det,
                                    float(iou_thres), stream)
    kbuild.check(err, "fce_pick_suppress")
    pick_suppress.launches += 1  # a launch the kernel took
    return idx, ok


pick_suppress.launches = 0


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
