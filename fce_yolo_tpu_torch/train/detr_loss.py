"""RT-DETR training loss (reference ``fce_yolo_tpu/train/detr_loss.py``):
Hungarian matching, then VFL, L1 and GIoU per layer, the encoder layer as
aux layer 0, the last decoder layer as the main loss, and the fixed-match
loss of the contrastive-denoising queries.

Ground truths come padded to M with a validity mask (the padded-batch
contract of ``train/loss.py``). The matching is SciPy's
``linear_sum_assignment`` on the host, one image at a time over its valid
ground truths: where costs do not tie it gives the assignment of the JAX
package's ``optax.assignment.hungarian_algorithm``, whose padded columns
cost a constant 1e6 and so leave the valid ones as they are. The costs of
every layer of a step go to the host in one copy (``match_layers``): one
wait for the device a step, before the backward. A padded slot is given a query that no valid
slot holds, so the scatters of the class targets never meet twice at one
query, as the JAX assignment's distinct rows never do.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from fce_yolo_tpu_torch.ops.iou import bbox_iou
from fce_yolo_tpu_torch.train.loss import LossState, bce_with_logits

__all__ = ["DETRLossCfg", "detr_loss", "hungarian_match", "make_cdn_group", "match_layers"]

_PAD_COST = 1e6


def make_cdn_group(gt_cls, gt_bboxes, mask_gt, nc: int, nq: int, num_dn: int = 100, cls_noise_ratio: float = 0.5,
                   box_noise_scale: float = 1.0, rng=None) -> dict:
    """Host-side contrastive-denoising group in the static-shape form of
    the reference (``make_cdn_group``, detr_loss.py:34-104; Ultralytics
    get_cdn_group, ops.py:188-315), numpy on ``np.random.default_rng(rng)``
    drawn in the same order, so one seed gives the same arrays.

    The dn slots are strided by the padded M: blocks [0, G) of width M are
    positive copies, [G, 2G) negative ones, so the dn match is the identity
    over the first G*M slots; padded slots have ``dn_cls`` -1 and box 0.

    Returns numpy ``dn_cls`` (B, 2GM) int32, ``dn_bbox`` (B, 2GM, 4) float32
    inverse-sigmoid boxes, ``dn_attn_mask`` (2GM + nq, 2GM + nq) bool (True
    = blocked) and ``num_group``.
    """
    b, m = gt_cls.shape
    g = max(1, num_dn // max(m, 1))
    nd = 2 * g * m
    r = np.random.default_rng(rng)

    dn_cls = np.tile(np.asarray(gt_cls, np.int64), (1, 2 * g))
    dn_bbox = np.tile(np.asarray(gt_bboxes, np.float32), (1, 2 * g, 1))
    valid = np.tile(np.asarray(mask_gt, bool), (1, 2 * g))

    if cls_noise_ratio > 0:  # a random class for a share of half the ratio
        flip = r.random(dn_cls.shape) < (cls_noise_ratio * 0.5)
        dn_cls = np.where(flip, r.integers(0, nc, dn_cls.shape), dn_cls)

    if box_noise_scale > 0:
        xy, wh = dn_bbox[..., :2], dn_bbox[..., 2:]
        known = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
        diff = np.tile(wh * 0.5, (1, 1, 2)) * box_noise_scale
        sign = r.integers(0, 2, dn_bbox.shape) * 2.0 - 1.0
        part = r.random(dn_bbox.shape)
        part[:, g * m:] += 1.0  # negative copies: shifted by [1, 2) half-extents
        known = np.clip(known + sign * part * diff, 0.0, 1.0)
        c_xy, c_wh = (known[..., :2] + known[..., 2:]) / 2, known[..., 2:] - known[..., :2]
        dn_bbox = np.concatenate([c_xy, c_wh], -1)
        eps = 1e-6
        p = np.clip(dn_bbox, eps, 1 - eps)
        dn_bbox = np.log(p / (1 - p))

    dn_cls = np.where(valid, dn_cls, -1).astype(np.int32)
    dn_bbox = np.where(valid[..., None], dn_bbox, 0.0).astype(np.float32)

    # the matching queries do not see the dn queries; each dn group sees itself and the matching queries
    tgt = nd + nq
    amask = np.zeros((tgt, tgt), bool)
    amask[nd:, :nd] = True
    for i in range(g):
        s, e = 2 * m * i, 2 * m * (i + 1)
        amask[s:e, e:nd] = True
        amask[s:e, :s] = True
    return {"dn_cls": dn_cls, "dn_bbox": dn_bbox, "dn_attn_mask": amask, "num_group": g}


class DETRLossCfg(NamedTuple):
    nc: int = 80
    gain_class: float = 1.0
    gain_bbox: float = 5.0
    gain_giou: float = 2.0
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    gamma: float = 1.5  # focal focusing (DETRLoss FocalLoss default)
    alpha: float = 0.25  # focal balance
    matcher_gamma: float = 2.0  # reference HungarianMatcher gamma (ops.py:54)
    aux_loss: bool = True


def match_cost(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_cls: torch.Tensor, mask_gt: torch.Tensor, cfg: DETRLossCfg) -> torch.Tensor:
    """The matching cost (B, nq, M) of the reference's HungarianMatcher
    (focal class cost, L1, 1 - GIoU), padded columns 1e6, non-finite values
    replaced as ``jnp.nan_to_num`` does (detr_loss.py:129-143)."""
    scores = pred_scores.float().sigmoid()
    idx = gt_cls.long().clamp(0, cfg.nc - 1)[:, None, :].expand(-1, scores.shape[1], -1)
    ps = torch.gather(scores, 2, idx)  # (B, nq, M)
    neg = (1 - cfg.alpha) * ps ** cfg.matcher_gamma * (-torch.log(1 - ps + 1e-8))
    pos = cfg.alpha * (1 - ps) ** cfg.matcher_gamma * (-torch.log(ps + 1e-8))
    cost_bbox = (pred_bboxes[:, :, None, :] - gt_bboxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(pred_bboxes[:, :, None, :], gt_bboxes[:, None, :, :], xywh=True, mode="GIoU")
    cost = cfg.cost_class * (pos - neg) + cfg.cost_bbox * cost_bbox + cfg.cost_giou * (1.0 - giou)
    cost = torch.where(mask_gt[:, None, :], cost, torch.full_like(cost, _PAD_COST))
    return torch.nan_to_num(cost, nan=_PAD_COST, posinf=_PAD_COST, neginf=-_PAD_COST)


def _assign(cost: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(nq, M) cost of one image -> (M,) query per gt slot: the optimal
    assignment of the valid slots, then the unused queries in order for the
    padded ones."""
    from scipy.optimize import linear_sum_assignment

    m = cost.shape[1]
    out = np.zeros(m, np.int64)
    cols = np.flatnonzero(mask)
    used = np.zeros(cost.shape[0], bool)
    if len(cols):
        rows, c = linear_sum_assignment(cost[:, cols])
        out[cols[c]] = rows
        used[rows] = True
    pad, free = np.flatnonzero(~mask), np.flatnonzero(~used)
    out[pad[: len(free)]] = free[: len(pad)]
    return out


def match_layers(layers: list[tuple[torch.Tensor, torch.Tensor]], gt_bboxes: torch.Tensor, gt_cls: torch.Tensor,
                 mask_gt: torch.Tensor, cfg: DETRLossCfg) -> tuple[list[torch.Tensor], float, float]:
    """``hungarian_match`` of several (pred_bboxes, pred_scores) layers with
    one copy of all their costs to the host. Returns the (B, M) int64 match
    of each layer on the device, the seconds the host waited for the copy
    (the device's work queued before it included) and the seconds of the
    assignments."""
    with torch.no_grad():
        costs = torch.stack([match_cost(bx.detach().float(), sc.detach(), gt_bboxes, gt_cls, mask_gt, cfg)
                             for bx, sc in layers])
        costs = torch.cat([costs.flatten(), mask_gt.flatten().float()])
    t0 = time.perf_counter()
    flat = costs.cpu().numpy()
    t1 = time.perf_counter()
    n = flat.size - mask_gt.numel()
    costs_np = flat[:n].reshape(len(layers), *mask_gt.shape[:1], -1, mask_gt.shape[1])
    mask_np = flat[n:].reshape(mask_gt.shape) > 0
    matches = np.stack([[_assign(c_img, m_img) for c_img, m_img in zip(c_layer, mask_np)] for c_layer in costs_np])
    t2 = time.perf_counter()
    out = torch.from_numpy(matches).to(gt_cls.device)
    return list(out), t1 - t0, t2 - t1


def hungarian_match(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_bboxes: torch.Tensor,
                    gt_cls: torch.Tensor, mask_gt: torch.Tensor, cfg: DETRLossCfg) -> torch.Tensor:
    """Optimal bipartite assignment (reference ``hungarian_match``,
    detr_loss.py:121-151): (B, M) int64, the query of each gt slot; a
    padded slot gets a query no valid slot holds."""
    return match_layers([(pred_bboxes, pred_scores)], gt_bboxes, gt_cls, mask_gt, cfg)[0][0]


def _layer_loss(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_bboxes: torch.Tensor, gt_cls: torch.Tensor,
                mask_gt: torch.Tensor, cfg: DETRLossCfg, match_q: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(class, bbox, giou) losses of one prediction layer under the match
    ``match_q`` (reference ``_layer_loss``, detr_loss.py:154-204)."""
    b, nq, nc = pred_scores.shape
    ab = torch.arange(b, device=pred_scores.device)[:, None]
    num_gts = mask_gt.sum().clamp(min=1).to(pred_bboxes.dtype)
    pb = pred_bboxes[ab, match_q]  # (B, M, 4)
    zero = torch.zeros((), dtype=pred_bboxes.dtype, device=pred_bboxes.device)

    l1 = torch.where(mask_gt, (pb - gt_bboxes).abs().sum(-1), zero).sum() / num_gts
    giou = bbox_iou(pb, gt_bboxes, xywh=True, mode="GIoU")
    l_giou = torch.where(mask_gt, 1.0 - giou, zero).sum() / num_gts

    with torch.no_grad():
        iou_w = torch.where(mask_gt, bbox_iou(pb, gt_bboxes, xywh=True).clamp(0, 1), zero)
    targets = torch.full((b, nq), nc, dtype=torch.long, device=pred_scores.device)
    targets[ab, match_q] = torch.where(mask_gt, gt_cls.long(), torch.full_like(gt_cls.long(), nc))
    gt_score_q = torch.zeros((b, nq), dtype=pred_scores.dtype, device=pred_scores.device)
    gt_score_q[ab, match_q] = iou_w.to(pred_scores.dtype)
    one_hot = torch.nn.functional.one_hot(targets, nc + 1).to(pred_scores.dtype)[..., :-1]
    gt_sc = gt_score_q[..., None] * one_hot
    p = pred_scores.sigmoid()
    w_vfl = cfg.alpha * p ** cfg.gamma * (1 - one_hot) + gt_sc * one_hot
    vfl = (bce_with_logits(pred_scores, gt_sc) * w_vfl).mean(dim=1).sum()
    p_t = one_hot * p + (1 - one_hot) * (1 - p)
    w_fl = (1 - p_t) ** cfg.gamma * (one_hot * cfg.alpha + (1 - one_hot) * (1 - cfg.alpha))
    fl = (bce_with_logits(pred_scores, one_hot) * w_fl).mean(dim=1).sum()
    l_cls = torch.where(mask_gt.sum() > 0, vfl, fl) / (num_gts / nq)
    return cfg.gain_class * l_cls, cfg.gain_bbox * l1, cfg.gain_giou * l_giou


def detr_loss(out: dict, batch: dict[str, torch.Tensor], cfg: DETRLossCfg, state: LossState
              ) -> tuple[torch.Tensor, dict, LossState]:
    """The whole RT-DETR loss (reference ``detr_loss``, detr_loss.py:207-276):
    the encoder layer and every decoder layer, each matched on its own, the
    last decoder layer the main loss and the others ``aux``; with "dn_cls"
    in ``batch`` the prepended dn queries are split off every decoder layer
    and charged the identity-match loss (``dn``).

    ``out``: the head's training dict; ``batch``: "cls", "bboxes"
    (normalized xywh), "mask" and the dn arrays. ``parts``: "cls", "box",
    "giou", "aux", "dn", "fg_count", and as floats "match_wait_s" (the
    host's wait for the costs: the step's one sync) and "match_host_s" (the
    assignments on the host)."""
    gt_b = batch["bboxes"].float()
    gt_c = batch["cls"].long()
    mask = batch["mask"].bool() & (batch["bboxes"][..., 2:].prod(-1) > 0)

    dec_bboxes, dec_scores = out["dec_bboxes"], out["dec_scores"]
    zero = torch.zeros((), dtype=torch.float32, device=gt_b.device)
    dn_loss = zero
    if "dn_cls" in batch:
        nd = batch["dn_cls"].shape[1]
        dn_bboxes, dec_bboxes = dec_bboxes[:, :, :nd], dec_bboxes[:, :, nd:]
        dn_scores, dec_scores = dec_scores[:, :, :nd], dec_scores[:, :, nd:]
        m = gt_c.shape[1]
        g = nd // (2 * m)
        gt_b_dn, gt_c_dn, mask_dn = gt_b.repeat(1, g, 1), gt_c.repeat(1, g), mask.repeat(1, g)
        match_dn = torch.arange(g * m, device=gt_b.device)[None].expand(gt_c.shape[0], -1)
        for li in range(dn_bboxes.shape[0]):
            c, bx, gi = _layer_loss(dn_bboxes[li], dn_scores[li], gt_b_dn, gt_c_dn, mask_dn, cfg, match_dn)
            dn_loss = dn_loss + c + bx + gi

    all_bboxes = torch.cat([out["enc_bboxes"][None], dec_bboxes], dim=0)
    all_scores = torch.cat([out["enc_scores"][None], dec_scores], dim=0)
    n = all_bboxes.shape[0]
    layers = list(range(n)) if cfg.aux_loss else [n - 1]
    matches, wait_s, host_s = match_layers([(all_bboxes[li], all_scores[li]) for li in layers], gt_b, gt_c, mask,
                                           cfg)
    match = dict(zip(layers, matches))

    l_cls, l_box, l_giou = _layer_loss(all_bboxes[-1], all_scores[-1], gt_b, gt_c, mask, cfg, match[n - 1])
    aux_cls = aux_box = aux_giou = zero
    if cfg.aux_loss:
        for li in range(n - 1):
            c, bx, gi = _layer_loss(all_bboxes[li], all_scores[li], gt_b, gt_c, mask, cfg, match[li])
            aux_cls, aux_box, aux_giou = aux_cls + c, aux_box + bx, aux_giou + gi
    aux = aux_cls + aux_box + aux_giou
    parts = {"cls": l_cls, "box": l_box, "giou": l_giou, "aux": aux, "dn": dn_loss,
             "fg_count": mask.sum().float(), "match_wait_s": wait_s, "match_host_s": host_s}
    return l_cls + l_box + l_giou + aux + dn_loss, parts, state
