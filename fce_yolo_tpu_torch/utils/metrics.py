"""Host-side detection metrics: AP, mAP, the confusion matrix (numpy).

A copy of ``fce_yolo_tpu/utils/metrics.py:35-347`` so the port needs nothing
of the JAX package: 101-point interpolated AP, per-class AP over the ten IoU
thresholds 0.50:0.05:0.95, greedy class-aware matching, and the fitness
0.1 * mAP50 + 0.9 * mAP50-95. The tests hold it equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "box_iou_np",
    "compute_ap",
    "ap_per_class",
    "match_predictions",
    "DetMetrics",
    "ConfusionMatrix",
    "IOU_THRESHOLDS",
]

# 10 IoU thresholds 0.50:0.05:0.95
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU between two xyxy box sets: (M, 4) x (N, 4) -> (M, N)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing over fraction ``f`` of the curve (Ultralytics metrics.py:689)."""
    nf = round(len(y) * f * 2) // 2 + 1  # odd filter width
    pad = np.ones(nf // 2)
    yp = np.concatenate([pad * y[0], y, pad * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (COCO style) from a PR curve.

    Returns (ap, precision_envelope, recall_with_sentinels); semantics match
    Ultralytics metrics.py:785-814.
    """
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))  # precision envelope
    x = np.linspace(0, 1, 101)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    ap = trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    eps: float = 1e-16,
) -> dict:
    """Per-class AP across IoU thresholds + max-F1 operating point.

    Args:
        tp: (D, T) bool — detection d correct at IoU threshold t.
        conf: (D,) detection confidences.
        pred_cls: (D,) predicted class ids.
        target_cls: (G,) ground-truth class ids over the whole eval set.

    Returns dict with p/r/f1 (nc,), ap (nc, T), unique_classes, and the
    1000-point confidence-axis curves. Matches Ultralytics metrics.py:817-908.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    n_thr = tp.shape[1] if tp.ndim == 2 else 1

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, n_thr))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = []
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l, n_p = nt[ci], int(sel.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        # curves are sampled on a descending-confidence axis (hence -x, -conf)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(n_thr):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values.append(np.interp(x, mrec, mpre))

    prec_values = np.array(prec_values) if prec_values else np.zeros((1, 1000))
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()  # max-F1 confidence index
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return {
        "tp": tp_count,
        "fp": fp_count,
        "p": p,
        "r": r,
        "f1": f1,
        "ap": ap,
        "unique_classes": unique_classes.astype(int),
        "p_curve": p_curve,
        "r_curve": r_curve,
        "f1_curve": f1_curve,
        "x": x,
        "prec_values": prec_values,
    }


def match_predictions(
    pred_cls: np.ndarray,
    true_cls: np.ndarray,
    iou: np.ndarray,
    thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """Greedy class-aware matching of detections to GT at each IoU threshold.

    Args:
        pred_cls: (D,) predicted classes. true_cls: (G,) GT classes.
        iou: (G, D) pairwise IoU (GT rows, detection columns).

    Returns (D, T) bool "correct" matrix. Reproduces Ultralytics
    validator.py:266-306: matches sorted by IoU desc, then deduplicated
    per-detection and per-GT (first occurrence wins).
    """
    correct = np.zeros((pred_cls.shape[0], len(thresholds)), dtype=bool)
    iou = np.where(true_cls[:, None] == pred_cls[None, :], iou, 0.0)
    for t, thr in enumerate(thresholds):
        g, d = np.nonzero(iou >= thr)
        if g.size:
            m = np.stack([g, d], 1)
            if m.shape[0] > 1:
                m = m[iou[m[:, 0], m[:, 1]].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1], t] = True
    return correct


@dataclass
class DetMetrics:
    """Accumulates per-image match stats and computes P/R/mAP/fitness.

    Merges the Ultralytics Metric + DetMetrics pair (metrics.py:913-1248)
    into one container; same results_dict keys and fitness weights.
    """

    names: dict = field(default_factory=dict)
    stats: dict = field(
        default_factory=lambda: {"tp": [], "conf": [], "pred_cls": [], "target_cls": [], "target_img": []}
    )
    speed: dict = field(
        default_factory=lambda: {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
    )

    def __post_init__(self):
        self._reset_results()

    def _reset_results(self):
        self.p = np.zeros(0)
        self.r = np.zeros(0)
        self.f1 = np.zeros(0)
        self.all_ap = np.zeros((0, len(IOU_THRESHOLDS)))
        self.ap_class_index = np.zeros(0, int)
        self.nt_per_class = None
        self.nt_per_image = None
        self.curves = None

    def update_stats(self, stat: dict) -> None:
        """Append one image's stats: tp (D,T), conf (D,), pred_cls (D,), target_cls (G,), target_img (unique G classes)."""
        for k in self.stats:
            self.stats[k].append(np.asarray(stat[k]))

    def process(self, nc: int | None = None) -> dict:
        """Concatenate accumulated stats and compute all metrics."""
        nc = nc if nc is not None else (len(self.names) or 1)
        stats = {k: np.concatenate(v, 0) if v else np.zeros(0) for k, v in self.stats.items()}
        self.nt_per_class = np.bincount(stats["target_cls"].astype(int), minlength=nc)
        self.nt_per_image = np.bincount(stats["target_img"].astype(int), minlength=nc)
        if stats["tp"].size:
            res = ap_per_class(stats["tp"], stats["conf"], stats["pred_cls"], stats["target_cls"])
            self.p, self.r, self.f1 = res["p"], res["r"], res["f1"]
            self.all_ap = res["ap"]
            self.ap_class_index = res["unique_classes"]
            # the 1000-point confidence / recall-axis curves the validator's figures draw
            self.curves = {
                "x": res["x"], "p_curve": res["p_curve"], "r_curve": res["r_curve"],
                "f1_curve": res["f1_curve"], "prec_values": res["prec_values"],
            }
        return stats

    # --- scalar summaries (Ultralytics Metric properties) ---
    @property
    def ap50(self):
        return self.all_ap[:, 0] if self.all_ap.size else np.zeros(0)

    @property
    def ap(self):
        return self.all_ap.mean(1) if self.all_ap.size else np.zeros(0)

    @property
    def mp(self) -> float:
        return float(self.p.mean()) if self.p.size else 0.0

    @property
    def mr(self) -> float:
        return float(self.r.mean()) if self.r.size else 0.0

    @property
    def map50(self) -> float:
        return float(self.all_ap[:, 0].mean()) if self.all_ap.size else 0.0

    @property
    def map(self) -> float:
        return float(self.all_ap.mean()) if self.all_ap.size else 0.0

    @property
    def maps(self) -> np.ndarray:
        """Per-class mAP50-95 vector over all nc classes (unseen classes get the mean)."""
        nc = len(self.names) or (int(self.ap_class_index.max()) + 1 if self.ap_class_index.size else 1)
        out = np.full(nc, self.map)
        for i, c in enumerate(self.ap_class_index):
            out[c] = self.ap[i]
        return out

    def mean_results(self) -> list[float]:
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i: int) -> tuple[float, float, float, float]:
        return float(self.p[i]), float(self.r[i]), float(self.ap50[i]), float(self.ap[i])

    @property
    def fitness(self) -> float:
        """0.1*mAP50 + 0.9*mAP50-95 (Ultralytics metrics.py:1029 box weights)."""
        return 0.1 * self.map50 + 0.9 * self.map

    @property
    def keys(self) -> list[str]:
        return [
            "metrics/precision(B)",
            "metrics/recall(B)",
            "metrics/mAP50(B)",
            "metrics/mAP50-95(B)",
        ]

    @property
    def results_dict(self) -> dict[str, float]:
        out = dict(zip(self.keys, self.mean_results()))
        out["fitness"] = self.fitness
        return out


class ConfusionMatrix:
    """(nc+1, nc+1) detection confusion matrix; last row/col = background.

    Matching reproduces Ultralytics metrics.py:443-519: conf filter at 0.25,
    IoU>0.45 greedy unique matching, unmatched GT -> FN column, unmatched
    detections -> FP row.
    """

    def __init__(self, names: dict | list = (), nc: int | None = None):
        self.names = dict(enumerate(names)) if isinstance(names, (list, tuple)) else dict(names)
        self.nc = nc if nc is not None else len(self.names)
        self.matrix = np.zeros((self.nc + 1, self.nc + 1))

    def process_batch(
        self,
        detections: dict[str, np.ndarray],
        batch: dict[str, np.ndarray],
        conf: float = 0.25,
        iou_thres: float = 0.45,
    ) -> None:
        """detections: {'bboxes' (D,4), 'conf' (D,), 'cls' (D,)}; batch: {'bboxes' (G,4), 'cls' (G,)}."""
        conf = 0.25 if conf in {None, 0.001} else conf
        gt_cls = np.asarray(batch["cls"]).astype(int).reshape(-1)
        gt_boxes = np.asarray(batch["bboxes"]).reshape(-1, 4)
        keep = np.asarray(detections["conf"]) > conf
        det_cls = np.asarray(detections["cls"])[keep].astype(int)
        det_boxes = np.asarray(detections["bboxes"])[keep]

        if gt_cls.size == 0:
            for dc in det_cls:
                self.matrix[dc, self.nc] += 1  # FP
            return
        if det_cls.size == 0:
            for gc in gt_cls:
                self.matrix[self.nc, gc] += 1  # FN
            return

        iou = box_iou_np(gt_boxes, det_boxes)
        g, d = np.nonzero(iou > iou_thres)
        if g.size:
            m = np.stack([g, d, iou[g, d]], 1)
            if g.size > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
        else:
            m = np.zeros((0, 3))
        m0, m1 = m[:, 0].astype(int), m[:, 1].astype(int)
        for i, gc in enumerate(gt_cls):
            j = m0 == i
            if m.shape[0] and j.sum() == 1:
                self.matrix[det_cls[m1[j][0]], gc] += 1  # TP (or class-confusion)
            else:
                self.matrix[self.nc, gc] += 1  # FN
        for i, dc in enumerate(det_cls):
            if not (m1 == i).any():
                self.matrix[dc, self.nc] += 1  # FP
