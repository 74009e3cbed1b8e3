"""Association costs and assignment for tracking (reference
``fce_yolo_tpu/trackers/matching.py:12-72``), numpy and scipy on the host."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from fce_yolo_tpu_torch.utils.metrics import box_iou_np

__all__ = ["iou_distance", "fuse_score", "linear_assignment", "embedding_distance"]


def iou_distance(atracks: list, btracks: list) -> np.ndarray:
    """1 - IoU cost between two track/detection lists (their ``.xyxy``)."""
    a = np.array([t.xyxy for t in atracks]).reshape(-1, 4)
    b = np.array([t.xyxy for t in btracks]).reshape(-1, 4)
    if not len(a) or not len(b):
        return np.ones((len(a), len(b)), np.float32)
    return 1.0 - box_iou_np(a, b).astype(np.float32)


def fuse_score(cost_matrix: np.ndarray, detections: list) -> np.ndarray:
    """Fuse the detections' confidence into the IoU similarity."""
    if cost_matrix.size == 0:
        return cost_matrix
    det_scores = np.array([d.score for d in detections])
    return 1.0 - (1.0 - cost_matrix) * det_scores[None, :]


def linear_assignment(cost_matrix: np.ndarray, thresh: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian assignment with cost gating: costs above ``thresh`` become
    ``thresh + 1e-4`` for scipy's ``linear_sum_assignment``, and only pairs
    at or under ``thresh`` are kept. Returns (matches (K, 2), unmatched
    rows, unmatched columns)."""
    if cost_matrix.size == 0:
        return (np.zeros((0, 2), int), np.arange(cost_matrix.shape[0]), np.arange(cost_matrix.shape[1]))
    gated = np.where(cost_matrix > thresh, thresh + 1e-4, cost_matrix)
    rows, cols = linear_sum_assignment(gated)
    ok = cost_matrix[rows, cols] <= thresh
    matches = np.stack([rows[ok], cols[ok]], 1) if ok.any() else np.zeros((0, 2), int)
    unmatched_a = np.setdiff1d(np.arange(cost_matrix.shape[0]), matches[:, 0])
    unmatched_b = np.setdiff1d(np.arange(cost_matrix.shape[1]), matches[:, 1])
    return matches, unmatched_a, unmatched_b


def embedding_distance(tracks: list, detections: list) -> np.ndarray:
    """Cosine distance, at least 0, between the tracks' smoothed features and
    the detections' features; a pair missing a feature gets 1. The dot
    products are taken in float64 at once (the reference takes each pair's
    float32 dot in a loop)."""
    m = np.ones((len(tracks), len(detections)), np.float32)
    rows = [i for i, t in enumerate(tracks) if getattr(t, "smooth_feat", None) is not None]
    cols = [j for j, d in enumerate(detections) if getattr(d, "curr_feat", None) is not None]
    if rows and cols:
        tf = np.stack([tracks[i].smooth_feat for i in rows]).astype(np.float64)
        df = np.stack([detections[j].curr_feat for j in cols]).astype(np.float64)
        dots = (tf @ df.T).astype(np.float32).astype(np.float64)
        m[np.ix_(rows, cols)] = np.maximum(0.0, 1.0 - dots)
    return m
