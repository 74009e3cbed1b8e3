"""BoT-SORT tracker: ByteTrack with camera-motion compensation and ReID
(reference ``fce_yolo_tpu/trackers/bot_sort.py``: ``GMC:21``, ``BOTSORT:65``).

``GMC`` estimates the camera's motion between consecutive frames by sparse
optical flow (corners, pyramidal Lucas-Kanade, a RANSAC similarity; the
cv2 calls of the reference are ``trackers/flow.py``) and the tracker warps
every track's Kalman state by it before association. With ``with_reid``,
appearance features of the detection crops (from ``YOLO.embed``, built by
``trackers/track.py``) fuse into the association cost.
"""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.data.augment import resize_linear
from fce_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack, TrackerArgs
from fce_yolo_tpu_torch.trackers.flow import (bgr_to_gray, calc_optical_flow_pyr_lk, estimate_affine_partial_2d,
                                              good_features_to_track)
from fce_yolo_tpu_torch.trackers.matching import embedding_distance, fuse_score, iou_distance

__all__ = ["BOTSORT", "GMC"]


class GMC:
    """Sparse-optical-flow camera-motion estimator: the previous frame's
    corners followed into this frame on gray images downscaled by
    ``downscale``."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prev_gray: np.ndarray | None = None
        self.prev_pts: np.ndarray | None = None

    def apply(self, img: np.ndarray) -> np.ndarray:
        """Return a 2x3 float32 warp mapping previous-frame coords to the
        current frame's: the identity on the first frame, with fewer than 4
        corners or followed points, or when RANSAC finds no model; the
        translation scaled back up by ``downscale``."""
        H = np.eye(2, 3, dtype=np.float32)
        if self.method in ("none", None):
            return H
        gray = bgr_to_gray(img) if img.ndim == 3 else img
        if self.downscale > 1:
            size = (gray.shape[1] // self.downscale, gray.shape[0] // self.downscale)
            gray = resize_linear(gray[..., None], size)[..., 0]  # cv2.resize INTER_LINEAR

        pts = good_features_to_track(gray)  # maxCorners=200, qualityLevel=0.01, minDistance=7, blockSize=7
        if self.prev_gray is not None and self.prev_pts is not None and len(self.prev_pts) >= 4:
            nxt, status = calc_optical_flow_pyr_lk(self.prev_gray, gray, self.prev_pts)
            ok = status.reshape(-1).astype(bool)
            p0, p1 = self.prev_pts[ok], nxt[ok]
            if len(p0) >= 4:
                M, _ = estimate_affine_partial_2d(p0, p1)
                if M is not None:
                    H = M.astype(np.float32)
                    if self.downscale > 1:  # scale translation back up
                        H[0, 2] *= self.downscale
                        H[1, 2] *= self.downscale
        self.prev_gray = gray
        self.prev_pts = pts
        return H

    def reset(self):
        self.prev_gray = None
        self.prev_pts = None


class BOTSORT(BYTETracker):
    def __init__(self, args: TrackerArgs | None = None, frame_rate: int = 30, encoder=None):
        args = args or TrackerArgs(tracker_type="botsort")
        super().__init__(args, frame_rate)
        self.gmc = GMC(method=args.gmc_method)
        # ReID appearance encoder: callable (img, (N, 4) xyxy) -> (N, D) features
        self.encoder = encoder if args.with_reid else None

    def init_track(self, boxes, scores, classes, idxs, img=None):
        tracks = super().init_track(boxes, scores, classes, idxs, img)
        if self.encoder is not None and img is not None and len(tracks):
            feats = self.encoder(img, np.asarray(boxes, float).reshape(-1, 4))
            for t, f in zip(tracks, feats):
                t.update_features(f)
        return tracks

    def get_dists(self, tracks, detections) -> np.ndarray:
        """IoU (score-fused) distance, fused with appearance when ReID is on:
        the embedding distance is gated by spatial proximity and the
        appearance threshold, then the elementwise min of the two costs
        drives the assignment."""
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.args.proximity_thresh)
        if self.args.fuse_score:
            dists = fuse_score(dists, detections)
        if self.encoder is not None:
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > (1 - self.args.appearance_thresh)] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    @staticmethod
    def gmc_apply(tracks: list[STrack], warp: np.ndarray):
        """Warp every track's Kalman mean and covariance by the camera motion."""
        if not len(tracks):
            return
        R = warp[:2, :2]
        t = warp[:2, 2]
        # state is (cx, cy, a, h, vx, vy, va, vh): rotate (cx, cy) and (vx, vy)
        for tr in tracks:
            m = tr.mean.copy()
            m[:2] = R @ m[:2] + t
            m[4:6] = R @ m[4:6]
            tr.mean = m
            C = tr.covariance.copy()
            T = np.eye(8)
            T[:2, :2] = R
            T[4:6, 4:6] = R
            tr.covariance = T @ C @ T.T

    def reset(self):
        super().reset()
        self.gmc.reset()
