"""ByteTrack multi-object tracker (reference
``fce_yolo_tpu/trackers/byte_tracker.py``: ``TrackerArgs:22``,
``TrackState:39``, ``STrack:43``, ``BYTETracker:177``), numpy on the host.

Two-stage association: high-confidence detections match tracked and lost
tracks by (score-fused) IoU; low-confidence detections then rescue
still-unmatched tracked ones; unconfirmed tracks get one strict chance;
leftovers start new tracks if above ``new_track_thresh``. Lost tracks
persist for ``track_buffer`` frames. Track ids come from ``STrack``'s
class-level counter, which a new tracker and ``reset`` set back to 0, as in
the reference; the order of every step below is the reference's, since
the ids depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fce_yolo_tpu_torch.trackers.kalman import KalmanFilterXYAH
from fce_yolo_tpu_torch.trackers.matching import fuse_score, iou_distance, linear_assignment

__all__ = ["STrack", "BYTETracker", "TrackerArgs"]


@dataclass
class TrackerArgs:
    """Tracker hyperparameters (defaults = reference cfg/trackers/bytetrack.yaml)."""

    tracker_type: str = "bytetrack"
    track_high_thresh: float = 0.25
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.25
    track_buffer: int = 30
    match_thresh: float = 0.8
    fuse_score: bool = True
    # BoT-SORT extras
    gmc_method: str = "sparseOptFlow"
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.8
    with_reid: bool = False


class TrackState:
    New, Tracked, Lost, Removed = 0, 1, 2, 3


class STrack:
    """One tracked object: KF state + bookkeeping (reference STrack)."""

    _count = 0
    shared_kalman = KalmanFilterXYAH()

    def __init__(self, xyxy: np.ndarray, score: float, cls: int, det_idx: int = -1,
                 feat: np.ndarray | None = None):
        self._init_xyah = self.xyxy_to_xyah(np.asarray(xyxy, float))
        self.mean: np.ndarray | None = None
        self.covariance: np.ndarray | None = None
        self.kalman_filter: KalmanFilterXYAH | None = None
        self.score = float(score)
        self.cls = int(cls)
        self.det_idx = det_idx
        self.track_id = 0
        self.state = TrackState.New
        self.is_activated = False
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0
        # ReID appearance state (reference BOTrack: curr/smooth feat, EMA 0.9)
        self.curr_feat: np.ndarray | None = None
        self.smooth_feat: np.ndarray | None = None
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat: np.ndarray, alpha: float = 0.9):
        """L2-normalize + exponential moving average (reference
        BOTrack.update_features, bot_sort.py:66)."""
        feat = np.asarray(feat, np.float32)
        feat = feat / max(float(np.linalg.norm(feat)), 1e-12)
        self.curr_feat = feat
        self.smooth_feat = (
            feat if self.smooth_feat is None else alpha * self.smooth_feat + (1 - alpha) * feat
        )
        self.smooth_feat /= max(float(np.linalg.norm(self.smooth_feat)), 1e-12)

    # --- geometry ---
    @staticmethod
    def xyxy_to_xyah(b: np.ndarray) -> np.ndarray:
        w, h = b[2] - b[0], b[3] - b[1]
        return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, w / max(h, 1e-6), h])

    @property
    def xyxy(self) -> np.ndarray:
        if self.mean is None:
            x = self._init_xyah
        else:
            x = self.mean[:4]
        cx, cy, a, h = x
        w = a * h
        return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])

    # --- lifecycle ---
    @classmethod
    def next_id(cls) -> int:
        cls._count += 1
        return cls._count

    @classmethod
    def reset_id(cls):
        cls._count = 0

    def activate(self, kalman_filter: KalmanFilterXYAH, frame_id: int):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self._init_xyah)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, new_track._init_xyah
        )
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.det_idx = new_track.det_idx

    def update(self, new_track: "STrack", frame_id: int):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, new_track._init_xyah
        )
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.det_idx = new_track.det_idx

    def predict(self):
        mean = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean[7] = 0  # zero height velocity while lost
        self.mean, self.covariance = self.kalman_filter.predict(mean, self.covariance)

    @staticmethod
    def multi_predict(tracks: list["STrack"]):
        if not tracks:
            return
        means = np.stack([t.mean.copy() for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i, 7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for t, m, c in zip(tracks, means, covs):
            t.mean, t.covariance = m, c

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self) -> int:
        return self.frame_id


class BYTETracker:
    """Frame-by-frame tracker; update() takes one image's final detections."""

    def __init__(self, args: TrackerArgs | None = None, frame_rate: int = 30):
        self.args = args or TrackerArgs()
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.max_time_lost = int(frame_rate / 30.0 * self.args.track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self) -> KalmanFilterXYAH:
        return KalmanFilterXYAH()

    def init_track(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray, idxs: np.ndarray, img=None) -> list[STrack]:
        return [STrack(b, s, c, i) for b, s, c, i in zip(boxes, scores, classes, idxs)]

    def get_dists(self, tracks: list[STrack], detections: list[STrack]) -> np.ndarray:
        dists = iou_distance(tracks, detections)
        if self.args.fuse_score:
            dists = fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks: list[STrack]):
        STrack.multi_predict(tracks)

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray, img: np.ndarray | None = None) -> np.ndarray:
        """Process one frame.

        Args:
            boxes: (N, 4) xyxy. scores: (N,). classes: (N,).

        Returns (M, 7) [x1, y1, x2, y2, track_id, score, cls] for activated tracks.
        """
        self.frame_id += 1
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        scores = np.asarray(scores, float).reshape(-1)
        classes = np.asarray(classes, float).reshape(-1)
        idxs = np.arange(len(scores))

        hi = scores >= self.args.track_high_thresh
        second = (scores > self.args.track_low_thresh) & (scores < self.args.track_high_thresh)
        detections = self.init_track(boxes[hi], scores[hi], classes[hi], idxs[hi], img)
        detections_second = self.init_track(boxes[second], scores[second], classes[second], idxs[second], img)

        activated, refind, lost, removed = [], [], [], []

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = self.joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)
        if img is not None and hasattr(self, "gmc"):
            warp = self.gmc.apply(img)
            self.gmc_apply(strack_pool + unconfirmed, warp)

        # stage 1: high-conf detections vs tracked+lost
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_det = linear_assignment(dists, self.args.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # stage 2: low-conf rescue for remaining *tracked* tracks (IoU only)
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, detections_second)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            track, det = r_tracked[it], detections_second[idet]
            track.update(det, self.frame_id)
            activated.append(track)
        for i in u_track2:
            t = r_tracked[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # unconfirmed tracks get one strict chance against leftover detections
        leftovers = [detections[i] for i in u_det]
        dists = self.get_dists(unconfirmed, leftovers)
        matches, u_unconf, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(leftovers[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            unconfirmed[i].mark_removed()
            removed.append(unconfirmed[i])

        # births
        for i in u_det2:
            det = leftovers[i]
            if det.score >= self.args.new_track_thresh:
                det.activate(self.kalman_filter, self.frame_id)
                activated.append(det)

        # deaths
        for t in self.lost_stracks:
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = self.joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = self.joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = self.sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = self.sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = self.remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks = (self.removed_stracks + removed)[-999:]

        out = [
            np.concatenate([t.xyxy, [t.track_id, t.score, t.cls]])
            for t in self.tracked_stracks
            if t.is_activated
        ]
        return np.stack(out, 0) if out else np.zeros((0, 7))

    def reset(self):
        self.tracked_stracks, self.lost_stracks, self.removed_stracks = [], [], []
        self.frame_id = 0
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    @staticmethod
    def joint_stracks(a: list[STrack], b: list[STrack]) -> list[STrack]:
        seen = {t.track_id for t in a}
        return a + [t for t in b if t.track_id not in seen]

    @staticmethod
    def sub_stracks(a: list[STrack], b: list[STrack]) -> list[STrack]:
        ids = {t.track_id for t in b}
        return [t for t in a if t.track_id not in ids]

    @staticmethod
    def remove_duplicate_stracks(a: list[STrack], b: list[STrack]) -> tuple[list[STrack], list[STrack]]:
        dist = iou_distance(a, b)
        pairs = np.argwhere(dist < 0.15)
        dup_a, dup_b = set(), set()
        for i, j in pairs:
            if a[i].frame_id - a[i].start_frame > b[j].frame_id - b[j].start_frame:
                dup_b.add(j)
            else:
                dup_a.add(i)
        return [t for k, t in enumerate(a) if k not in dup_a], [t for k, t in enumerate(b) if k not in dup_b]
