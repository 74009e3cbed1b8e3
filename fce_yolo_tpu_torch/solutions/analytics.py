"""Analytics and monitoring solutions: ``Analytics`` charts,
``DistanceCalculation``, ``SecurityAlarm`` and ``AIGym`` (reference
``fce_yolo_tpu/solutions/analytics.py``). The charts are drawn by
``utils/chart.py`` with matplotlib's layout, without matplotlib.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults

__all__ = ["Analytics", "DistanceCalculation", "SecurityAlarm", "AIGym"]


class Analytics(BaseSolution):
    """Streaming analytics charts, with the reference's data semantics:

    - ``line``: ONE total-detections-per-frame series (total_counts, reset
      after each plotted frame), sliding window of ``max_points`` (45);
    - ``area``: one filled series per class; newly-appearing classes are
      zero-padded to the shared x axis; the window drops one point per
      overflow frame;
    - ``bar``: current class-wise counts with a STABLE per-label color
      mapping and count labels above the bars;
    - ``pie``: current class-wise counts with a percentage legend;
    - charts re-render only every ``update_every`` frames (default 30, the
      reference's caching) — in between the cached image returns.
    """

    _COLORS = ["#DD00BA", "#042AFF", "#FF4447", "#7D24FF", "#BD00FF"]

    def __init__(self, analytics_type: str = "line", update_every: int = 30,
                 max_points: int = 45, figsize: tuple = (12.8, 7.2), **kw):
        super().__init__(**kw)
        if analytics_type not in ("line", "bar", "pie", "area"):
            raise ValueError(f"analytics_type {analytics_type!r}: one of line, bar, pie, area")
        self.analytics_type = analytics_type
        self.update_every = update_every
        self.max_points = max_points
        self.figsize = figsize
        self.x_label = "Classes" if analytics_type in ("bar", "pie") else "Frame#"
        self.y_label = "Total Counts"
        self.total_counts = 0
        self.frame_idx = 0
        self.x_data = np.array([], float)
        self.y_data = np.array([], float)  # line mode
        self.y_data_dict: dict[str, np.ndarray] = {}  # area mode
        self.color_mapping: dict[str, str] = {}  # bar mode
        self.last_plot_im: np.ndarray | None = None

    def process(self, result, tracks: np.ndarray, frame_number: int | None = None
                ) -> SolutionResults:
        t = self.frame_idx if frame_number is None else frame_number
        self.frame_idx += 1
        counts: dict[str, int] = defaultdict(int)
        for row in tracks:
            counts[self.names.get(int(row[6]), str(int(row[6])))] += 1

        update = t % self.update_every == 0 or self.last_plot_im is None
        if self.analytics_type == "line":
            self.total_counts += len(tracks)
            if update:
                self.x_data = np.append(self.x_data, float(t))
                self.y_data = np.append(self.y_data, float(self.total_counts))
                if len(self.x_data) > self.max_points:
                    self.x_data = self.x_data[-self.max_points:]
                    self.y_data = self.y_data[-self.max_points:]
                self.last_plot_im = self._render(dict(counts))
            self.total_counts = 0  # reset after each frame
        else:
            if update:
                if self.analytics_type == "area":
                    self.x_data = np.append(self.x_data, float(t))
                    n = len(self.x_data)
                    for k in counts:
                        ys = self.y_data_dict.get(k, np.array([], float))
                        ys = np.append(ys, float(counts[k]))
                        self.y_data_dict[k] = np.pad(ys, (n - len(ys), 0))[-n:] \
                            if len(ys) < n else ys
                    for k in list(self.y_data_dict):
                        if k not in counts:
                            self.y_data_dict[k] = np.append(self.y_data_dict[k], 0.0)
                    if n > self.max_points:
                        self.x_data = self.x_data[1:]
                        for k in self.y_data_dict:
                            self.y_data_dict[k] = self.y_data_dict[k][1:]
                self.last_plot_im = self._render(dict(counts))
        return SolutionResults(plot_im=self.last_plot_im,
                               classwise_count=dict(counts),
                               total_tracks=len(tracks), frame=t)

    def _render(self, counts: dict) -> np.ndarray:
        from itertools import cycle

        from fce_yolo_tpu_torch.utils import chart as plt

        fig, ax = plt.subplots(figsize=self.figsize, dpi=100,
                               facecolor="#F3F3F3")
        ax.set_facecolor("#f0f0f0")
        kind = self.analytics_type
        if kind == "line":
            ax.plot(self.x_data, self.y_data, color="#7b0068", marker="*",
                    markersize=10, label="Counts")
        elif kind == "area":
            cyc = cycle(self._COLORS)
            for k, ys in self.y_data_dict.items():
                color = next(cyc)
                ax.fill_between(self.x_data, ys, color=color, alpha=0.55)
                ax.plot(self.x_data, ys, color=color, marker="o",
                        label=f"{k} Data Points")
        elif kind == "bar":
            cyc = cycle(self._COLORS)
            for k in counts:
                self.color_mapping.setdefault(k, next(cyc))
            bars = ax.bar(list(counts.keys()), list(counts.values()),
                          color=[self.color_mapping[k] for k in counts])
            for bar, c in zip(bars, counts.values()):
                ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                        str(c), ha="center", va="bottom", color="#111E68")
            for bar, k in zip(bars, counts):
                bar.set_label(k)
        else:  # pie
            if counts:
                total = sum(counts.values())
                wedges, _ = ax.pie(list(counts.values()),
                                   labels=list(counts.keys()), startangle=90)
                ax.legend(wedges,
                          [f"{k} ({v / total * 100:.1f}%)"
                           for k, v in counts.items()],
                          title="Classes", loc="center left",
                          bbox_to_anchor=(1, 0, 0.5, 1))
                fig.subplots_adjust(left=0.1, right=0.75)
            ax.axis("equal")
        if kind != "pie":
            ax.grid(True, linestyle="--", linewidth=0.5, alpha=0.5)
            ax.set_xlabel(self.x_label, color="#111E68")
            ax.set_ylabel(self.y_label, color="#111E68")
            if counts or kind == "line":
                ax.legend(loc="upper left", fontsize=9)
        ax.set_title("Analytics", color="#111E68")
        buf = fig.render()[..., ::-1].copy()  # RGB -> BGR, as the reference reads its canvas
        plt.close(fig)
        return buf


class DistanceCalculation(BaseSolution):
    """Pixel (and optionally calibrated) distance between two selected track
    ids (by id, where the reference's upstream selects by mouse clicks)."""

    def __init__(self, selected_ids: tuple[int, int] | None = None,
                 pixels_per_meter: float | None = None, **kw):
        super().__init__(**kw)
        self.selected_ids = selected_ids
        self.pixels_per_meter = pixels_per_meter

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        distance = 0.0
        distance_m = None
        centers = {
            int(r[4]): ((r[0] + r[2]) / 2, (r[1] + r[3]) / 2) for r in tracks
        }
        ids = self.selected_ids or (sorted(centers)[:2] if len(centers) >= 2 else None)
        if ids and all(i in centers for i in ids):
            p1, p2 = np.asarray(centers[ids[0]]), np.asarray(centers[ids[1]])
            distance = float(np.linalg.norm(p1 - p2))
            if self.pixels_per_meter:
                distance_m = distance / self.pixels_per_meter
            ann.plot_distance_and_line(distance, (p1, p2))
        return SolutionResults(plot_im=ann.result(), pixels_distance=distance,
                               total_tracks=len(tracks),
                               distance_m=distance_m)


class SecurityAlarm(BaseSolution):
    """An alarm when the track count reaches ``records``: ``on_alarm(n)`` is
    called once (the reference's callback in place of an email)."""

    def __init__(self, records: int = 5, on_alarm=None, **kw):
        super().__init__(**kw)
        self.records = records
        self.on_alarm = on_alarm
        self.alarm_sent = False

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        n = len(tracks)
        triggered = n >= self.records
        if triggered and not self.alarm_sent:
            self.alarm_sent = True
            if self.on_alarm is not None:
                self.on_alarm(n)
        if triggered:
            ann.display_analytics(ann.im, {"ALARM": n},
                                  txt_color=(255, 255, 255),
                                  bg_color=(0, 0, 255))
        return SolutionResults(plot_im=ann.result(), total_tracks=n,
                               email_sent=self.alarm_sent, alarm=triggered)


class AIGym(BaseSolution):
    """Workout repetition counting from pose keypoints: the joint angle
    against the up and down thresholds drives a stage machine a track id.
    Needs a -pose model. Row i of the keypoints is paired with row i of the
    tracks, as in the reference, although the tracker's rows are in another
    order and may be fewer (ROADMAP queue 3, item 39)."""

    def __init__(self, kpts: tuple[int, int, int] = (6, 8, 10),
                 up_angle: float = 145.0, down_angle: float = 90.0, **kw):
        kw.setdefault("model", "yolo11n-pose.yaml")
        super().__init__(**kw)
        self.kpts = kpts
        self.up_angle = up_angle
        self.down_angle = down_angle
        self.states: dict[int, dict] = defaultdict(lambda: {"angle": 0.0, "count": 0, "stage": "-"})

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        from fce_yolo_tpu_torch.solutions.annotator import SolutionAnnotator

        ann = self.annotator(result.plot())
        if result.keypoints is not None:
            kdata = getattr(result.keypoints, "data", result.keypoints)
            for i, k in enumerate(np.asarray(kdata)):
                tid = int(tracks[i, 4]) if i < len(tracks) else i
                st = self.states[tid]
                st["angle"] = SolutionAnnotator.estimate_pose_angle(
                    *[k[j] for j in self.kpts])
                if st["angle"] < self.down_angle:
                    if st["stage"] == "up":
                        st["count"] += 1
                    st["stage"] = "down"
                elif st["angle"] > self.up_angle:
                    st["stage"] = "up"
                ann.draw_specific_kpts(k, list(self.kpts))
                ann.plot_angle_and_count_and_stage(
                    st["angle"], st["count"], st["stage"], k[self.kpts[1]][:2])
        return SolutionResults(
            plot_im=ann.result(), total_tracks=len(tracks),
            workout_count=[v["count"] for v in self.states.values()],
            workout_stage=[v["stage"] for v in self.states.values()],
            workout_angle=[v["angle"] for v in self.states.values()])
