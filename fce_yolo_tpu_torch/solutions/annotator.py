"""``SolutionAnnotator``: the solutions' drawing (reference
``fce_yolo_tpu/solutions/annotator.py``), on the port's ``Annotator`` and
drawn with ``utils/draw.py``: the region, queue, analytics, workout, distance
and vision-eye primitives each solution composes. It draws in place on the
BGR image given at init.
"""

from __future__ import annotations

import math

import numpy as np

from fce_yolo_tpu_torch.utils import draw
from fce_yolo_tpu_torch.utils.annotator import Annotator

__all__ = ["SolutionAnnotator"]


class SolutionAnnotator(Annotator):
    """Drawing helpers of the solutions layer."""

    # ------------------------------------------------------------- regions
    def draw_region(self, reg_pts, color=(0, 255, 0), thickness: int = 5):
        """Closed polygon/line region with corner pins."""
        pts = np.asarray(reg_pts, np.int32).reshape(-1, 1, 2)
        draw.polylines(self.im, [pts], True, color, thickness)
        for p in pts.reshape(-1, 2):
            draw.circle(self.im, (int(p[0]), int(p[1])), thickness * 2, color, -1)

    def queue_counts_display(self, label: str, points=None, region_color=(255, 255, 255), txt_color=(0, 0, 0)):
        """Centered queue-count banner over the region."""
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        cx, cy = int(pts[:, 0].mean()), int(pts[:, 1].mean())
        (tw, th), _ = draw.get_text_size(label, 0, self.sf, self.tf)
        draw.rectangle(self.im, (cx - tw // 2 - 10, cy - th // 2 - 10), (cx + tw // 2 + 10, cy + th // 2 + 10),
                       region_color, -1)
        draw.put_text(self.im, label, (cx - tw // 2, cy + th // 2), 0, self.sf, txt_color, self.tf, draw.LINE_AA)

    def display_analytics(self, im0: np.ndarray, text: dict, txt_color=(104, 31, 17), bg_color=(255, 255, 255),
                          margin: int = 10):
        """Right-aligned stacked stat boxes."""
        horizontal_gap = int(im0.shape[1] * 0.02)
        vertical_gap = int(im0.shape[0] * 0.01)
        offset = 0
        for label, value in text.items():
            txt = f"{label}: {value}"
            (tw, th), _ = draw.get_text_size(txt, 0, self.sf, self.tf)
            tw, th = max(tw, 10), max(th, 10)
            tx = im0.shape[1] - tw - margin * 2 - horizontal_gap
            ty = th + margin * 2 + vertical_gap + offset
            draw.rectangle(im0, (tx - margin, ty - th - margin), (tx + tw + margin, ty + margin), bg_color, -1)
            draw.put_text(im0, txt, (tx, ty), 0, self.sf, txt_color, self.tf, draw.LINE_AA)
            offset += 2 * th + margin * 3

    # ---------------------------------------------------------------- pose
    @staticmethod
    def estimate_pose_angle(a, b, c) -> float:
        """Angle at vertex ``b`` of the a-b-c joint in degrees."""
        a, b, c = (np.asarray(p[:2], np.float64) for p in (a, b, c))
        rad = math.atan2(c[1] - b[1], c[0] - b[0]) - math.atan2(a[1] - b[1], a[0] - b[0])
        ang = abs(rad * 180.0 / math.pi)
        return 360.0 - ang if ang > 180.0 else ang

    def draw_specific_kpts(self, keypoints, indices=None, radius: int = 2, conf_thresh: float = 0.25):
        """Circles + connecting lines for a keypoint subset."""
        indices = indices or [2, 5, 7]
        pts = [(int(k[0]), int(k[1])) for i, k in enumerate(keypoints)
               if i in indices and (len(k) < 3 or k[2] >= conf_thresh)]
        for s, e in zip(pts[:-1], pts[1:]):
            draw.line(self.im, s, e, (0, 255, 0), 2, draw.LINE_AA)
        for p in pts:
            draw.circle(self.im, p, radius, (255, 0, 255), -1, draw.LINE_AA)
        return self.im

    def plot_workout_information(self, display_text: str, position, color=(104, 31, 17),
                                 txt_color=(255, 255, 255)) -> int:
        """One padded workout stat line; returns the text height."""
        (tw, th), _ = draw.get_text_size(display_text, 0, self.sf, self.tf)
        draw.rectangle(self.im, (position[0], position[1] - th - 5),
                       (position[0] + tw + 10, position[1] - th - 5 + th + 10 + self.tf), color, -1)
        draw.put_text(self.im, display_text, position, 0, self.sf, txt_color, self.tf)
        return th

    def plot_angle_and_count_and_stage(self, angle_text: float, count_text, stage_text: str, center_kpt,
                                       color=(104, 31, 17), txt_color=(255, 255, 255)):
        """Stacked angle/reps/stage block at a joint."""
        angle_text = f" {angle_text:.2f}"
        count_text = f"Steps : {count_text}"
        stage_text = f" {stage_text}"
        x, y = int(center_kpt[0]), int(center_kpt[1])
        h = self.plot_workout_information(angle_text, (x, y), color, txt_color)
        h2 = self.plot_workout_information(count_text, (x, y + h + 20), color, txt_color)
        self.plot_workout_information(stage_text, (x, y + h + h2 + 40), color, txt_color)

    # ------------------------------------------------------------ distance
    def plot_distance_and_line(self, pixels_distance: float, centroids, line_color=(104, 31, 17),
                               centroid_color=(255, 0, 255)):
        """Distance banner + line between two centroids."""
        text = f"Pixels Distance: {pixels_distance:.2f}"
        (tw, th), _ = draw.get_text_size(text, 0, self.sf, self.tf)
        draw.rectangle(self.im, (15, 25), (15 + tw + 20, 25 + th + 20), line_color, -1)
        draw.put_text(self.im, text, (20, 50), 0, self.sf, (255, 255, 255), self.tf, draw.LINE_AA)
        c0 = (int(centroids[0][0]), int(centroids[0][1]))
        c1 = (int(centroids[1][0]), int(centroids[1][1]))
        draw.line(self.im, c0, c1, line_color, 3)
        draw.circle(self.im, c0, 6, centroid_color, -1)
        draw.circle(self.im, c1, 6, centroid_color, -1)

    # ------------------------------------------------------------- labels
    def display_objects_labels(self, im0: np.ndarray, text: str, txt_color=(255, 255, 255), bg_color=(104, 31, 17),
                               x_center: float = 0.0, y_center: float = 0.0, margin: int = 5):
        """Centered label with filled background at a region centroid."""
        (tw, th), _ = draw.get_text_size(str(text), 0, self.sf, self.tf)
        tx, ty = int(x_center - tw / 2), int(y_center + th / 2)
        draw.rectangle(im0, (tx - margin, ty - th - margin), (tx + tw + margin, ty + margin), bg_color, -1)
        draw.put_text(im0, str(text), (tx, ty), 0, self.sf, txt_color, self.tf, draw.LINE_AA)

    def sweep_annotator(self, line_x: int = 0, line_y: int = 0, label: str | None = None, color=(104, 31, 17),
                        txt_color=(255, 255, 255)):
        """Vertical sweep line with an optional center label."""
        draw.line(self.im, (line_x, 0), (line_x, line_y), color, self.lw * 2)
        if label:
            (tw, th), _ = draw.get_text_size(label, 0, self.sf, self.tf)
            draw.rectangle(self.im, (line_x - tw // 2 - 10, line_y // 2 - th // 2 - 10),
                           (line_x + tw // 2 + 10, line_y // 2 + th // 2 + 10), color, -1)
            draw.put_text(self.im, label, (line_x - tw // 2, line_y // 2 + th // 2), 0, self.sf, txt_color, self.tf)

    def visioneye(self, box, center_point, color=(235, 219, 11), pin_color=(255, 0, 255)):
        """Eye-point to object-centroid mapping line."""
        center = (int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2))
        eye = (int(center_point[0]), int(center_point[1]))
        draw.circle(self.im, eye, self.lw * 2, pin_color, -1)
        draw.circle(self.im, center, self.lw * 2, color, -1)
        draw.line(self.im, eye, center, color, self.lw)

    def adaptive_label(self, box, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255),
                       shape: str = "rect"):
        """A label centered on the box: in a circle (compact ids) or a filled rectangle."""
        if shape == "circle":
            self.circle_label(box, label, color, txt_color)
            return
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        (tw, th), _ = draw.get_text_size(label, 0, self.sf, self.tf)
        draw.rectangle(self.im, (cx - tw // 2 - 5, cy - th // 2 - 5), (cx + tw // 2 + 5, cy + th // 2 + 5), color, -1)
        draw.put_text(self.im, label, (cx - tw // 2, cy + th // 2), 0, self.sf, txt_color, self.tf, draw.LINE_AA)
