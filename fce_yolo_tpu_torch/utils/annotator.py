"""Image annotation: ``Colors``, ``Annotator``, the training and validation
mosaics of ``plot_images`` and ``save_one_box`` (reference
``fce_yolo_tpu/utils/annotator.py:21-216``), drawn with ``utils/draw.py``
in place of cv2 and written with ``utils/patches.py``, whose JPEG writer
runs its forward DCT on ``device``; and the hyperparameter scatter grid
(``plot_tune_results``), drawn with ``utils/chart.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.augment import resize_linear_f32
from fce_yolo_tpu_torch.utils import draw
from fce_yolo_tpu_torch.utils.patches import imwrite

__all__ = ["Colors", "colors", "Annotator", "plot_images", "save_one_box", "plot_tune_results"]


class Colors:
    """The Ultralytics palette (RGB; ``bgr=True`` for drawing) and the
    20-colour pose palette."""

    _HEX = ("042AFF", "0BDBEB", "F3F3F3", "00DFB7", "111F68", "FF6FDD", "FF444F", "CCED00", "00F344", "BD00FF",
            "00B4FF", "DD00BA", "00FFFF", "26C000", "01FFB3", "7D24FF", "7B0068", "FF1B6C", "FC6D2F", "A2FF0B")
    _POSE_RGB = ((255, 128, 0), (255, 153, 51), (255, 178, 102), (230, 230, 0), (255, 153, 255), (153, 204, 255),
                 (255, 102, 255), (255, 51, 255), (102, 178, 255), (51, 153, 255), (255, 153, 153), (255, 102, 102),
                 (255, 51, 51), (153, 255, 153), (102, 255, 102), (51, 255, 51), (0, 255, 0), (0, 0, 255),
                 (255, 0, 0), (255, 255, 255))

    def __init__(self):
        self.palette = [self.hex2rgb(f"#{h}") for h in self._HEX]
        self.n = len(self.palette)
        self.pose_palette = np.array(self._POSE_RGB, dtype=np.uint8)

    def __call__(self, i: int, bgr: bool = False) -> tuple:
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c

    @staticmethod
    def hex2rgb(h: str) -> tuple:
        return tuple(int(h[1 + i: 1 + i + 2], 16) for i in (0, 2, 4))


colors = Colors()

# COCO's 17-keypoint skeleton (1-based keypoint pairs) and the palette index of each limb and keypoint
SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13], [6, 7], [6, 8], [7, 9], [8, 10],
            [9, 11], [2, 3], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]
LIMB_COLOR_IDX = [9, 9, 9, 9, 7, 7, 7, 0, 0, 0, 0, 0, 16, 16, 16, 16, 16, 16, 16]
KPT_COLOR_IDX = [16, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 9, 9]


class Annotator:
    """Draw detections, masks and keypoints on a BGR uint8 image in place."""

    def __init__(self, im: np.ndarray, line_width: int | None = None, example: str = "abc", device="cuda"):
        if not im.flags.c_contiguous:
            raise ValueError("Annotator needs a contiguous image (np.ascontiguousarray)")
        self.im = im
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)
        self.sf = self.lw / 3  # font scale
        self.tf = max(self.lw - 1, 1)  # font thickness
        self.device = device  # where save runs the JPEG writer's DCT

    def get_txt_color(self, color=(128, 128, 128)) -> tuple:
        """Dark text on the palette's light colours, white on the others."""
        if color in ((255, 255, 255), (255, 204, 104), (0, 255, 255)):
            return (104, 31, 17)
        return (255, 255, 255)

    def box_label(self, box, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255),
                  rotated: bool = False):
        """A box (xyxy, or (4, 2) corners when ``rotated``) with its label on a filled tab."""
        txt_color = self.get_txt_color(color)
        if rotated:
            pts = np.asarray(box, dtype=np.int32).reshape(-1, 1, 2)
            draw.polylines(self.im, [pts], True, color, self.lw)
            p1 = tuple(int(v) for v in pts[0][0])
        else:
            p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
            draw.rectangle(self.im, p1, p2, color, self.lw, draw.LINE_AA)
        if label:
            w, h = draw.get_text_size(label, 0, self.sf, self.tf)[0]
            h += 3
            outside = p1[1] >= h
            p2 = (p1[0] + w, p1[1] - h if outside else p1[1] + h)
            draw.rectangle(self.im, p1, p2, color, -1, draw.LINE_AA)
            draw.put_text(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h - 1), 0, self.sf, txt_color,
                          self.tf, draw.LINE_AA)

    def masks(self, masks: np.ndarray, mask_colors, alpha: float = 0.5):
        """Blend (N, H, W) masks (resized to the image, INTER_LINEAR on float32, where their size differs)."""
        h, w = self.im.shape[:2]
        overlay = self.im.astype(np.float32)
        for m, color in zip(masks, mask_colors):
            mm = m.astype(np.float32)
            if mm.shape != (h, w):
                mm = resize_linear_f32(mm, (w, h))
            mask = mm > 0.5
            overlay[mask] = overlay[mask] * (1 - alpha) + np.array(color, np.float32) * alpha
        self.im[:] = overlay.astype(np.uint8)

    def kpts(self, kpts: np.ndarray, shape=None, radius: int | None = None, kpt_line: bool = True,
             conf_thres: float = 0.25):
        """Keypoints (nkpt, 2 or 3) in pixels, and the COCO skeleton for 17 of them."""
        radius = radius or self.lw
        nkpt, ndim = kpts.shape
        is_pose = nkpt == 17 and ndim in (2, 3)
        for i, k in enumerate(kpts):
            if ndim == 3 and k[2] < conf_thres:
                continue
            color = tuple(int(c) for c in colors.pose_palette[KPT_COLOR_IDX[i]]) if is_pose else colors(i)
            draw.circle(self.im, (int(k[0]), int(k[1])), radius, color, -1, draw.LINE_AA)
        if kpt_line and is_pose:
            for j, (a, b) in enumerate(SKELETON):
                ka, kb = kpts[a - 1], kpts[b - 1]
                if ndim == 3 and (ka[2] < conf_thres or kb[2] < conf_thres):
                    continue
                color = tuple(int(c) for c in colors.pose_palette[LIMB_COLOR_IDX[j]])
                draw.line(self.im, (int(ka[0]), int(ka[1])), (int(kb[0]), int(kb[1])), color, max(1, self.lw // 2),
                          draw.LINE_AA)

    def rectangle(self, xy, fill=None, outline=None, width: int = 1):
        p1, p2 = (int(xy[0]), int(xy[1])), (int(xy[2]), int(xy[3]))
        if fill:
            draw.rectangle(self.im, p1, p2, fill, -1)
        if outline:
            draw.rectangle(self.im, p1, p2, outline, width)

    def text(self, xy, text: str, txt_color=(255, 255, 255), box_color=()):
        if box_color:
            w, h = draw.get_text_size(text, 0, self.sf, self.tf)[0]
            draw.rectangle(self.im, (int(xy[0]), int(xy[1]) - h - 3), (int(xy[0]) + w, int(xy[1]) + 3), box_color, -1)
        draw.put_text(self.im, text, (int(xy[0]), int(xy[1])), 0, self.sf, txt_color, self.tf, draw.LINE_AA)

    def circle_label(self, box, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255)):
        """A filled circle at the box centre with the label in it."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        (tw, th), _ = draw.get_text_size(label, 0, self.sf, self.tf)
        radius = max(tw, th) // 2 + 6
        draw.circle(self.im, (cx, cy), radius, color, -1)
        draw.put_text(self.im, label, (cx - tw // 2, cy + th // 2), 0, self.sf, txt_color, self.tf, draw.LINE_AA)

    def result(self) -> np.ndarray:
        return self.im

    def save(self, filename: str = "image.jpg"):
        imwrite(filename, self.im, device=self.device)


def plot_images(batch: dict, names: dict[int, str] | None = None, max_images: int = 16,
                fname: str | Path = "train_batch.jpg", max_subplots: int = 16, device="cuda") -> str:
    """A mosaic of a batch with its boxes labelled, written to ``fname``.
    ``batch`` follows the reference's collate contract: ``img`` (B, H, W, 3)
    RGB uint8, ``cls`` (B, M), ``bboxes`` (B, M, 4) normalised xywh and
    ``mask`` (B, M) marking the real rows, all numpy."""
    imgs = batch["img"]
    b = min(len(imgs), max_images, max_subplots)
    ns = int(np.ceil(b ** 0.5))
    h, w = imgs.shape[1:3]
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(b):
        y, x = (i // ns) * h, (i % ns) * w
        mosaic[y: y + h, x: x + w] = imgs[i][..., ::-1]  # RGB -> BGR
    ann = Annotator(mosaic, line_width=max(1, round(h / 320)), device=device)
    for i in range(b):
        oy, ox = (i // ns) * h, (i % ns) * w
        ann.rectangle((ox, oy, ox + w - 1, oy + h - 1), outline=(255, 255, 255), width=2)
        valid = batch.get("mask")
        m = int(valid[i].sum()) if valid is not None else len(batch["cls"][i])
        for j in range(m):
            cx, cy, bw, bh = batch["bboxes"][i, j]
            c = int(batch["cls"][i, j])
            x1, y1 = ox + (cx - bw / 2) * w, oy + (cy - bh / 2) * h
            x2, y2 = ox + (cx + bw / 2) * w, oy + (cy + bh / 2) * h
            label = names.get(c, str(c)) if names else str(c)
            ann.box_label((x1, y1, x2, y2), label, colors(c, bgr=True))
    imwrite(str(fname), mosaic, device=device)
    return str(fname)


def save_one_box(xyxy, im: np.ndarray, file: str | Path = "im.jpg", gain: float = 1.02, pad: int = 10,
                 square: bool = False, save: bool = True, device="cuda") -> np.ndarray:
    """The crop of a box grown by ``gain`` and ``pad`` (clipped to the
    image), written to ``file`` when ``save``."""
    x1, y1, x2, y2 = (float(v) for v in xyxy)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw, bh = (x2 - x1) * gain + pad, (y2 - y1) * gain + pad
    if square:
        bw = bh = max(bw, bh)
    h, w = im.shape[:2]
    xa, xb = int(max(cx - bw / 2, 0)), int(min(cx + bw / 2, w))
    ya, yb = int(max(cy - bh / 2, 0)), int(min(cy + bh / 2, h))
    crop = im[ya:yb, xa:xb].copy()
    if save:
        Path(file).parent.mkdir(parents=True, exist_ok=True)
        imwrite(str(file), crop, device=device)
    return crop


def plot_tune_results(csv_file: str | Path = "tune_results.csv") -> str | None:
    """Hyperparameter-evolution scatter grid beside the tuner's CSV
    (``tune_scatter_plots.png``, dpi 150): fitness against each gene,
    coloured by fitness, the best point marked (reference
    ``fce_yolo_tpu/utils/annotator.py:219``)."""
    import csv

    from fce_yolo_tpu_torch.utils import chart as plt

    with open(csv_file) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    keys = [k for k in rows[0] if k != "fitness"]
    fitness = np.array([float(r["fitness"]) for r in rows])
    n = len(keys)
    ncols = min(5, max(1, n))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.5 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        v = np.array([float(r[k]) for r in rows])
        ax.scatter(v, fitness, c=fitness, cmap="viridis", alpha=0.8, edgecolors="none")
        best = v[fitness.argmax()]
        ax.plot(best, fitness.max(), "k+", markersize=12)
        ax.set_title(f"{k} = {best:.3g}", fontsize=8)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = str(Path(csv_file).with_name("tune_scatter_plots.png"))
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out
