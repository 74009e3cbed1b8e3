"""Result figures: training curves, PR and metric-confidence curves, the
confusion matrix, label statistics, tuner plots, feature maps and annotated
label files (reference ``fce_yolo_tpu/utils/plotting.py``).

The reference draws them with matplotlib; these draw the same figures with
``utils/chart.py`` (numpy on the host, PNG through ``utils/patches.py``), with
the reference's names, arguments, file names and dpi.
``visualize_image_annotations`` draws with ``utils/draw.py`` in place of cv2.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.utils import chart as plt

__all__ = ["plot_results", "plot_pr_curve", "plot_mc_curve", "plot_confusion_matrix", "plot_labels",
           "plt_color_scatter", "feature_visualization", "plot_tune_results", "visualize_image_annotations"]


def plot_results(run_dir: str | Path, save: bool = True) -> str | None:
    """Training-curve grid from a run's ``results.csv`` (``results.png``, dpi 120)."""
    from fce_yolo_tpu_torch.experiments.analysis import load_results

    rows = load_results(run_dir)
    if not rows:
        return None
    keys = [k for k in rows[0] if k not in ("epoch", "time") and isinstance(rows[0][k], (int, float))]
    epochs = [r["epoch"] for r in rows]
    n = len(keys)
    ncols = min(4, max(1, n))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        ys = [r.get(k) for r in rows]
        ax.plot(epochs, [np.nan if y is None else y for y in ys], marker=".", lw=1)
        ax.set_title(k, fontsize=9)
        ax.set_xlabel("epoch", fontsize=8)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = str(Path(run_dir) / "results.png")
    if save:
        fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_pr_curve(px: np.ndarray, py: np.ndarray, ap: np.ndarray, names: dict[int, str],
                  save_path: str | Path = "PR_curve.png") -> str:
    """PR curve of each class and the thick mean curve (dpi 150)."""
    fig, ax = plt.subplots(figsize=(9, 6))
    py = np.atleast_2d(py)
    if 0 < len(names) <= 20:
        for i, y in enumerate(py):
            label = f"{names.get(i, i)} {ap[i, 0]:.3f}" if i < len(ap) else str(i)
            ax.plot(px, y, lw=1, label=label)
    else:
        ax.plot(px, py.T, lw=1, color="grey", alpha=0.4)
    ax.plot(px, py.mean(0), lw=3, color="blue", label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def plot_mc_curve(px: np.ndarray, py: np.ndarray, names: dict[int, str], save_path: str | Path = "F1_curve.png",
                  xlabel: str = "Confidence", ylabel: str = "Metric") -> str:
    """Metric-confidence curve of each class and the smoothed mean (the F1,
    P and R figures; dpi 150)."""
    from fce_yolo_tpu_torch.utils.metrics import smooth

    fig, ax = plt.subplots(figsize=(9, 6))
    py = np.atleast_2d(py)
    if 0 < len(names) <= 20:
        for i, y in enumerate(py):
            ax.plot(px, y, lw=1, label=names.get(i, str(i)))
    else:
        ax.plot(px, py.T, lw=1, color="grey", alpha=0.4)
    y = smooth(py.mean(0), 0.1)
    ax.plot(px, y, lw=3, color="blue", label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def plot_confusion_matrix(matrix: np.ndarray, names: dict[int, str], save_path: str | Path = "confusion_matrix.png",
                          normalize: bool = True) -> str:
    """(nc+1) x (nc+1) heatmap with the background row and column, cell
    values written where there are at most 30 rows (dpi 150)."""
    m = matrix.astype(float)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    labels = [names.get(i, str(i)) for i in range(len(names))] + ["background"]
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(m, cmap="Blues", vmin=0.0)
    fig.colorbar(im, ax=ax)
    n = len(labels)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    if n <= 30:
        for i in range(n):
            for j in range(n):
                if m[i, j] > 0.005:
                    ax.text(j, i, f"{m[i, j]:.2f}", ha="center", va="center", fontsize=6,
                            color="white" if m[i, j] > 0.5 * m.max() else "black")
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def plot_labels(cls: np.ndarray, bboxes_xywhn: np.ndarray, names: dict[int, str],
                save_path: str | Path = "labels.png") -> str:
    """Dataset label statistics: class histogram and box width/height scatter (dpi 120)."""
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    nc = len(names) or int(cls.max()) + 1
    axes[0].hist(cls, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0].set_xlabel("class")
    axes[0].set_ylabel("instances")
    if len(bboxes_xywhn):
        axes[1].scatter(bboxes_xywhn[:, 2], bboxes_xywhn[:, 3], s=4, alpha=0.4)
    axes[1].set_xlabel("width")
    axes[1].set_ylabel("height")
    axes[1].set_xlim(0, 1)
    axes[1].set_ylim(0, 1)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return str(save_path)


def plt_color_scatter(v, f, bins: int = 20, cmap: str = "viridis", alpha: float = 0.8,
                      edgecolors: str = "none") -> None:
    """Scatter on the current axes (``chart.sca``), each point coloured by the
    population of its (v, f) 2-D histogram bin."""
    v, f = np.asarray(v, float), np.asarray(f, float)
    hist, xe, ye = np.histogram2d(v, f, bins=bins)
    xi = np.clip(np.digitize(v, xe) - 1, 0, bins - 1)
    yi = np.clip(np.digitize(f, ye) - 1, 0, bins - 1)
    plt.scatter(v, f, c=hist[xi, yi], cmap=cmap, alpha=alpha, edgecolors=edgecolors)


def feature_visualization(x, module_type: str, stage: int, n: int = 32, save_dir=None) -> str | None:
    """Grid of the first ``n`` channel maps of one module's output (dpi 120,
    cropped to its content). ``x`` is the port's NCHW tensor or array (the
    reference takes NHWC); outputs with H or W of 1 are skipped."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x)
    if x.ndim != 4 or x.shape[2] == 1 or x.shape[3] == 1:
        return None
    save_dir = Path(save_dir or "runs/features")
    save_dir.mkdir(parents=True, exist_ok=True)
    blocks = x[0]  # C, H, W channel maps
    n = min(n, blocks.shape[0])
    ncols = 8
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(ncols * 1.5, nrows * 1.5), squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(blocks[i], cmap="gray")
    f = save_dir / f"stage{stage}_{module_type.rsplit('.', 1)[-1]}_features.png"
    fig.savefig(f, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(f)


def plot_tune_results(csv_file: str | Path = "tune_results.csv", exclude_zero_fitness_points: bool = True) -> list[str]:
    """The tuner's figures beside its CSV: ``tune_scatter_plots.png`` (a
    fitness scatter per gene, the best iteration marked) and
    ``tune_fitness.png`` (fitness per iteration with the running best), dpi
    120. Returns the paths written."""
    csv_file = Path(csv_file)
    rows = list(csv.reader(csv_file.read_text().splitlines()))
    keys, data = rows[0][1:], np.asarray(rows[1:], np.float64)
    if not len(data):
        return []
    fitness, genes = data[:, 0], data[:, 1:]
    if exclude_zero_fitness_points and (fitness > 0).any():
        keep = fitness > 0
        fitness, genes = fitness[keep], genes[keep]
    best_i = int(fitness.argmax())

    n = len(keys)
    ncols = int(np.ceil(np.sqrt(n))) or 1
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 3.0 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        plt.sca(ax)
        plt_color_scatter(genes[:, i], fitness, alpha=0.8)
        ax.plot(genes[best_i, i], fitness[best_i], "k+", markersize=13)
        ax.set_title(f"{k} = {genes[best_i, i]:.3g}", fontsize=9)
        ax.tick_params(axis="both", labelsize=7)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    scatter_path = str(csv_file.with_name("tune_scatter_plots.png"))
    fig.savefig(scatter_path, dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6.4, 4.0))
    it = np.arange(1, len(fitness) + 1)
    ax.plot(it, fitness, marker="o", ms=3, lw=1, label="fitness")
    ax.plot(it, np.maximum.accumulate(fitness), lw=2, label="best so far")
    ax.set_xlabel("iteration")
    ax.set_ylabel("fitness")
    ax.legend()
    fig.tight_layout()
    fit_path = str(csv_file.with_name("tune_fitness.png"))
    fig.savefig(fit_path, dpi=120)
    plt.close(fig)
    return [scatter_path, fit_path]


def visualize_image_annotations(image_path: str | Path, txt_path: str | Path, label_map: dict[int, str],
                                save_path: str | Path | None = None, device="cuda") -> str:
    """Draw a YOLO label file's boxes and class names onto its image and
    write it (``<stem>_annotated.jpg`` by default); the text colour follows
    the box colour's luminance. ``device`` runs the JPEG decode and encode
    (the card unless the caller asks for the CPU)."""
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.utils import draw
    from fce_yolo_tpu_torch.utils.annotator import colors
    from fce_yolo_tpu_torch.utils.patches import imwrite

    img = np.ascontiguousarray(imread(image_path, device=device))
    h, w = img.shape[:2]
    for line in Path(txt_path).read_text(encoding="utf-8").splitlines():
        vals = line.split()
        if len(vals) < 5:
            continue
        c = int(float(vals[0]))
        xc, yc, bw, bh = (float(v) for v in vals[1:5])
        x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
        x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
        color = colors(c, bgr=True)
        draw.rectangle(img, (x1, y1), (x2, y2), color, 2)
        lum = 0.2126 * color[2] + 0.7152 * color[1] + 0.0722 * color[0]
        txt = (255, 255, 255) if lum < 128 else (0, 0, 0)
        label = label_map.get(c, str(c))
        (tw, th), _ = draw.get_text_size(label, draw.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        draw.rectangle(img, (x1, y1 - th - 6), (x1 + tw, y1), color, -1)
        draw.put_text(img, label, (x1, y1 - 4), draw.FONT_HERSHEY_SIMPLEX, 0.5, txt, 1)
    out = str(save_path or Path(image_path).with_name(Path(image_path).stem + "_annotated.jpg"))
    imwrite(out, img, device=device)
    return out
