"""Paper tables and figures on the port (reference
``fce_yolo_tpu/experiments/figures.py``, a rebuild of script/paper_plots.py /
paper_figs.py).

The ablation and complexity tables are plain text. The comparison figures
across ablation variants (overlaid training curves in the registry's
colors, the incremental-ablation bar chart, the metric panels, the per-run
results grids of ``produce_all``) are drawn with ``utils/chart.py`` and
composed with ``utils/patches.py`` and ``data/imread.py``: neither matplotlib
nor PIL is needed. The glyph table has no CJK glyphs, so the ``cn`` figures
carry English labels (with a warning), as the reference's do on a machine
without a CJK font.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.experiments.analysis import MAP_KEY, ablation_table, best_epoch, load_results
from fce_yolo_tpu_torch.experiments.config import MODEL_CONFIGS
from fce_yolo_tpu_torch.utils import chart as plt

__all__ = [
    "plot_training_curves", "plot_ablation_bars", "produce_all", "plot_metric_panels", "compose_panels",
    "model_complexity", "write_table", "produce_ablation_table", "produce_report",
]


def plot_training_curves(
    runs: dict[str, str | Path],
    save_path: str | Path = "training_curves.png",
    key: str = MAP_KEY,
    scale: str = "m",
) -> str:
    """Overlay each variant's val-mAP curve (reference paper_plots.produce_B:235)."""
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, run_dir in runs.items():
        rows = load_results(run_dir)
        xs = [r["epoch"] for r in rows if isinstance(r.get(key), (int, float))]
        ys = [r[key] * 100 for r in rows if isinstance(r.get(key), (int, float))]
        mc = MODEL_CONFIGS.get(name)
        color = mc.color if mc else None
        label = mc.get_display_name(scale) if mc else name
        ax.plot(xs, ys, label=label, color=color, lw=1.5)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("mAP@50-95 (%)")
    ax.legend(fontsize=9)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def plot_ablation_bars(
    table: list[dict],
    save_path: str | Path = "ablation_bars.png",
    scale: str = "m",
) -> str:
    """Bar chart of best mAP50-95 per variant with incremental deltas."""
    fig, ax = plt.subplots(figsize=(7, 4.5))
    names = [r["model"] for r in table]
    vals = [r["mAP50-95"] for r in table]
    colors = [MODEL_CONFIGS[n].color if n in MODEL_CONFIGS else "#888888" for n in names]
    labels = [
        MODEL_CONFIGS[n].get_display_name(scale) if n in MODEL_CONFIGS else n for n in names
    ]
    bars = ax.bar(range(len(names)), vals, color=colors)
    for i, (b, r) in enumerate(zip(bars, table)):
        delta = r.get("delta_vs_prev")
        txt = f"{r['mAP50-95']:.2f}" + (f"\n(+{delta:.2f})" if delta and delta > 0 else "")
        ax.text(b.get_x() + b.get_width() / 2, b.get_height() + 0.1, txt, ha="center", fontsize=8)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(labels, rotation=15, fontsize=8)
    ax.set_ylabel("best mAP@50-95 (%)")
    lo = min(vals) if vals else 0
    ax.set_ylim(max(lo - 5, 0), (max(vals) if vals else 1) + 3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def produce_all(runs: dict[str, str | Path], out_dir: str | Path, scale: str = "m") -> list[str]:
    """The full figure set of an ablation: training curves, ablation bars
    and each run's results grid (``results.png`` in the run's directory)."""
    from fce_yolo_tpu_torch.utils.plotting import plot_results

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    figs = [
        plot_training_curves(runs, out_dir / "training_curves.png", scale=scale),
        plot_ablation_bars(ablation_table(runs), out_dir / "ablation_bars.png", scale=scale),
    ]
    for run in runs.values():
        f = plot_results(run)
        if f:
            figs.append(f)
    return figs


# Bilingual label sets (the fork ships CN + EN figure variants,
# paper_plots.py:94-134; CN rendering falls back to EN when no CJK font is
# installed)
_L10N = {
    "en": {
        "epoch": "Epoch", "map5095": "mAP@50-95 (%)", "map50": "mAP@50 (%)",
        "precision": "Precision (%)", "recall": "Recall (%)",
        "panels_title": "Training metric comparison",
        "ablation_title": "Ablation: incremental module gains",
    },
    "cn": {
        "epoch": "轮次", "map5095": "mAP@50-95 (%)", "map50": "mAP@50 (%)",
        "precision": "精确率 (%)", "recall": "召回率 (%)",
        "panels_title": "训练指标对比", "ablation_title": "消融实验：模块增益",
    },
}

_PANEL_KEYS = (
    ("metrics/mAP50-95(B)", "map5095"),
    ("metrics/mAP50(B)", "map50"),
    ("metrics/precision(B)", "precision"),
    ("metrics/recall(B)", "recall"),
)


def _setup_font(lang: str) -> bool:
    """Whether ``lang``'s labels can be drawn (fork setup_cn_font,
    paper_plots.py:99-134). The renderer's glyph table holds DejaVu Sans
    without CJK glyphs, so ``cn`` returns False with the reference's warning
    and the caller falls back to English labels: never missing-glyph boxes."""
    if lang != "cn":
        return True
    import warnings

    warnings.warn(
        "no CJK font found (the chart renderer's glyph table has none); falling back to English labels",
        stacklevel=2,
    )
    return False


def plot_metric_panels(
    runs: dict[str, str | Path],
    save_path: str | Path = "metric_panels.png",
    scale: str = "m",
    lang: str = "en",
) -> str:
    """2x2 panel comparison of mAP50-95 / mAP50 / P / R across variants
    (fork produce_A / plot_comparison, paper_plots.py:155-233)."""
    # no CJK font -> EN labels (explicit warning in _setup_font; never tofu)
    lang = lang if _setup_font(lang) else "en"
    L = _L10N[lang]
    fig, axes = plt.subplots(2, 2, figsize=(14, 10), tight_layout=True)
    for idx, (col, label_key) in enumerate(_PANEL_KEYS):
        ax = axes[idx // 2][idx % 2]
        for name, run_dir in runs.items():
            rows = load_results(run_dir)
            xs = [r["epoch"] for r in rows if isinstance(r.get(col), (int, float))]
            ys = [r[col] * 100 for r in rows if isinstance(r.get(col), (int, float))]
            mc = MODEL_CONFIGS.get(name)
            ax.plot(xs, ys, label=(mc.get_display_name(scale) if mc else name),
                    color=(mc.color if mc else None), lw=1.5)
        ax.set_title(L[label_key], fontsize=13, fontweight="bold")
        ax.set_xlabel(L["epoch"])
        ax.set_ylabel(L[label_key])
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    fig.suptitle(L["panels_title"], fontsize=15, fontweight="bold")
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return str(save_path)


def compose_panels(
    panels: list[tuple[str, str | Path]],
    out_path: str | Path,
    fig_title: str = "",
    vertical: bool = False,
    device="cuda",
) -> str:
    """Stack rendered figure images with per-panel subtitles (fork
    produce_C/_hstack_with_titles, paper_plots.py:317-424): the images read
    with ``data/imread.py``, the text drawn with ``utils/chart.py``, the
    result written with ``utils/patches.py``. ``device`` decodes a JPEG
    panel and encodes a ``.jpg`` output (PNG stays on the host)."""
    from fce_yolo_tpu_torch.data.imread import imread
    from fce_yolo_tpu_torch.utils.patches import imwrite

    imgs = [imread(p, device=device) for _, p in panels]  # BGR
    pad, title_h, sub_h = 12, (50 if fig_title else 0), 40
    if vertical:
        w = max(im.shape[1] for im in imgs)
        h = sum(im.shape[0] for im in imgs) + (sub_h + pad) * len(imgs) + title_h + pad
        canvas = np.full((h, w + 2 * pad, 3), 255, np.uint8)
        y = pad + title_h
        for (sub, _), im in zip(panels, imgs):
            plt.draw_text(canvas, (pad, y), sub)
            y += sub_h
            canvas[y:y + im.shape[0], pad:pad + im.shape[1]] = im
            y += im.shape[0] + pad
    else:
        h = max(im.shape[0] for im in imgs)
        w = sum(im.shape[1] for im in imgs) + pad * (len(imgs) + 1)
        canvas = np.full((h + title_h + sub_h + 2 * pad, w, 3), 255, np.uint8)
        x = pad
        for (sub, _), im in zip(panels, imgs):
            plt.draw_text(canvas, (x, title_h + pad), sub)
            top = title_h + sub_h + pad
            canvas[top:top + im.shape[0], x:x + im.shape[1]] = im
            x += im.shape[1] + pad
    if fig_title:
        plt.draw_text(canvas, (pad, 8), fig_title)
    imwrite(str(out_path), canvas, device=device)
    return str(out_path)


def model_complexity(cfgs: dict[str, str], scale: str = "n", imgsz: int = 640) -> list[dict]:
    """Params + GFLOPs table per variant (fork _compute_model_complexity,
    paper_plots.py:213-233): each model built on the ``meta`` device (no
    memory), ``param_count`` and ``estimate_flops`` (nn/model.py)."""
    from fce_yolo_tpu_torch.nn.model import build_model, estimate_flops, param_count

    out = []
    for name, cfg in cfgs.items():
        model, _, _ = build_model(cfg, scale=scale, device="meta")
        out.append({"model": name, "params_M": param_count(model) / 1e6,
                    "GFLOPs": estimate_flops(model, imgsz=imgsz) / 1e9})
    return out


def write_table(table: list[dict], out_path: str | Path, fmt: str = "markdown") -> str:
    """Serialize an ablation/complexity table (fork result tables,
    run_ablation.py:597-599) as markdown or LaTeX."""
    if not table:
        return str(out_path)
    keys = list(table[0].keys())

    def cell(v):
        return f"{v:.2f}" if isinstance(v, float) else str(v)

    lines = []
    if fmt == "latex":
        lines.append("\\begin{tabular}{" + "l" * len(keys) + "}")
        lines.append(" & ".join(keys) + " \\\\\\hline")
        for r in table:
            lines.append(" & ".join(cell(r.get(k, "")) for k in keys) + " \\\\")
        lines.append("\\end{tabular}")
    else:
        lines.append("| " + " | ".join(keys) + " |")
        lines.append("|" + "---|" * len(keys))
        for r in table:
            lines.append("| " + " | ".join(cell(r.get(k, "")) for k in keys) + " |")
    Path(out_path).write_text("\n".join(lines) + "\n")
    return str(out_path)


# ---------------------------------------------------------------------------
# Full paper report (fork produce_B table + produce_A/ C/D figure set)
# ---------------------------------------------------------------------------

_TABLE_L10N = {
    "en": {
        "idx": "No.", "model": "Model", "change": "Improvement", "loss": "Loss",
        "best_ep": "Best epoch", "prec": "Precision", "rec": "Recall",
        "map50": "mAP50", "map5095": "mAP50-95", "delta": "dmAP50-95",
        "params": "Params(M)", "gflops": "GFLOPs",
        "title": "# Ablation results (best-epoch metrics)",
        "note": "> best epoch = the val epoch with the highest mAP50-95 "
                "(the fork's standard reporting convention, paper_plots.py:255)",
    },
    "cn": {
        "idx": "序号", "model": "模型", "change": "改进", "loss": "损失",
        "best_ep": "best轮次", "prec": "Precision", "rec": "Recall",
        "map50": "mAP50", "map5095": "mAP50-95", "delta": "ΔmAP50-95",
        "params": "Params(M)", "gflops": "GFLOPs",
        "title": "# 消融实验结果表（best 指标）",
        "note": "> best 指标定义：验证集 mAP50-95 最高那一轮（YOLO 标准报告方式）",
    },
}

_IDX_MARKS = ["①", "②", "③", "④", "⑤", "⑥", "⑦", "⑧"]


def produce_ablation_table(
    runs: dict[str, str | Path],
    out_dir: str | Path,
    lang: str = "en",
    scale: str = "m",
    imgsz: int = 640,
    changes: dict[str, str] | None = None,
    loss_types: dict[str, str] | None = None,
) -> str:
    """produce_B analog (fork paper_plots.py:235-315): the incremental
    ablation table — best-epoch P/R/mAP50/mAP50-95, per-row delta, params +
    GFLOPs — written as <lang>.md + <lang>.csv. Tables are plain text, so
    the CN variant needs no font (figures are the font-gated part). Params
    and GFLOPs come from each registry variant's ``yaml_path`` (the JAX
    version asks for a ``model_yaml`` attribute that ``ModelConfig`` lacks,
    so its columns always read N/A)."""
    import csv as _csv

    L = _TABLE_L10N[lang]
    cols = [L["idx"], L["model"], L["change"], L["loss"], L["best_ep"], L["prec"],
            L["rec"], L["map50"], L["map5095"], L["delta"], L["params"], L["gflops"]]
    complexity = {}
    for name in runs:
        cfg = MODEL_CONFIGS.get(name)
        if cfg is not None:
            row = model_complexity({name: cfg.yaml_path}, scale=scale, imgsz=imgsz)[0]
            complexity[name] = (row["params_M"], row["GFLOPs"])

    rows = []
    prev = None
    for i, (name, run) in enumerate(runs.items()):
        b = best_epoch(load_results(run))
        m5095 = round(b.get(MAP_KEY, 0.0) * 100, 2)
        delta = "—" if prev is None else f"+{m5095 - prev:.2f}"
        prev = m5095
        pm, gf = complexity.get(name, (None, None))
        rows.append({
            L["idx"]: _IDX_MARKS[i] if i < len(_IDX_MARKS) else str(i + 1),
            L["model"]: name,
            L["change"]: (changes or {}).get(name, "—"),
            L["loss"]: (loss_types or {}).get(name, "CIoU"),
            L["best_ep"]: b.get("epoch", "—"),
            L["prec"]: round(b.get("metrics/precision(B)", 0.0) * 100, 2),
            L["rec"]: round(b.get("metrics/recall(B)", 0.0) * 100, 2),
            L["map50"]: round(b.get("metrics/mAP50(B)", 0.0) * 100, 2),
            L["map5095"]: m5095,
            L["delta"]: delta,
            L["params"]: round(pm, 2) if pm else "N/A",
            L["gflops"]: round(gf, 1) if gf else "N/A",
        })

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / f"ablation_table_{lang}.csv"
    with open(csv_path, "w", newline="", encoding="utf-8-sig") as f:
        w = _csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    md_path = out / f"ablation_table_{lang}.md"
    lines = [L["title"], "", L["note"], ""]
    lines.append("| " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * len(cols))
    for r in rows:
        lines.append("| " + " | ".join(str(r[c]) for c in cols) + " |")
    md_path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(md_path)


def produce_report(
    runs: dict[str, str | Path],
    out_dir: str | Path,
    langs: tuple[str, ...] = ("en", "cn"),
    scale: str = "m",
    imgsz: int = 640,
    changes: dict[str, str] | None = None,
    loss_types: dict[str, str] | None = None,
    verbose: bool = True,
) -> dict:
    """The full bilingual paper deliverable (fork paper_plots.py main):
    ablation tables (EN+CN, text — always bilingual and always written),
    metric panels per language (CN falls back to EN labels with a warning
    when no CJK font is available — never tofu), ablation bars, training
    curves, and any per-run val figures already in a run's ``plots/``.

    Returns {"written": [paths], "skipped": {}}: every figure is drawn
    (``skipped`` stays for callers of the version that needed matplotlib)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[str] = []
    for lang in langs:
        written.append(produce_ablation_table(
            runs, out, lang=lang, scale=scale, imgsz=imgsz,
            changes=changes, loss_types=loss_types,
        ))
        fig_lang = lang if _setup_font(lang) else "en"
        written.append(plot_metric_panels(runs, out / f"metric_panels_{lang}.png", scale=scale, lang=fig_lang))
    written.append(plot_ablation_bars(ablation_table(runs), out / "ablation_bars.png", scale=scale))
    written.append(plot_training_curves(runs, out / "training_curves.png", scale=scale))
    for run in runs.values():
        written += [str(f) for f in Path(run).glob("plots/*.png")]
    if verbose:
        print(f"produce_report: wrote {len(written)} files to {out}")
    return {"written": written, "skipped": {}}
