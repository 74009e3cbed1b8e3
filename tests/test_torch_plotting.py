"""Each figure of the port (``utils/plotting.py``, ``utils/annotator.py``,
``experiments/figures.py``, drawn with ``utils/chart.py``) against the JAX
package's matplotlib figure on the same seeded inputs.

The JAX figure is captured by wrapping ``matplotlib.figure.Figure.savefig``
(the JAX package is not edited), the port's by wrapping
``chart.Figure.savefig``. Held equal: each axes' line series, titles, axis
labels, tick positions and tick-label strings, legend entries and the legend
box (so the ``loc="best"`` choice), text strings and colours, the ``imshow``
array, scatter offsets and colours, and the PNG's pixel size; view limits to
1e-9 relative. Bounds, stated where they are held:

- ``BOX_SHARE``: each axes' box after the layout lies within 2 % of the
  figure's width and height of matplotlib's ``ax.get_position()``;
- ``PIXEL_SHARE``: at most 5 % of a figure's pixels differ from matplotlib's
  PNG by more than 64 levels in a channel (glyphs are filled from unhinted
  outlines, strokes by distance, so edges differ within a pixel);
- ``INK_SHARE``: at most 30 % of the ink pixels (more than 24 levels from
  white in either PNG) differ by more than 64 levels;
- ``INK_CLUSTER``: call an ink pixel of one PNG stray when it lies more
  than ``INK_PX`` = 2 px from every ink pixel of the other. No 2 x 2 block
  is all stray, and no 7 x 7 window holds more than 9 stray pixels. A
  missing or misplaced tick, glyph or marker leaves such a cluster; what
  stays is rotated text, whose glyphs FreeType hints in their own frame, so
  a stem may land 3 px away as a 1 px line;
- ``CURVE_PX``: in every pixel column of the plot area, the centre row of
  ``PR_curve.png``'s thick mean curve lies within 2 px of matplotlib's
  (the columns of the legend, whose handle has the curve's colour, left out).
"""

import csv
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import matplotlib
import matplotlib.figure
import numpy as np
import pytest
from matplotlib.colors import to_rgba as mpl_rgba

import fce_yolo_tpu.experiments.figures as JF
import fce_yolo_tpu.utils.annotator as JA
import fce_yolo_tpu.utils.metrics as JM
import fce_yolo_tpu.utils.plotting as JP
import fce_yolo_tpu_torch.experiments.figures as PF
import fce_yolo_tpu_torch.utils.annotator as PA
import fce_yolo_tpu_torch.utils.metrics as PM
import fce_yolo_tpu_torch.utils.plotting as PP
from fce_yolo_tpu_torch.experiments.analysis import ablation_table
from fce_yolo_tpu_torch.utils import chart

matplotlib.use("Agg")

REPO = Path(__file__).resolve().parents[1]
BOX_SHARE = 0.02
PIXEL_SHARE = 0.05
PIXEL_LEVELS = 64
CURVE_PX = 2.0
INK_LEVELS = 24
INK_SHARE = 0.30
INK_PX = 2
INK_WINDOW = 7
INK_CLUSTER = 9


@pytest.fixture()
def captured(monkeypatch):
    """Figures as they are saved: {"mpl": [(fig, path)], "port": [(fig, path)]}."""
    got = {"mpl": [], "port": []}
    real_mpl, real_port = matplotlib.figure.Figure.savefig, chart.Figure.savefig

    def mpl_save(self, fname, *a, **kw):
        real_mpl(self, fname, *a, **kw)
        got["mpl"].append((self, str(fname)))

    def port_save(self, fname, dpi=None, bbox_inches=None):
        real_port(self, fname, dpi, bbox_inches)
        got["port"].append((self, str(fname)))

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", mpl_save)
    monkeypatch.setattr(chart.Figure, "savefig", port_save)
    return got


def _same(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _port_lines(ax):
    return [a for a in ax.children if isinstance(a, chart.Line2D)]


def assert_axes_equal(fm, fp) -> None:
    assert len(fm.axes) == len(fp.axes)
    for am, ap in zip(fm.axes, fp.axes):
        assert am.get_title() == ap.get_title()
        assert am.get_xlabel() == ap.get_xlabel() and am.get_ylabel() == ap.get_ylabel()
        np.testing.assert_allclose(am.get_xlim(), ap.get_xlim(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(am.get_ylim(), ap.get_ylim(), rtol=1e-9, atol=1e-12)
        assert _same(am.get_xticks(), ap.get_xticks()) and _same(am.get_yticks(), ap.get_yticks())
        assert [t.get_text() for t in am.get_xticklabels()] == ap.get_xticklabels()
        assert [t.get_text() for t in am.get_yticklabels()] == ap.get_yticklabels()
        lm, lp = am.get_lines(), _port_lines(ap)
        assert len(lm) == len(lp)
        for a, b in zip(lm, lp):
            assert _same(a.get_xdata(), b.get_xdata()) and _same(a.get_ydata(), b.get_ydata())
            assert a.get_label() == b.get_label()
            assert mpl_rgba(a.get_color(), a.get_alpha()) == chart.to_rgba(b.get_color(), b.alpha)
        tm = [t for t in am.texts]
        tp = [t for t in ap.children if isinstance(t, chart.Text)]
        assert [(t.get_text(), mpl_rgba(t.get_color())) for t in tm] == \
               [(t.get_text(), chart.to_rgba(t.get_color())) for t in tp]
        im, ip = am.get_images(), [a for a in ap.children if isinstance(a, chart.AxesImage)]
        assert len(im) == len(ip)
        for a, b in zip(im, ip):
            assert _same(a.get_array(), b.get_array())
        cm = am.collections
        cp = [a for a in ap.children if isinstance(a, (chart.PathCollection, chart.PolyCollection))]
        if ap.colorbar_of is not None:  # a colorbar's solids are a mesh there, drawn by the renderer
            cm = []
        assert len(cm) == len(cp)
        for a, b in zip(cm, cp):
            if isinstance(b, chart.PolyCollection):  # fill_between: its polygon (closed there) and colour
                assert _same(a.get_paths()[0].vertices[:len(b.verts)], b.verts)
                assert tuple(a.get_facecolor()[0]) == b.get_facecolor()
                continue
            assert _same(a.get_offsets(), b.get_offsets())
            fc = a.get_facecolors()
            assert _same(np.broadcast_to(fc, b.get_facecolors().shape), b.get_facecolors())
        bm = [p for p in am.patches if isinstance(p, matplotlib.patches.Rectangle)]
        bp = [a for a in ap.children if isinstance(a, chart.Rectangle)]
        assert [(p.get_x(), p.get_width(), p.get_height()) for p in bm] == \
               [(p.get_x(), p.get_width(), p.get_height()) for p in bp]
        gm, gp = am.get_legend(), ap.get_legend()
        assert (gm is None) == (gp is None)
        if gm is not None:
            assert [t.get_text() for t in gm.get_texts()] == gp.get_texts()
            # the box (at the figure's dpi) pins the location "best" chose
            np.testing.assert_allclose(gm.get_window_extent().bounds, gp.position(fp.dpi).bounds, rtol=1e-9)
        pm, pp = am.get_position(), ap.get_position()
        assert abs(pm.x0 - pp.x0) <= BOX_SHARE and abs(pm.x1 - pp.x1) <= BOX_SHARE
        assert abs(pm.y0 - pp.y0) <= BOX_SHARE and abs(pm.y1 - pp.y1) <= BOX_SHARE


def _ink(img: np.ndarray) -> np.ndarray:
    return (255 - img.astype(int)).max(2) > INK_LEVELS


def _far_ink(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ink of ``a`` more than ``INK_PX`` from any ink of ``b``."""
    near = np.ones((2 * INK_PX + 1, 2 * INK_PX + 1), np.uint8)
    return a & ~cv2.dilate(b.astype(np.uint8), near).astype(bool)


def assert_pixels_close(mpl_png: str, port_png: str) -> tuple[np.ndarray, np.ndarray]:
    ref, got = cv2.imread(mpl_png), cv2.imread(port_png)
    assert ref.shape == got.shape
    far = np.abs(ref.astype(int) - got.astype(int)).max(2) > PIXEL_LEVELS
    assert far.mean() <= PIXEL_SHARE
    ink_ref, ink_got = _ink(ref), _ink(got)
    assert far[ink_ref | ink_got].mean() <= INK_SHARE
    for stray in (_far_ink(ink_ref, ink_got), _far_ink(ink_got, ink_ref)):
        stray = stray.astype(np.float32)
        assert cv2.boxFilter(stray, -1, (2, 2), normalize=False).max() < 4
        assert cv2.boxFilter(stray, -1, (INK_WINDOW, INK_WINDOW), normalize=False).max() <= INK_CLUSTER
    return ref, got


def check(captured, n: int) -> None:
    assert len(captured["mpl"]) == len(captured["port"]) == n
    for (fm, pm), (fp, pp) in zip(captured["mpl"], captured["port"]):
        assert re.sub(r"_j\.png$", ".png", Path(pm).name) == re.sub(r"_p\.png$", ".png", Path(pp).name)
        assert_axes_equal(fm, fp)
        assert_pixels_close(pm, pp)


RNG = np.random.default_rng(0)
NAMES3 = {0: "person", 1: "car", 2: "dog"}


def _curves(nc):
    px = np.linspace(0, 1, 1000)
    py = np.sort(RNG.random((nc, 1000)), 1)[:, ::-1]
    return px, py, RNG.random((nc, 10))


@pytest.mark.parametrize("nc", [3, 25])
def test_pr_curve(captured, tmp_path, nc):
    """Per-class curves with a legend (<= 20 classes) or grey ones (more)."""
    px, py, ap = _curves(nc)
    names = NAMES3 if nc == 3 else {i: f"c{i}" for i in range(nc)}
    JP.plot_pr_curve(px, py, ap, names, tmp_path / "PR_curve_j.png")
    PP.plot_pr_curve(px, py, ap, names, tmp_path / "PR_curve_p.png")
    check(captured, 1)
    ref, got = cv2.imread(str(tmp_path / "PR_curve_j.png")), cv2.imread(str(tmp_path / "PR_curve_p.png"))
    fp = captured["port"][0][0]
    b = fp.axes[0].bbox(150.0)
    h = got.shape[0]
    centres = []
    for img in (ref, got):  # the mean curve is pure blue (0, 0, 255 in BGR)
        blue = (img[..., 0] > 200) & (img[..., 1] < 60) & (img[..., 2] < 60)
        rows = np.arange(h)[:, None]
        count = blue.sum(0)
        centres.append(np.where(count > 0, (blue * rows).sum(0) / np.maximum(count, 1), np.nan))
    cols = np.arange(int(np.ceil(b.x0)) + 4, int(b.x1) - 4)
    leg = fp.axes[0].get_legend().position(150.0)  # its handle is the same blue: leave its columns out
    cols = cols[(cols < leg.x0 - 1) | (cols > leg.x1 + 1)]
    both = cols[np.isfinite(centres[0][cols]) & np.isfinite(centres[1][cols])]
    assert len(both) > 0.5 * len(cols)
    assert np.abs(centres[0][both] - centres[1][both]).max() <= CURVE_PX


def test_mc_curves(captured, tmp_path):
    px, py, _ = _curves(3)
    for ylabel in ("F1", "Precision"):
        JP.plot_mc_curve(px, py, NAMES3, tmp_path / f"{ylabel}_j.png", ylabel=ylabel)
        PP.plot_mc_curve(px, py, NAMES3, tmp_path / f"{ylabel}_p.png", ylabel=ylabel)
    check(captured, 2)


@pytest.mark.parametrize("nc,normalize", [(3, False), (12, True)])
def test_confusion_matrix(captured, tmp_path, nc, normalize):
    """The heatmap, its colorbar (two axes) and the cell texts."""
    mat = RNG.integers(0, 20, (nc + 1, nc + 1)).astype(float)
    names = {i: f"class{i}" for i in range(nc)}
    JP.plot_confusion_matrix(mat, names, tmp_path / "cm_j.png", normalize=normalize)
    PP.plot_confusion_matrix(mat, names, tmp_path / "cm_p.png", normalize=normalize)
    check(captured, 1)


def test_labels(captured, tmp_path):
    cls, boxes = RNG.integers(0, 5, 200), RNG.random((200, 4))
    JP.plot_labels(cls, boxes, {i: str(i) for i in range(5)}, tmp_path / "labels_j.png")
    PP.plot_labels(cls, boxes, {i: str(i) for i in range(5)}, tmp_path / "labels_p.png")
    check(captured, 1)


def _results_csv(d: Path, epochs: int) -> None:
    d.mkdir(parents=True, exist_ok=True)
    keys = ["epoch", "train/box_loss", "train/cls_loss", "metrics/precision(B)", "metrics/mAP50-95(B)",
            "val/box_loss", "lr/pg0", "time"]
    rng = np.random.default_rng(epochs)
    with open(d / "results.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        for e in range(epochs):
            w.writerow([e, *[f"{v:.5g}" for v in rng.random(5) * 3], f"{0.01 / (e + 1):.6g}", "12.5"])


@pytest.mark.parametrize("epochs", [1, 6])
def test_results(captured, tmp_path, epochs):
    """``results.png``: seven panels and an empty one turned off; one epoch
    makes each x range singular."""
    for tag, m in (("j", JP), ("p", PP)):
        _results_csv(tmp_path / tag, epochs)
        assert m.plot_results(tmp_path / tag) == str(tmp_path / tag / "results.png")
    check(captured, 1)


def test_tune_results(captured, tmp_path):
    """Both tuner figures of ``utils/plotting.py`` and the annotator's grid."""
    rng = np.random.default_rng(2)
    rows = [[i, f"{rng.random():.4f}", f"{rng.random() * 0.01:.5f}", f"{0.6 + rng.random() * 0.3:.4f}",
             f"{rng.random() * 5e-4:.6f}", f"{rng.random() * 10:.3f}"] for i in range(12)]
    for tag, m, am in (("j", JP, JA), ("p", PP, PA)):
        d = tmp_path / tag
        d.mkdir()
        with open(d / "tune_results.csv", "w", newline="") as f:
            csv.writer(f).writerows([["iteration", "fitness", "lr0", "momentum", "weight_decay", "box"], *rows])
        assert [Path(p).name for p in m.plot_tune_results(d / "tune_results.csv")] == \
               ["tune_scatter_plots.png", "tune_fitness.png"]
        (d / "ann").mkdir()
        with open(d / "ann" / "tune_results.csv", "w", newline="") as f:
            csv.writer(f).writerows([["fitness", "lr0", "momentum", "weight_decay", "box"], *[r[1:] for r in rows]])
        assert Path(am.plot_tune_results(d / "ann" / "tune_results.csv")).name == "tune_scatter_plots.png"
    check(captured, 3)


def test_feature_visualization(captured, tmp_path):
    """The port takes NCHW, the JAX function NHWC; cropped to the content."""
    x = RNG.random((1, 12, 20, 20)).astype(np.float32)
    JP.feature_visualization(x.transpose(0, 2, 3, 1), "m.C3k2", 4, save_dir=tmp_path / "j")
    PP.feature_visualization(x, "m.C3k2", 4, save_dir=tmp_path / "p")
    check(captured, 1)
    assert PP.feature_visualization(np.zeros((1, 4, 1, 1)), "m.Detect", 9, save_dir=tmp_path / "p") is None


@pytest.fixture()
def runs(tmp_path):
    runs = {}
    for k, name in enumerate(["baseline", "bifpn", "fce", "fce_wiou"]):
        d = tmp_path / "runs" / name
        d.mkdir(parents=True)
        rng = np.random.default_rng(10 + k)
        keys = ["epoch", "train/box_loss", "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)"]
        with open(d / "results.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            for e in range(12):
                w.writerow([e, *[f"{v:.5f}" for v in (rng.random() * 2, *(0.3 + 0.02 * e + 0.05 * rng.random(4)))]])
        runs[name] = d
    return runs


def test_paper_figures(captured, tmp_path, runs):
    """Training curves, ablation bars (two-line labels, rotated ticks) and the
    2 x 2 metric panels (tight layout at draw time, bold titles, a suptitle)."""
    table = ablation_table(runs)
    for tag, m in (("j", JF), ("p", PF)):
        m.plot_training_curves(runs, tmp_path / f"training_curves_{tag}.png", scale="s")
        m.plot_ablation_bars(table, tmp_path / f"ablation_bars_{tag}.png", scale="s")
        m.plot_metric_panels(runs, tmp_path / f"metric_panels_{tag}.png", scale="s")
    check(captured, 3)


def test_cn_falls_back_to_english_with_a_warning(captured, tmp_path, runs):
    with pytest.warns(UserWarning, match="falling back to English labels"):
        PF.plot_metric_panels(runs, tmp_path / "cn.png", scale="s", lang="cn")
    fig = captured["port"][0][0]
    assert fig._suptitle.text == "Training metric comparison"
    assert [ax.get_title() for ax in fig.axes] == ["mAP@50-95 (%)", "mAP@50 (%)", "Precision (%)", "Recall (%)"]


def test_produce_all_and_compose_panels(tmp_path, runs):
    """``produce_all``'s files are the JAX function's; ``compose_panels``
    keeps PIL's canvas size and pastes each image unchanged."""
    runs = {k: runs[k] for k in ("baseline", "fce")}
    out_j = JF.produce_all(runs, tmp_path / "fj", scale="s")
    names_j = [Path(p).name for p in out_j]
    for run in runs.values():
        (Path(run) / "results.png").unlink()
    out_p = PF.produce_all(runs, tmp_path / "fp", scale="s")
    assert [Path(p).name for p in out_p] == names_j
    assert all(Path(p).exists() for p in out_p)
    panels = [("(a) curves", out_p[0]), ("(b) bars", out_p[1])]
    for vertical in (False, True):
        JF.compose_panels(panels, tmp_path / "cj.png", fig_title="Figure 1", vertical=vertical)
        PF.compose_panels(panels, tmp_path / "cp.png", fig_title="Figure 1", vertical=vertical, device="cpu")
        ref, got = cv2.imread(str(tmp_path / "cj.png")), cv2.imread(str(tmp_path / "cp.png"))
        assert ref.shape == got.shape
        first = cv2.imread(out_p[0])
        y, x = (12 + 50 + 40, 12) if vertical else (50 + 40 + 12, 12)
        assert np.array_equal(got[y:y + first.shape[0], x:x + first.shape[1]], first)
        assert np.array_equal(ref[y:y + first.shape[0], x:x + first.shape[1]], first)
        assert (got[:y] < 128).any()  # the titles are drawn


def test_visualize_image_annotations(tmp_path):
    """cv2's rectangles and Hershey text against ``utils/draw.py``'s: equal
    outside the label tabs, and the tabs' text within the drawing tests' bound."""
    img = np.full((120, 160, 3), 200, np.uint8)
    cv2.imwrite(str(tmp_path / "im.png"), img)
    (tmp_path / "im.txt").write_text("0 0.5 0.5 0.4 0.5\n1 0.3 0.7 0.2 0.2\n")
    a = JP.visualize_image_annotations(tmp_path / "im.png", tmp_path / "im.txt", {0: "cat"}, tmp_path / "j.png")
    b = PP.visualize_image_annotations(tmp_path / "im.png", tmp_path / "im.txt", {0: "cat"}, tmp_path / "p.png",
                                       device="cpu")
    ref, got = cv2.imread(a), cv2.imread(b)
    assert ref.shape == got.shape
    text_rows = np.zeros(ref.shape[:2], bool)
    for xc, yc, bw, bh in ((0.5, 0.5, 0.4, 0.5), (0.3, 0.7, 0.2, 0.2)):
        x1, y1 = int((xc - bw / 2) * 160), int((yc - bh / 2) * 120)
        text_rows[max(y1 - 20, 0):y1 + 1, x1:x1 + 40] = True
    assert np.array_equal(ref[~text_rows], got[~text_rows])
    assert (np.abs(ref.astype(int) - got.astype(int)).max(2)[text_rows] > 64).mean() <= 0.65


def test_det_metrics_curves_equal_jax():
    """``DetMetrics.curves`` and ``all_ap`` bit-equal to the JAX DetMetrics on
    the same match statistics."""
    rng = np.random.default_rng(5)
    jm, pm = JM.DetMetrics(names=NAMES3), PM.DetMetrics(names=NAMES3)
    for _ in range(6):
        d, g = rng.integers(1, 30), rng.integers(1, 8)
        stat = dict(tp=rng.random((d, 10)) < 0.5, conf=rng.random(d), pred_cls=rng.integers(0, 3, d).astype(float),
                    target_cls=rng.integers(0, 3, g).astype(float))
        stat["target_img"] = np.unique(stat["target_cls"])
        jm.update_stats(stat)
        pm.update_stats(stat)
    jm.process(nc=3)
    pm.process(nc=3)
    assert set(jm.curves) == set(pm.curves)
    for k in jm.curves:
        assert np.array_equal(jm.curves[k], pm.curves[k])
    assert np.array_equal(jm.all_ap, pm.all_ap)


def test_figures_need_neither_matplotlib_nor_pil(tmp_path, runs):
    """Every figure function imports and runs with matplotlib, PIL, cv2 and
    the JAX package blocked, as on the card machine; ``produce_report``
    skips nothing."""
    one = tmp_path / "one" / "mine"
    one.mkdir(parents=True)
    (one / "results.csv").write_text((Path(runs["fce"]) / "results.csv").read_text())
    code = textwrap.dedent("""
        import csv, sys
        from pathlib import Path
        for m in ("matplotlib", "PIL", "cv2", "jax", "jaxlib", "flax", "fce_yolo_tpu"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(1)  # one thread, as in the test workers
        import numpy as np
        import fce_yolo_tpu_torch.experiments.figures as F
        import fce_yolo_tpu_torch.utils.annotator as A
        import fce_yolo_tpu_torch.utils.plotting as P
        from fce_yolo_tpu_torch.utils.patches import imwrite
        out, runs = Path(sys.argv[1]), {p.name: p for p in Path(sys.argv[2]).iterdir()}
        rng = np.random.default_rng(0)
        px, py, ap = np.linspace(0, 1, 1000), np.sort(rng.random((2, 1000)), 1)[:, ::-1], rng.random((2, 10))
        names = {0: "a", 1: "b"}
        P.plot_pr_curve(px, py, ap, names, out / "pr.png")
        P.plot_mc_curve(px, py, names, out / "f1.png")
        P.plot_confusion_matrix(rng.random((3, 3)), names, out / "cm.png")
        P.plot_labels(rng.integers(0, 2, 9), rng.random((9, 4)), names, out / "labels.png")
        P.feature_visualization(rng.random((1, 3, 8, 8)), "m.Conv", 0, save_dir=out)
        with open(out / "tune_results.csv", "w", newline="") as f:
            csv.writer(f).writerows([["i", "fitness", "lr0"], [0, 0.5, 0.01], [1, 0.6, 0.02]])
        P.plot_tune_results(out / "tune_results.csv")
        with open(out / "tune2.csv", "w", newline="") as f:
            csv.writer(f).writerows([["fitness", "lr0"], [0.5, 0.01], [0.6, 0.02]])
        A.plot_tune_results(out / "tune2.csv")
        imwrite(out / "im.png", np.full((40, 50, 3), 90, np.uint8), device="cpu")
        (out / "im.txt").write_text("0 0.5 0.5 0.5 0.5\\n")
        P.visualize_image_annotations(out / "im.png", out / "im.txt", names, device="cpu")
        rep = F.produce_report(runs, out / "report", langs=("en", "cn"), scale="n", imgsz=64, verbose=False)
        assert rep["skipped"] == {}, rep["skipped"]
        figs = F.produce_all(runs, out / "all", scale="n")
        F.compose_panels([("a", figs[0]), ("b", figs[1])], out / "composed.png", fig_title="t", device="cpu")
        print("ok", len(rep["written"]), len(figs))
    """)
    res = subprocess.run([sys.executable, "-W", "ignore", "-c", code, str(tmp_path), str(one.parent)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok 6 3"
    for f in ("pr.png", "f1.png", "cm.png", "labels.png", "tune_scatter_plots.png", "tune_fitness.png",
              "stage0_Conv_features.png", "im_annotated.jpg", "composed.png", "report/metric_panels_cn.png"):
        assert cv2.imread(str(tmp_path / f)) is not None, f
