"""The chart renderer (``utils/chart.py``) against matplotlib 3.10's rules,
piece by piece, on seeded inputs: text extents, colormaps, tick locations
and labels, autoscaled limits, the legend's ``loc="best"`` choice and the
PNG's pixel size. Each is held equal (floats to 1e-9 relative); whole
figures are held against the JAX package's in ``test_torch_plotting.py``.
"""

import matplotlib
import numpy as np
import pytest
from matplotlib.backends.backend_agg import FigureCanvasAgg
from matplotlib.figure import Figure
from matplotlib.ticker import AutoLocator, ScalarFormatter

from fce_yolo_tpu_torch.utils import chart

matplotlib.use("Agg")


def MplFigure(**kw) -> Figure:
    fig = Figure(**kw)
    FigureCanvasAgg(fig)
    return fig


# the strings, sizes and resolutions the figures draw with
STRINGS = ["0.0", "0.25", "1.00", "−0.5", "12", "Recall", "Precision", "mAP@50-95 (%)", "all classes 0.512 mAP@0.5",
           "metrics/mAP50-95(B)", "train/box_loss", "YOLOv11S-FCE(WIoU)", "background", "Ty,WA. lp", "lr0 = 0.00123"]
SIZES = [6, 7, 8, 9, 10, 12, 13, 15]


@pytest.mark.parametrize("dpi", [100, 120, 150])
@pytest.mark.parametrize("weight", ["normal", "bold"])
def test_text_extent_equals_matplotlib(dpi, weight):
    """Width and height of ``Text.get_window_extent``, one line and several,
    level and rotated."""
    fig = MplFigure(dpi=dpi)
    renderer = fig.canvas.get_renderer()
    for size in SIZES:
        for s in STRINGS + ["71.13\n(+3.03)"]:
            for rotation, ha, va in ((0, "left", "baseline"), (90, "center", "top"), (15, "right", "center_baseline")):
                t = fig.text(0, 0, s, fontsize=size, fontweight=weight, rotation=rotation, ha=ha, va=va)
                ref = t.get_window_extent(renderer)
                got = chart.Text(0, 0, s, fontsize=size, fontweight=weight, rotation=rotation, ha=ha, va=va,
                                 coords="display").layout(dpi)[0]
                np.testing.assert_allclose([got.x0, got.y0, got.width, got.height],
                                           [ref.x0, ref.y0, ref.width, ref.height], rtol=1e-9, atol=1e-9)
                t.remove()


def test_text_extent_off_the_table_raises():
    """Text is laid out only at the table's sizes and dpis (matplotlib's
    hinted metrics); any other raises and names where to add it."""
    from fce_yolo_tpu_torch.utils.fonts.make_table import DPIS, SIZES

    assert chart.text_extent("ab", SIZES[0], "normal", DPIS[0])[0] > 0
    with pytest.raises(ValueError, match="SIZES"):
        chart.text_extent("ab", 10.5, "normal", 100)
    with pytest.raises(ValueError, match="DPIS"):
        chart.Text(0, 0, "ab", fontsize=10, coords="display").layout(96)


@pytest.mark.parametrize("name", ["Blues", "viridis", "gray"])
def test_colormaps_equal_matplotlib(name):
    x = np.concatenate([np.linspace(0, 1, 2049), [-0.1, 1.2, np.nan]])
    ref = matplotlib.colormaps[name](x)
    assert np.array_equal(chart.colormap(name, x), ref)
    assert np.array_equal(chart.colormap(name, x, bytes=True), matplotlib.colormaps[name](x, bytes=True))


def test_colors_equal_matplotlib():
    from matplotlib.colors import to_rgba

    for c in ["blue", "grey", "k", "white", "#0BDBEB", "#888888", "0.8", "C3", (0.1, 0.2, 0.3), "none"]:
        assert chart.to_rgba(c) == to_rgba(c)
        assert chart.to_rgba(c, 0.4) == to_rgba(c, 0.4)
    with pytest.raises(ValueError, match="unknown colour"):
        chart.to_rgba("papayawhip")


def _mpl_axes(figsize=(6.4, 4.8)):
    fig = MplFigure(figsize=figsize)
    return fig, fig.subplots()


def test_ticks_and_labels_equal_matplotlib():
    """``AutoLocator`` positions and ``ScalarFormatter`` labels and offset
    text over seeded data ranges (offsets, orders of magnitude, negatives)."""
    rng = np.random.default_rng(0)
    spans = [(0, 1), (-3, 7), (1000.01, 1000.05), (2e-7, 9e-7), (0, 3.3e7), (-0.004, -0.001), (5, 5)]
    spans += [tuple(sorted(rng.normal(0, 10.0 ** int(rng.integers(-4, 5)), 2))) for _ in range(30)]
    for figsize in ((6.4, 4.8), (3.2, 3.0)):
        for lo, hi in spans:
            fm, am = _mpl_axes(figsize)
            am.plot([lo, hi], [hi, lo])
            fp = chart.Figure(figsize)
            ap = fp.subplots()
            ap.plot([lo, hi], [hi, lo])
            fm.canvas.draw()
            for axm, axp, lim_m, lim_p in ((am.xaxis, ap.xaxis, am.get_xlim(), ap.get_xlim()),
                                           (am.yaxis, ap.yaxis, am.get_ylim(), ap.get_ylim())):
                np.testing.assert_allclose(lim_p, lim_m, rtol=1e-9)
                assert np.array_equal(axp.locs(), axm.get_majorticklocs())
                assert axp.ticklabels() == [t.get_text() for t in axm.get_majorticklabels()]
                assert axp.offset_text() == axm.get_offset_text().get_text()


def test_auto_ticks_equal_max_n_locator():
    rng = np.random.default_rng(1)
    loc = AutoLocator()
    for _ in range(200):
        lo, hi = sorted(rng.normal(0, 10.0 ** int(rng.integers(-6, 8)), 2))
        nbins = int(rng.integers(1, 10))
        loc.set_params(nbins=nbins)
        assert np.array_equal(chart.auto_ticks(lo, hi, nbins), loc.tick_values(lo, hi))
    f = ScalarFormatter()  # the offset-format helper
    for v in (1000.0, -0.0025, 3.5e7, 1.25e-6):
        assert chart.ScalarFormatter._format_data(v) == f.format_data(v)


@pytest.mark.parametrize("corner", ["upper right", "upper left", "lower left", "lower right", "center"])
def test_legend_best_location_equals_matplotlib(corner):
    """Data crowding one corner pushes the legend to the same place."""
    rng = np.random.default_rng(2)
    x = np.linspace(0, 1, 200)
    ys = {"upper right": x ** 4, "upper left": (1 - x) ** 4, "lower left": 1 - (1 - x) ** 4,
          "lower right": 1 - x ** 4, "center": 0.5 + 0.5 * np.sin(12 * x)}[corner]
    figs = []
    for mod in ("mpl", "port"):
        fig = MplFigure() if mod == "mpl" else chart.Figure()
        ax = fig.subplots()
        ax.plot(x, ys, label="first line")
        ax.plot(x, ys * 0.9 + 0.05 * rng.random(200), label="second")
        ax.scatter(rng.random(20), rng.random(20), s=4)
        ax.legend(fontsize=8)
        figs.append((fig, ax))
    (fm, am), (fp, ap) = figs
    fm.canvas.draw()
    np.testing.assert_allclose(ap.get_legend().position(100.0).bounds, am.get_legend().get_window_extent().bounds,
                               rtol=1e-9)


def test_png_pixel_size_as_matplotlib_rounds(tmp_path):
    for figsize, dpi in (((9, 6), 150), ((3.2 * 3, 3.0 * 2), 120), ((6.4, 4.0), 120), ((7, 4.5), 150),
                         ((4 * 3, 3 * 3), 120), ((14, 10), 150)):
        fm = MplFigure(figsize=figsize)
        fm.subplots()
        fm.savefig(tmp_path / "m.png", dpi=dpi)
        fp = chart.Figure(figsize)
        fp.subplots()
        fp.savefig(tmp_path / "p.png", dpi=dpi)
        import cv2

        assert cv2.imread(str(tmp_path / "m.png")).shape == cv2.imread(str(tmp_path / "p.png")).shape
        assert fp.pixel_size(dpi) == cv2.imread(str(tmp_path / "p.png")).shape[1::-1]


def test_only_png_and_the_supported_subset():
    fig = chart.Figure()
    ax = fig.subplots()
    with pytest.raises(ValueError, match="PNG"):
        fig.savefig("x.jpg")
    with pytest.raises(ValueError, match="not supported"):
        ax.axis("tight")  # "equal" is supported since the analytics charts use it
    with pytest.raises(ValueError, match="not supported"):
        ax.grid(True, linestyle=":")
    with pytest.raises(ValueError, match="unknown colormap"):
        ax.imshow(np.zeros((2, 2)), cmap="jet")
        fig.render()


def test_draw_text_onto_an_image():
    img = np.full((40, 120, 3), 255, np.uint8)
    chart.draw_text(img, (5, 5), "subtitle")
    ys, xs = np.nonzero(img.min(2) < 128)
    assert ys.min() >= 5 and xs.min() >= 5 and ys.max() < 5 + 14 and xs.max() < 5 + 60
