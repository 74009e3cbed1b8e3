"""The plots of the port's ``YOLO.val(plots_dir=...)`` and ``YOLO.train(plots=...)``
against the JAX facade's, on the tiny dataset's PNG copy with
``test_torch_val.py``'s bridged yolo11n-fce weights at 160 px, batch 3.

Tolerance: the two validation mosaics (``val_batch0_labels.jpg``,
``val_batch0_pred.jpg``) are compared as the arrays each side hands its
image writer: equal outside the labels' tabs, their text and the
anti-aliased box outlines (the band of ``lw + 2`` px), and there at most
``DRAWN_SHARE`` (``test_torch_draw.py``, 65 %) of the pixels differ; the
port's files are its writer's encode of its arrays (byte-equal to cv2's).
The six figures written after the metrics (``confusion_matrix.png``,
``confusion_matrix_normalized.png``, ``PR_curve.png``, ``F1_curve.png``,
``P_curve.png``, ``R_curve.png``; drawn by ``utils/chart.py``) have the JAX
files' pixel sizes, and ``DetMetrics.curves`` behind them equals the JAX
validator's bit for bit; the figures themselves are held against
matplotlib's in ``test_torch_plotting.py``. The training mosaics are
counted: the first three batches of the first epoch with ``plots=True``
(the default), none with ``plots=False``; ``results.png`` is written with
the former only.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

import fce_yolo_tpu.utils.annotator as JA
import fce_yolo_tpu_torch.utils.annotator as PA
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.experiments.analysis import load_results
from test_torch_draw import DRAWN_SHARE, _box_band, _label_boxes, assert_bounded
from test_torch_val import png_dataset, variables  # noqa: F401 (fixtures)
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)


def test_val_plots_match_jax(png_dataset, variables, tmp_path, monkeypatch, capsys):  # noqa: F811
    jax_drawn, port_drawn, labels = {}, {}, []
    real_cv2_imwrite, real_imwrite, real_box_label = cv2.imwrite, PA.imwrite, PA.Annotator.box_label

    def jax_imwrite(f, im, *a):
        jax_drawn[Path(f).name] = im.copy()
        return real_cv2_imwrite(f, im, *a)

    def port_imwrite(f, im, quality=95, device="cuda"):
        port_drawn[Path(f).name] = im.copy()
        return real_imwrite(f, im, quality, device)

    def box_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255), rotated=False):
        labels[-1].append((tuple(int(v) for v in box), label, self.lw, self.sf, self.tf))
        return real_box_label(self, box, label, color, txt_color, rotated)

    def plot_images(*a, **kw):  # one list of box labels a mosaic
        labels.append([])
        return real_plot_images(*a, **kw)

    real_plot_images = PA.plot_images
    monkeypatch.setattr(JA.cv2, "imwrite", jax_imwrite)
    jy = JaxYOLO("yolo11n-fce.yaml")
    jy.variables = variables
    jres = jy.val(data=png_dataset, imgsz=160, batch=3, verbose=False, plots_dir=str(tmp_path / "jax"))
    monkeypatch.setattr(JA.cv2, "imwrite", real_cv2_imwrite)

    monkeypatch.setattr(PA, "imwrite", port_imwrite)
    monkeypatch.setattr(PA, "plot_images", plot_images)
    monkeypatch.setattr(PA.Annotator, "box_label", box_label)
    port = YOLO("yolo11n-fce.yaml", device="cpu").load_jax_variables(variables)
    pres = port.val(data=png_dataset, imgsz=160, batch=3, workers=1, verbose=False, plots_dir=str(tmp_path / "port"))
    assert "not yet" not in capsys.readouterr().out
    figures = ("confusion_matrix.png", "confusion_matrix_normalized.png", "PR_curve.png", "F1_curve.png",
               "P_curve.png", "R_curve.png")
    for f in figures:
        assert cv2.imread(str(tmp_path / "port" / f)).shape == cv2.imread(str(tmp_path / "jax" / f)).shape
    jc, pc = jres["metrics"].curves, pres["metrics"].curves
    assert set(jc) == set(pc) and all(np.array_equal(jc[k], pc[k]) for k in jc)
    assert np.array_equal(jres["metrics"].all_ap, pres["metrics"].all_ap)
    names = ("val_batch0_labels.jpg", "val_batch0_pred.jpg")
    assert sorted(port_drawn) == sorted(names) and set(names) <= set(jax_drawn)
    assert len(labels) == 2 and all(labels)
    for name, drawn in zip(names, labels):
        boxes = []
        for (x1, y1, x2, y2), label, lw, sf, tf in drawn:
            boxes += _box_band(x1, y1, x2, y2, lw) + _label_boxes((x1, y1), label, sf, tf)
        assert_bounded(jax_drawn[name], port_drawn[name], boxes, DRAWN_SHARE)
        buf = (tmp_path / "port" / name).read_bytes()
        assert buf == cv2.imencode(".jpg", port_drawn[name])[1].tobytes()


def test_task_validators_take_plots_dir_and_draw_nothing(tiny_seg_dataset, tmp_path):
    """As the JAX task validators (ROADMAP queue 3, item 23)."""
    port = YOLO("yolo11n-seg.yaml", device="cpu", nc=2)
    port.val(data=tiny_seg_dataset, imgsz=64, batch=2, workers=1, verbose=False, plots_dir=str(tmp_path / "p"))
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("plots", [True, False])
def test_train_writes_the_first_three_batches(png_dataset, tmp_path, plots):  # noqa: F811
    """8 train images at batch 2: four steps, the first three drawn (or none),
    and ``results.png`` at the end (or none)."""
    port = YOLO("yolo11n-fce.yaml", device="cpu")
    res = port.train(png_dataset, epochs=1, batch=2, imgsz=64, workers=1, val=False, verbose=False,
                     project=str(tmp_path), name="t", plots=plots)
    written = sorted(p.name for p in Path(res["save_dir"]).glob("train_batch*.jpg"))
    assert written == ([f"train_batch{i}.jpg" for i in range(3)] if plots else [])
    results_png = Path(res["save_dir"]) / "results.png"
    assert results_png.exists() == plots
    if plots:  # a 4 x 3 in panel per numeric column but epoch and time, up to 4 a row, at dpi 120
        row = load_results(res["save_dir"])[0]
        n = sum(k not in ("epoch", "time") and isinstance(v, (int, float)) for k, v in row.items())
        cols = min(4, n)
        assert cv2.imread(str(results_png)).shape == (3 * -(-n // cols) * 120, 4 * cols * 120, 3)
    for f in written:
        img = cv2.imread(str(Path(res["save_dir"]) / f))
        assert img.shape == (2 * 64, 2 * 64, 3)  # a 2 x 2 grid for a batch of 2 (ceil(sqrt(2)) = 2)
