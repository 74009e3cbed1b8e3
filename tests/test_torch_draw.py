"""Drawing without cv2 (``utils/draw.py``), the port's ``Annotator``,
``plot_images``, ``save_one_box`` and ``Results.plot``/``save_txt``/
``save_crop`` against cv2 5.0 and the JAX package (which draws with cv2).

Tolerance, bit-equal: ``LINE_8`` lines, rectangles, polylines and circles at
every thickness (filled too), filled rectangles, ``add_weighted`` and
``get_text_size`` (at the tabulated sizes, on random strings); ``save_txt``
byte for byte and ``save_crop``'s files byte for byte (the writer is
cv2's); the arrays that ``Results.plot``, the ``Annotator`` and
``plot_images`` draw, outside the text and the anti-aliased strokes.

Bounded, where cv2 5.0 differs in kind (its anti-aliasing filter tables and
its TrueType glyphs are not reproduced; see ``utils/draw.py``):

- ``LINE_AA`` strokes and fills: every differing pixel lies in the shape's
  box widened by the thickness + 2 px; there, at most ``AA_SHARE`` (65 %)
  of the pixels differ (by up to 255 levels: an edge pixel's blend of a
  colour and a background that differ by that much);
- text: every differing pixel lies in the text's box (``get_text_size``'s
  width, height and baseline) widened by 2 px; there at most
  ``TEXT_SHARE`` (45 %) differ, by up to 255 levels (a glyph pixel
  against background);
- the drawn annotations: every differing pixel lies in a label's tab or
  text box or on an anti-aliased box outline (the outline's band of
  ``lw + 2`` px); at most ``DRAWN_SHARE`` (65 %) of those pixels differ;
- ``resize_linear_f32`` (``Annotator.masks``' INTER_LINEAR on float32):
  within 1e-5 of cv2's values, and the masks thresholded at 0.5 equal.
"""

import cv2
import numpy as np
import pytest

import fce_yolo_tpu.engine.results as JR
import fce_yolo_tpu.utils.annotator as JA
import fce_yolo_tpu_torch.engine.results as PR
import fce_yolo_tpu_torch.utils.annotator as PA
from fce_yolo_tpu_torch.data.augment import resize_linear_f32
from fce_yolo_tpu_torch.utils import draw as D

AA_SHARE = 0.65
TEXT_SHARE = 0.45
DRAWN_SHARE = 0.65
CHARS = [chr(c) for c in range(32, 127)]


def diff_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return d.max(-1) if d.ndim == 3 else d


def region_mask(shape, boxes) -> np.ndarray:
    """The union of inclusive boxes (x1, y1, x2, y2), clipped to the image."""
    m = np.zeros(shape[:2], bool)
    for x1, y1, x2, y2 in boxes:
        xa, xb = sorted((int(x1), int(x2)))
        ya, yb = sorted((int(y1), int(y2)))
        m[max(ya, 0): max(yb + 1, 0), max(xa, 0): max(xb + 1, 0)] = True
    return m


def assert_bounded(a, b, boxes, share: float, max_diff: int = 255) -> tuple[float, int]:
    """Equal outside ``boxes``; inside, at most ``share`` of the pixels differ, each by at most ``max_diff``."""
    d = diff_map(a, b)
    inside = region_mask(a.shape, boxes)
    assert not d[~inside].any(), f"{int((d[~inside] > 0).sum())} pixels differ outside the allowed boxes"
    s = float((d[inside] > 0).mean()) if inside.any() else 0.0
    assert s <= share and int(d.max(initial=0)) <= max_diff, (s, int(d.max(initial=0)))
    return s, int(d.max(initial=0))


def _pts(rng, k=2):
    return [(int(rng.randint(-20, 100)), int(rng.randint(-20, 80))) for _ in range(k)]


def _color(rng):
    return tuple(int(v) for v in rng.randint(0, 256, 3))


def _shape_case(kind: str, thickness: int, line_type: int, rng):
    """(cv2 call, port call, the shape's box) for one random shape."""
    c = _color(rng)
    if kind == "rectangle":
        p, q = _pts(rng)
        return (lambda im: cv2.rectangle(im, p, q, c, thickness, line_type),
                lambda im: D.rectangle(im, p, q, c, thickness, line_type), (*p, *q))
    if kind == "line":
        p, q = _pts(rng)
        return (lambda im: cv2.line(im, p, q, c, thickness, line_type),
                lambda im: D.line(im, p, q, c, thickness, line_type), (*p, *q))
    if kind == "polylines":
        poly = np.array(_pts(rng, 4), np.int32)
        return (lambda im: cv2.polylines(im, [poly], True, c, thickness, line_type),
                lambda im: D.polylines(im, [poly], True, c, thickness, line_type), (*poly.min(0), *poly.max(0)))
    (x, y), r = _pts(rng, 1)[0], int(rng.randint(0, 25))
    return (lambda im: cv2.circle(im, (x, y), r, c, thickness, line_type),
            lambda im: D.circle(im, (x, y), r, c, thickness, line_type), (x - r, y - r, x + r, y + r))


def _draw_both(case, rng):
    img = rng.randint(0, 256, (60, 80, 3), np.uint8)
    a, b = img.copy(), img.copy()
    case[0](a)
    case[1](b)
    return a, b


@pytest.mark.parametrize("kind,thickness", [("rectangle", t) for t in (1, 2, 3, 4, 5, -1)]
                         + [("line", t) for t in (1, 2, 3, 4)] + [("polylines", t) for t in (1, 2, 3)]
                         + [("circle", t) for t in (-1, 1, 2, 3)])
def test_line8_shapes_equal_cv2(kind, thickness):
    """Random shapes, half of them leaving the image (clipped as cv2 clips)."""
    rng = np.random.RandomState(thickness + 10 * len(kind))
    for _ in range(150):
        a, b = _draw_both(_shape_case(kind, thickness, D.LINE_8, rng), rng)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind,thickness", [("rectangle", t) for t in (1, 2, 3, -1)]
                         + [("line", t) for t in (1, 2, 3)] + [("polylines", t) for t in (1, 2)]
                         + [("circle", t) for t in (-1, 1, 2)])
def test_aa_shapes_within_bound(kind, thickness):
    rng = np.random.RandomState(thickness + 10 * len(kind) + 1)
    for _ in range(100):
        case = _shape_case(kind, thickness, D.LINE_AA, rng)
        a, b = _draw_both(case, rng)
        x1, y1, x2, y2 = case[2]
        m = max(thickness, 1) + 2
        assert_bounded(a, b, [(min(x1, x2) - m, min(y1, y2) - m, max(x1, x2) + m, max(y1, y2) + m)], AA_SHARE)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (31, 17), (720, 1280, 3)])
def test_add_weighted_equals_cv2(shape):
    rng = np.random.RandomState(shape[0])
    a, b = rng.randint(0, 256, shape, np.uint8), rng.randint(0, 256, shape, np.uint8)
    for alpha, beta, gamma in ((0.6, 0.4, 0), (0.5, 0.5, 0), (0.3, 0.9, 7.5)):
        np.testing.assert_array_equal(D.add_weighted(a, alpha, b, beta, gamma), cv2.addWeighted(a, alpha, b, beta, gamma))


SIZES = [(0.5, 1)] + [(lw / 3, max(lw - 1, 1)) for lw in range(1, 10)] + [(1 / 3, 2), (2 / 3, 2), (0.5, 2)]


@pytest.mark.parametrize("scale,thickness", SIZES)
def test_text_size_equals_cv2(scale, thickness):
    """At the sizes the labels use: Results.plot's 0.5, the Annotator's lw / 3 with thickness max(lw - 1, 1)."""
    rng = np.random.RandomState(int(scale * 300) + thickness)
    for n in [0, 1] + list(rng.randint(2, 30, 60)):
        s = "".join(rng.choice(CHARS, n))
        assert D.get_text_size(s, 0, scale, thickness) == cv2.getTextSize(s, 0, scale, thickness), repr(s)


def test_text_metric_table_rederived_from_cv2():
    """``_METRICS`` is cv2's: each size's advances (the width step of a
    repeated character) and descents (a lone character's baseline)."""
    for (size, bold), (adv, desc) in D._METRICS.items():
        scale, t = size * 0.037, 2 if bold else 1
        assert cv2.getTextSize("A", 0, scale, t)[0][1] == size
        for i, c in enumerate(CHARS):
            w4, w8 = cv2.getTextSize(c * 4, 0, scale, t)[0][0], cv2.getTextSize(c * 8, 0, scale, t)[0][0]
            assert (w8 - w4) // 4 == adv[i] and cv2.getTextSize(c, 0, scale, t)[1] == desc[i], (size, bold, c)


@pytest.mark.parametrize("scale,thickness,line_type", [(0.5, 1, D.LINE_8), (1 / 3, 1, D.LINE_AA),
                                                       (2 / 3, 1, D.LINE_AA), (1.0, 2, D.LINE_AA)])
def test_put_text_within_bound(scale, thickness, line_type):
    rng = np.random.RandomState(int(scale * 30) + line_type)
    for _ in range(30):
        s = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789 .ABCXYZ"), rng.randint(1, 14)))
        img = np.full((90, 320, 3), 90, np.uint8)
        a, b = img.copy(), img.copy()
        org, color = (5, 55), _color(rng)
        cv2.putText(a, s, org, 0, scale, color, thickness, line_type)
        D.put_text(b, s, org, 0, scale, color, thickness, line_type)
        (tw, th), base = cv2.getTextSize(s, 0, scale, thickness)
        assert_bounded(a, b, [(org[0] - 2, org[1] - th - 2, org[0] + tw + 2, org[1] + base + 2)], TEXT_SHARE)
        assert (diff_map(b, img) > 0).any()  # something is drawn


def test_resize_linear_f32_within_bound():
    rng = np.random.RandomState(0)
    for _ in range(60):
        (sh, sw), (h, w) = rng.randint(2, 60, 2), rng.randint(2, 120, 2)
        for x in (rng.rand(sh, sw).astype(np.float32), (rng.rand(sh, sw) < 0.5).astype(np.float32)):
            out, ref = resize_linear_f32(x, (int(w), int(h))), cv2.resize(x, (int(w), int(h)))
            assert out.dtype == np.float32 and out.shape == ref.shape
            assert float(np.abs(out - ref).max()) <= 1e-5
            near = np.abs(ref - 0.5) <= 1e-5
            np.testing.assert_array_equal((out > 0.5)[~near], (ref > 0.5)[~near])


def _label_boxes(p1, label, sf, tf):
    """The label tab's box and its text's, as box_label places them."""
    (w, h), base = cv2.getTextSize(label, 0, sf, tf)
    h += 3
    outside = p1[1] >= h
    p2 = (p1[0] + w, p1[1] - h if outside else p1[1] + h)
    ty = p1[1] - 2 if outside else p1[1] + h - 1
    return [(p1[0] - 2, min(p1[1], p2[1]) - 2, p2[0] + 2, max(p1[1], p2[1]) + 2),
            (p1[0] - 2, ty - h - 2, p1[0] + w + 2, ty + base + 2)]


def _box_band(x1, y1, x2, y2, lw):
    m = lw + 2
    return [(x1 - m, y1 - m, x2 + m, y1 + m), (x1 - m, y2 - m, x2 + m, y2 + m), (x1 - m, y1 - m, x1 + m, y2 + m),
            (x2 - m, y1 - m, x2 + m, y2 + m)]


def test_annotator_matches_jax():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 200, (240, 320, 3), np.uint8)
    a, b = img.copy(), img.copy()
    ja, pa = JA.Annotator(a), PA.Annotator(b, device="cpu")
    assert (ja.lw, ja.sf, ja.tf) == (pa.lw, pa.sf, pa.tf)
    boxes = []
    for i, (box, label) in enumerate([((30, 40, 120, 150), "person 0.91"), ((150, 2, 300, 80), "car"),
                                      ((200, 120, 310, 230), "")]):
        for ann in (ja, pa):
            ann.box_label(box, label, JA.colors(i, bgr=True))
        boxes += _box_band(*box, pa.lw) + (_label_boxes(box[:2], label, pa.sf, pa.tf) if label else [])
    for ann in (ja, pa):
        ann.rectangle((10, 170, 60, 220), fill=(0, 255, 0), outline=(255, 0, 0), width=2)
        ann.text((70, 200), "text 1", box_color=(10, 10, 10))
        ann.circle_label((240, 140, 280, 180), "7", (0, 0, 255))
    (tw, th), base = cv2.getTextSize("text 1", 0, pa.sf, pa.tf)
    boxes += [(68, 200 - th - 5, 70 + tw + 2, 200 + base + 5)]
    (cw, ch), _ = cv2.getTextSize("7", 0, pa.sf, pa.tf)
    boxes += [(260 - cw // 2 - 3, 160 - ch, 260 + cw, 160 + ch + 3)]
    assert_bounded(ja.result(), pa.result(), boxes, DRAWN_SHARE)


def test_annotator_masks_and_keypoints_match_jax():
    rng = np.random.RandomState(6)
    img = rng.randint(0, 200, (120, 160, 3), np.uint8)
    masks = rng.rand(2, 30, 40) < 0.5  # resized to the image (INTER_LINEAR on float32)
    full = np.zeros((1, 120, 160), bool)
    full[0, 20:60, 30:90] = True
    ja, pa = JA.Annotator(img.copy()), PA.Annotator(img.copy(), device="cpu")
    for ann in (ja, pa):
        ann.masks(masks, [(255, 0, 0), (0, 255, 0)])
        ann.masks(full, [(0, 0, 255)], alpha=0.3)
    np.testing.assert_array_equal(pa.result(), ja.result())
    kpts = np.concatenate([rng.rand(17, 2) * [150, 110], rng.rand(17, 1)], 1).astype(np.float32)
    for ann in (ja, pa):
        ann.kpts(kpts)
    boxes = [(k[0] - pa.lw - 3, k[1] - pa.lw - 3, k[0] + pa.lw + 3, k[1] + pa.lw + 3) for k in kpts]
    from fce_yolo_tpu_torch.utils.annotator import SKELETON
    for s, e in SKELETON:
        (x1, y1), (x2, y2) = kpts[s - 1, :2], kpts[e - 1, :2]
        boxes.append((min(x1, x2) - 4, min(y1, y2) - 4, max(x1, x2) + 4, max(y1, y2) + 4))
    assert_bounded(ja.result(), pa.result(), boxes, 1.0)  # keypoints and limbs are anti-aliased throughout


def _batch(rng, b=5, h=96, w=128, m=4):
    img = rng.randint(0, 255, (b, h, w, 3), np.uint8)
    cls = rng.randint(0, 3, (b, m)).astype(np.float32)
    xy, wh = rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2))
    mask = rng.rand(b, m) < 0.7
    return {"img": img, "cls": cls, "bboxes": np.concatenate([xy, wh], -1).astype(np.float32), "mask": mask}


def test_plot_images_matches_jax(tmp_path, monkeypatch):
    """The mosaic array before encoding, and the file: byte-equal to cv2's encode of the port's array."""
    batch = _batch(np.random.RandomState(7))
    names = {0: "circle", 1: "square", 2: "tri"}
    drawn = {}
    real_imwrite = cv2.imwrite
    monkeypatch.setattr(JA.cv2, "imwrite", lambda f, im, *a: drawn.setdefault("jax", im.copy()) is not None)
    JA.plot_images(batch, names=names, fname=tmp_path / "jax.jpg")
    monkeypatch.setattr(JA.cv2, "imwrite", real_imwrite)
    out = PA.plot_images(batch, names=names, fname=tmp_path / "port.jpg", device="cpu")
    assert out == str(tmp_path / "port.jpg")
    port = cv2.imread(out)
    ref = drawn["jax"]
    assert port.shape == ref.shape == (3 * 96, 3 * 128, 3)
    # the port's own array: re-draw it through the plain path without encoding
    arr = {}
    monkeypatch.setattr(PA, "imwrite", lambda f, im, device="cuda": arr.setdefault("port", im.copy()) is not None)
    PA.plot_images(batch, names=names, fname=tmp_path / "again.jpg", device="cpu")
    assert (tmp_path / "port.jpg").read_bytes() == cv2.imencode(".jpg", arr["port"])[1].tobytes()
    lw = max(1, round(96 / 320))
    boxes = []
    for i in range(len(batch["img"])):
        oy, ox = (i // 3) * 96, (i % 3) * 128
        for j in range(int(batch["mask"][i].sum())):  # the first rows, as plot_images counts them
            cx, cy, bw, bh = batch["bboxes"][i, j]
            x1, y1, x2, y2 = ox + (cx - bw / 2) * 128, oy + (cy - bh / 2) * 96, ox + (cx + bw / 2) * 128, oy + (cy + bh / 2) * 96
            boxes += _box_band(int(x1), int(y1), int(x2), int(y2), lw)
            boxes += _label_boxes((int(x1), int(y1)), names[int(batch["cls"][i, j])], lw / 3, max(lw - 1, 1))
    assert_bounded(ref, arr["port"], boxes, DRAWN_SHARE)


def test_save_one_box_matches_jax(tmp_path):
    img = np.random.RandomState(8).randint(0, 256, (100, 140, 3), np.uint8)
    for xyxy, square in (((10.3, 20.7, 60.2, 90.9), False), ((100, 5, 139, 40), True), ((-5, -5, 20, 20), False)):
        ref = JA.save_one_box(xyxy, img, file=tmp_path / "j.jpg", square=square)
        out = PA.save_one_box(xyxy, img, file=tmp_path / "p.jpg", square=square, device="cpu")
        np.testing.assert_array_equal(out, ref)
        assert (tmp_path / "p.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()


def _results(kind: str):
    rng = np.random.RandomState(9)
    h, w = 120, 180
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    names = {0: "person", 1: "car", 2: "dog"}
    n = 4
    xy, wh = rng.rand(n, 2) * [w, h], rng.rand(n, 2) * 60 + 8
    conf, cls = rng.rand(n, 1), rng.randint(0, 3, (n, 1))
    kw = {}
    if kind == "obb":
        kw["obb"] = np.concatenate([xy, wh, rng.uniform(-1, 1, (n, 1)), conf, cls], 1).astype(np.float32)
    else:
        kw["boxes"] = np.concatenate([xy - wh / 2, xy + wh / 2, conf, cls], 1).astype(np.float32)
    if kind == "segment":
        m = np.zeros((n, h, w), bool)
        for i in range(n):
            cv2.ellipse(m[i].view(np.uint8), (int(xy[i, 0]), int(xy[i, 1])), (int(wh[i, 0] / 2), int(wh[i, 1] / 3)),
                        0, 0, 360, 1, -1)
        kw["masks"] = m
    if kind == "pose":
        kw["keypoints"] = np.concatenate([rng.rand(n, 17, 2) * [w, h], rng.rand(n, 17, 1)], -1).astype(np.float32)
    return img, names, kw


def _plot_text_boxes(res, font_scale: float = 0.5):
    """Where Results.plot writes text: a label above each box (or each rotated box's corner)."""
    boxes = []
    if res.obb is not None:
        for poly, row in zip(res.obb.xyxyxyxy, res.obb.data):
            x1, y1 = poly.min(0)
            label = f"{res.names.get(int(row[6]), int(row[6]))} {row[5]:.2f}"
            (tw, th), base = cv2.getTextSize(label, 0, font_scale, 1)
            boxes.append((int(x1) - 2, int(y1) - 2 - th - 2, int(x1) + tw + 2, int(y1) - 2 + base + 2))
        return boxes
    for x1, y1, x2, y2, conf, c in res.boxes.data:
        label = f"{res.names.get(int(c), int(c))} {conf:.2f}"
        (tw, th), base = cv2.getTextSize(label, 0, font_scale, 1)
        boxes.append((int(x1) - 2, int(y1) - th - 6, int(x1) + tw + 2, int(y1) - 2 + base + 2))
    return boxes


@pytest.mark.parametrize("kind", ["detect", "segment", "pose", "obb"])
def test_results_plot_matches_jax(kind):
    """Boxes, masks blended by add_weighted, keypoint discs and rotated boxes
    bit-equal; the labels' text within the text bound."""
    img, names, kw = _results(kind)
    ref = JR.Results(img, "x", names, **kw)
    out = PR.Results(img, "x", names, **kw, device="cpu")
    for line_width in (None, 3):
        a, b = ref.plot(line_width=line_width), out.plot(line_width=line_width)
        assert_bounded(a, b, _plot_text_boxes(out), TEXT_SHARE)


@pytest.mark.parametrize("kind", ["detect", "obb"])
def test_save_txt_and_save_crop_match_jax(kind, tmp_path):
    img, names, kw = _results(kind)
    ref = JR.Results(img, "x", names, **kw)
    out = PR.Results(img, "x", names, **kw, device="cpu")
    for conf in (False, True):
        ref.save_txt(str(tmp_path / "j.txt"), save_conf=conf)
        out.save_txt(str(tmp_path / "p.txt"), save_conf=conf)
        assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    ref.save_crop(str(tmp_path / "jc"), "im.jpg")
    out.save_crop(str(tmp_path / "pc"), "im.jpg")
    files = sorted(p.relative_to(tmp_path / "jc") for p in (tmp_path / "jc").rglob("*.jpg"))
    assert files and files == sorted(p.relative_to(tmp_path / "pc") for p in (tmp_path / "pc").rglob("*.jpg"))
    for f in files:
        assert (tmp_path / "pc" / f).read_bytes() == (tmp_path / "jc" / f).read_bytes()


def test_results_save_writes_the_plot(tmp_path):
    img, names, kw = _results("segment")
    out = PR.Results(img, "x", names, **kw, device="cpu")
    assert out.save(str(tmp_path / "a.jpg")) == str(tmp_path / "a.jpg")
    assert (tmp_path / "a.jpg").read_bytes() == cv2.imencode(".jpg", out.plot())[1].tobytes()
    out.save(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), out.plot())
