"""The solutions layer of the port (``fce_yolo_tpu_torch/solutions/``, the
``solutions`` CLI mode) against the JAX package's (``fce_yolo_tpu/solutions/``,
``fce_yolo_tpu/cfg/__init__.py:143-190``), on the CPU.

- ``SolutionConfig``'s fields and defaults, its ``ValueError``, and
  ``SolutionResults.__str__``: equal.
- Each ``SolutionAnnotator`` method, and each of the 15 ``BaseSolution``
  apps' ``process`` on the same seeded frames and tracks (a stand-in model:
  names and a device, no network): every result field equal, frame after
  frame (counts, class-wise counts, speeds, slots, workout state, the crops'
  JPEG bytes); ``plot_im`` bit-equal outside the text and the anti-aliased
  strokes, and within ``tests/test_torch_draw.py``'s bound there: every
  differing pixel inside a text's box (``get_text_size``'s extent + 2 px) or
  a ``LINE_AA`` shape's box (+ its thickness + 2 px), recorded by wrapping
  ``utils/draw.py`` while the port draws, and at most ``DRAWN_SHARE`` (65 %)
  of the pixels there differing. Apps that draw only ``LINE_8`` strokes and
  ``add_weighted`` (``ObjectBlurrer``, ``Heatmap`` without a region) are
  held bit for bit.
- ``Analytics``' four chart kinds over frames with 0-4 classes, held against
  matplotlib as ``tests/test_torch_plotting.py`` holds figures
  (``assert_axes_equal`` on the captured figures, ``assert_pixels_close`` on
  the rendered frames).
- The slice as a whole: ``ObjectCounter`` (a line) and ``Heatmap`` (no
  region) through ``__call__`` over 4 frames of a panned scene, yolo11n-fce
  at 128 px on the same weights (the port's seeded init, moved by
  N(0, 0.05), bridged to flax): per frame the same tracks (ids and classes
  equal, boxes within 1e-3 px, scores within 1e-5) and counts; ``plot_im``
  within the bound.
- ``entrypoint(["solutions", ...])`` against the JAX ``handle_solutions`` on
  a JAX ``save`` of the narrow fixture model, ``save_dir=`` written.
- Differences from the JAX package, each stated by a test (ROADMAP queue 3):
  item 39, ``AIGym`` pairs keypoint row i with track row i, as JAX does;
  item 40, ``__call__`` takes ``imgsz=`` (JAX raises ``TypeError``);
  item 41, ``solutions inference ... save_dir=`` runs (the JAX CLI raises
  ``AttributeError`` on the paths ``Inference`` returns).
"""

import dataclasses
import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import fce_yolo_tpu.solutions as JS
import fce_yolo_tpu_torch.solutions as PS
from fce_yolo_tpu.cfg import handle_solutions as jax_handle_solutions
from fce_yolo_tpu.engine.results import Results as JaxResults
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg import SOLUTION_MAP, entrypoint
from fce_yolo_tpu_torch.engine.results import Results
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.utils import chart
from fce_yolo_tpu_torch.utils import draw as D
from test_torch_cli import jax_ckpt, known_strides  # noqa: F401  (the JAX save of the narrow model)
from test_torch_draw import DRAWN_SHARE, assert_bounded
from test_torch_modules import jax_facade
from test_torch_plotting import assert_axes_equal, assert_pixels_close

NAMES = {0: "person", 1: "car", 2: "dog", 3: "bicycle"}
H, W = 240, 320
LINE = [(0, 120), (320, 120)]
POLY = [(60, 60), (260, 60), (260, 180), (60, 180)]

torch.set_num_threads(2)


class _Model:
    """What a solution takes as ``model`` here: class names and a device, no network."""

    def __init__(self):
        self.names, self.device = dict(NAMES), "cpu"


class _Drawn:
    """Where the port draws what is bounded rather than equal to cv2: each
    text's box and each ``LINE_AA`` shape's, recorded while installed."""

    def __init__(self, mp):
        self.boxes: list[tuple] = []
        real = {n: getattr(D, n) for n in ("put_text", "line", "circle", "rectangle", "polylines")}

        def aa(line_type, thickness, pts):
            if line_type == D.LINE_AA:
                m = max(thickness, 1) + 2
                p = np.asarray(pts, np.float64).reshape(-1, 2)
                self.boxes.append((*(p.min(0) - m), *(p.max(0) + m)))

        def put_text(img, text, org, face, scale, color, thickness=1, line_type=D.LINE_8):
            (tw, th), base = D.get_text_size(text, face, scale, thickness)
            self.boxes.append((org[0] - 2, org[1] - th - 2, org[0] + tw + 2, org[1] + base + 2))
            return real["put_text"](img, text, org, face, scale, color, thickness, line_type)

        def line(img, p1, p2, color, thickness=1, line_type=D.LINE_8):
            aa(line_type, thickness, [p1, p2])
            return real["line"](img, p1, p2, color, thickness, line_type)

        def circle(img, c, r, color, thickness=1, line_type=D.LINE_8):
            aa(line_type, thickness, [(c[0] - r, c[1] - r), (c[0] + r, c[1] + r)])
            return real["circle"](img, c, r, color, thickness, line_type)

        def rectangle(img, p1, p2, color, thickness=1, line_type=D.LINE_8):
            aa(line_type, thickness, [p1, p2])
            return real["rectangle"](img, p1, p2, color, thickness, line_type)

        def polylines(img, pts, closed, color, thickness=1, line_type=D.LINE_8):
            for p in pts:
                aa(line_type, thickness, p)
            return real["polylines"](img, pts, closed, color, thickness, line_type)

        for name, fn in (("put_text", put_text), ("line", line), ("circle", circle), ("rectangle", rectangle),
                         ("polylines", polylines)):
            mp.setattr(D, name, fn)


def _fields(r) -> dict:
    return {k: v for k, v in vars(r).items() if k not in ("plot_im", "speed")}


def _assert_plot(ref: np.ndarray, out: np.ndarray, boxes: list) -> None:
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    if boxes:
        assert_bounded(ref, out, boxes, DRAWN_SHARE)
    else:
        np.testing.assert_array_equal(out, ref)


def _scene(n: int = 6, seed: int = 0):
    """Per frame: a BGR image with five objects painted on a noise
    background, the tracks (M, 7) of those in view, and the detections of
    ``Results`` (the same boxes, in the reverse order: a tracker's rows are
    in its own order). Objects 1 and 2 cross ``LINE`` down and up, 3 enters
    ``POLY``, 4 leaves it; 5 is gone on frames 2-3."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 200, (H, W, 3), np.uint8)
    objs = [(1, 0, (40, 30, 90, 100), (0, 16)), (2, 1, (200, 150, 260, 200), (0, -14)),
            (3, 2, (0, 150, 40, 200), (22, -4)), (4, 3, (180, 70, 230, 110), (18, -8)),
            (5, 0, (120, 90, 170, 140), (3, 2))]
    for t in range(n):
        img, rows = base.copy(), []
        for tid, c, box, (vx, vy) in objs:
            if tid == 5 and t in (2, 3):
                continue
            b = np.array(box, float) + [vx * t, vy * t, vx * t, vy * t] + rng.normal(0, 0.7, 4)
            x1, y1, x2, y2 = np.clip(b, 0, [W, H, W, H]).astype(int)
            img[y1:y2, x1:x2] = (40 + 50 * c, 220 - 40 * c, 90 + 30 * tid)
            rows.append([*b, tid, rng.uniform(0.3, 0.95), c])
        tracks = np.array(rows)
        det = tracks[::-1][:, [0, 1, 2, 3, 5, 6]].astype(np.float32)
        kpts = np.concatenate([rng.uniform([0, 0], [W, H], (len(det), 17, 2)), rng.rand(len(det), 17, 1)], -1)
        masks = np.zeros((len(det), H, W), bool)
        for i, (x1, y1, x2, y2) in enumerate(det[:, :4].astype(int)):
            cv2.ellipse(masks[i].view(np.uint8), ((x1 + x2) // 2, (y1 + y2) // 2), (max((x2 - x1) // 2, 1),
                        max((y2 - y1) // 3, 1)), 0, 0, 360, 1, -1)
        yield img, tracks, {"boxes": det, "keypoints": kpts.astype(np.float32), "masks": masks}


def _run(mp, name: str, kw: dict, extras=("boxes",), n: int = 6, jax_kw: dict | None = None):
    """Both packages' ``name`` over ``_scene``: [(JAX result, port result, bounded boxes)] a frame."""
    jsol = getattr(JS, name)(model=_Model(), **(kw if jax_kw is None else jax_kw))
    psol = getattr(PS, name)(model=_Model(), **kw)
    out = []
    for img, tracks, extra in _scene(n):
        ex = {k: extra[k] for k in extras}
        a = jsol.process(JaxResults(img, "f", dict(NAMES), **ex), tracks.copy())
        with pytest.MonkeyPatch.context() as m:
            rec = _Drawn(m)
            b = psol.process(Results(img, "f", dict(NAMES), **ex, device="cpu"), tracks.copy())
        out.append((a, b, rec.boxes))
    return out


def _check(frames) -> None:
    for t, (a, b, boxes) in enumerate(frames):
        assert _fields(b) == _fields(a), (t, _fields(b), _fields(a))
        _assert_plot(a.plot_im, b.plot_im, boxes)


# ------------------------------------------------------------------ config, results, annotator
def test_solution_config_and_results_match_jax():
    pf = [(f.name, f.default, f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
          for f in dataclasses.fields(PS.SolutionConfig)]
    jf = [(f.name, f.default, f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
          for f in dataclasses.fields(JS.SolutionConfig)]
    assert pf == jf
    assert vars(PS.SolutionConfig().update(conf=0.4, region=LINE)) == vars(JS.SolutionConfig().update(conf=0.4,
                                                                                                      region=LINE))
    for cfg in (PS.SolutionConfig(), JS.SolutionConfig()):
        with pytest.raises(ValueError, match="colourmap is not a valid solution argument"):
            cfg.update(colourmap=2)
    for kw in ({}, {"in_count": 3, "classwise_count": {"car": {"IN": 1, "OUT": 0}}, "max_heat": 4.0},
               {"workout_count": [0, 2], "workout_stage": ["up", "-"], "email_sent": True, "alarm": False},
               {"speed_dict": {3: 12.5}, "total_tracks": 0, "pixels_distance": 0.0, "distance_m": None}):
        assert str(PS.SolutionResults(**kw)) == str(JS.SolutionResults(**kw))
        assert _fields(PS.SolutionResults(**kw)) == _fields(JS.SolutionResults(**kw))


def _annotator_calls(rng):
    kpts = np.concatenate([rng.uniform([10, 10], [300, 220], (17, 2)), rng.rand(17, 1)], 1)
    return {
        "draw_region": [((POLY,), {}), ((LINE,), {"color": (0, 0, 255), "thickness": 3})],
        "queue_counts_display": [(("Queue Counts : 7",), {"points": POLY})],
        "display_analytics": [((None, {"car": "IN 2 OUT 1", "person": "IN 0 OUT 4"}), {}),
                              ((None, {"ALARM": 9}), {"txt_color": (255, 255, 255), "bg_color": (0, 0, 255)})],
        "draw_specific_kpts": [((kpts, [5, 7, 9]), {}), ((kpts,), {"radius": 4})],
        "plot_workout_information": [(("Steps : 3", (40, 60)), {})],
        "plot_angle_and_count_and_stage": [((123.456, 4, "down", kpts[8]), {})],
        "plot_distance_and_line": [((87.25, ((40.5, 50.2), (200.7, 180.1))), {})],
        "display_objects_labels": [((None, "left: 3"), {"x_center": 160.4, "y_center": 120.6})],
        "sweep_annotator": [((), {"line_x": 150, "line_y": 200, "label": "sweep"}), ((), {"line_x": 20, "line_y": 90})],
        "visioneye": [(((100, 80, 160, 150), (20, 20)), {})],
        "adaptive_label": [(((100, 80, 160, 150), "12.5 km/h"), {}),
                           (((30, 30, 60, 60), "7"), {"shape": "circle", "color": (0, 0, 255)})],
    }


@pytest.mark.parametrize("method", list(_annotator_calls(np.random.RandomState(0))))
def test_solution_annotator_matches_jax(method, monkeypatch):
    rng = np.random.RandomState(len(method))
    img = rng.randint(0, 200, (H, W, 3), np.uint8)
    ja = JS.SolutionAnnotator(img.copy(), 2)
    pa = PS.SolutionAnnotator(img.copy(), 2, device="cpu")
    assert (pa.lw, pa.sf, pa.tf) == (ja.lw, ja.sf, ja.tf)
    rec = _Drawn(monkeypatch)
    for args, kw in _annotator_calls(rng)[method]:
        outs = []
        for ann in (ja, pa):
            a = tuple(ann.im if x is None else x for x in args)  # the methods that take the image get their own
            outs.append(getattr(ann, method)(*a, **kw))
        if method == "plot_workout_information":
            assert outs[0] == outs[1]
    monkeypatch.undo()
    _assert_plot(ja.result(), pa.result(), rec.boxes)
    if method in ("draw_region", "visioneye"):  # LINE_8 strokes and fills only
        assert not rec.boxes
    for a, b, c in ([(0, 0), (1, 1), (2, 0)], [(5, 5), (0, 0), (5, 0)], [(1, 0), (0, 0), (-1, 0.001)]):
        assert PS.SolutionAnnotator.estimate_pose_angle(a, b, c) == JS.SolutionAnnotator.estimate_pose_angle(a, b, c)


# ------------------------------------------------------------------ the apps, frame by frame
APPS = {
    "count_line": ("ObjectCounter", {"region": LINE}),
    "count_polygon": ("ObjectCounter", {"region": POLY, "line_width": 3}),
    "region_counter": ("RegionCounter", {"regions": {"left": [(0, 0), (160, 0), (160, 240), (0, 240)],
                                                     "top": [(0, 0), (320, 0), (320, 100), (0, 100)]}}),
    "speed": ("SpeedEstimator", {}),
    "speed_calibrated": ("SpeedEstimator", {"meter_per_pixel": 0.1, "fps": 25.0, "window": 3}),
    "trackzone": ("TrackZone", {"region": POLY}),
    "queue": ("QueueManager", {"region": POLY}),
    "parking": ("ParkingManagement", {"slots": [POLY[:3], [(0, 0), (100, 0), (100, 60)], [(250, 170), (320, 170),
                                                                                        (320, 240), (250, 240)]]}),
    "visioneye": ("VisionEye", {"vision_point": (300, 10)}),
    "distance": ("DistanceCalculation", {}),
    "distance_selected": ("DistanceCalculation", {"selected_ids": (2, 5), "pixels_per_meter": 10.0}),
    "heatmap_region": ("Heatmap", {"region": LINE, "colormap": 11, "alpha": 0.4}),
}


@pytest.mark.parametrize("case", list(APPS))
def test_app_matches_jax(case, monkeypatch):
    name, kw = APPS[case]
    frames = _run(monkeypatch, name, kw)
    _check(frames)
    last = frames[-1][1]
    assert last.total_tracks > 0
    if case == "count_line":
        assert last.in_count >= 1 and last.out_count >= 1
    if case == "count_polygon":
        assert last.in_count + last.out_count >= 1


@pytest.mark.parametrize("colormap", [None, 4, 20])
def test_heatmap_without_region_is_bit_equal(colormap, monkeypatch):
    frames = _run(monkeypatch, "Heatmap", {"colormap": colormap})
    for a, b, boxes in frames:
        assert not boxes and b.max_heat > 0
    _check(frames)


@pytest.mark.parametrize("blur_ratio", [0.5, 0.1, 1.0])
def test_object_blurrer_is_bit_equal(blur_ratio, monkeypatch):
    frames = _run(monkeypatch, "ObjectBlurrer", {"blur_ratio": blur_ratio})
    _check(frames)
    assert all(not boxes for _, _, boxes in frames)


def test_object_cropper_writes_the_same_jpegs(monkeypatch, tmp_path):
    frames = _run(monkeypatch, "ObjectCropper", {"crop_dir": str(tmp_path / "p")},
                  jax_kw={"crop_dir": str(tmp_path / "j")})
    _check(frames)
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "p").iterdir()) and len(files) == frames[-1][1].total_crop_objects
    for f in files:  # the port's writer is byte-equal to cv2.imencode
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_parking_slots_from_json_and_security_alarm(monkeypatch, tmp_path):
    slots = tmp_path / "slots.json"
    slots.write_text(json.dumps([{"points": POLY}, {"points": [(0, 0), (100, 0), (100, 60), (0, 60)]}]))
    _check(_run(monkeypatch, "ParkingManagement", {"json_file": str(slots)}))
    calls = {"j": [], "p": []}
    frames = _run(monkeypatch, "SecurityAlarm", {"records": 5, "on_alarm": calls["p"].append},
                  jax_kw={"records": 5, "on_alarm": calls["j"].append})
    _check(frames)
    assert calls["p"] == calls["j"] == [5] and [b.alarm for _, b, _ in frames] == [a.alarm for a, _, _ in frames]


def test_instance_segmentation_and_aigym(monkeypatch):
    frames = _run(monkeypatch, "InstanceSegmentation", {}, extras=("boxes", "masks"))
    _check(frames)
    assert frames[0][1].masks == 5
    frames = _run(monkeypatch, "AIGym", {"kpts": (5, 7, 9), "up_angle": 120.0, "down_angle": 60.0},
                  extras=("boxes", "keypoints"))
    _check(frames)
    assert len(frames[-1][1].workout_angle) == 5


def test_aigym_pairs_keypoints_with_tracks_by_row(monkeypatch):
    """ROADMAP queue 3, item 39, as in JAX: keypoint row i (a detection)
    takes track row i's id, though the tracker's rows are in another order
    (here reversed) and may be fewer; a keypoint row beyond the tracks
    takes its row number as the id."""
    img, tracks, extra = next(_scene(1))
    tracks = tracks[:3].copy()
    tracks[:, 4] += 10  # ids 11-13, apart from the row numbers 3 and 4
    res = Results(img, "f", dict(NAMES), boxes=extra["boxes"], keypoints=extra["keypoints"], device="cpu")
    gym = PS.AIGym(model=_Model())
    out = gym.process(res, tracks)
    kp = extra["keypoints"]
    ids = [int(tracks[i, 4]) for i in range(3)] + [3, 4]
    assert list(gym.states) == ids
    for i, tid in enumerate(ids):  # row i's angle under the id of track row i, not the detection's own track
        assert gym.states[tid]["angle"] == PS.SolutionAnnotator.estimate_pose_angle(*[kp[i][j] for j in gym.kpts])
    ref = JS.AIGym(model=_Model())
    ref.process(JaxResults(img, "f", dict(NAMES), boxes=extra["boxes"], keypoints=kp), tracks)
    assert dict(ref.states) == dict(gym.states) and out.workout_angle == [s["angle"] for s in gym.states.values()]


# ------------------------------------------------------------------ analytics against matplotlib
def _analytics_frames(n: int = 5):
    rng = np.random.RandomState(11)
    for t in range(n):
        k = [0, 3, 1, 4, 2][t % 5]  # frames with 0 to 4 classes
        rows = [[0, 0, 9, 9, i + 1, 0.9, c] for i, c in enumerate(list(range(k)) + list(rng.randint(0, max(k, 1), 4)))
                if k]
        yield np.array(rows, float).reshape(-1, 7)


@pytest.mark.parametrize("kind", ["line", "area", "bar", "pie"])
def test_analytics_matches_matplotlib(kind, monkeypatch, tmp_path):
    import matplotlib.pyplot as mpl_plt

    figs = {"mpl": [], "port": []}
    monkeypatch.setattr(mpl_plt, "close", lambda fig=None: figs["mpl"].append(fig))
    monkeypatch.setattr(chart, "close", lambda fig=None: figs["port"].append(fig))
    ja = JS.Analytics(model=_Model(), analytics_type=kind, update_every=2)
    pa = PS.Analytics(model=_Model(), analytics_type=kind, update_every=2)
    for t, tracks in enumerate(_analytics_frames()):
        a, b = ja.process(None, tracks), pa.process(None, tracks)
        assert _fields(b) == _fields(a)
        if t % 2:  # between updates the cached frame comes back
            assert b.plot_im is pa.last_plot_im and len(figs["port"]) == len(figs["mpl"]) == t // 2 + 1
            continue
        assert_axes_equal(figs["mpl"][-1], figs["port"][-1])
        cv2.imwrite(str(tmp_path / f"{t}_m.png"), a.plot_im)
        cv2.imwrite(str(tmp_path / f"{t}_p.png"), b.plot_im)
        assert b.plot_im.shape == (720, 1280, 3)
        assert_pixels_close(str(tmp_path / f"{t}_m.png"), str(tmp_path / f"{t}_p.png"))


# ------------------------------------------------------------------ the slice as a whole
def _panned(n: int = 4):
    rng = np.random.RandomState(5)
    world = rng.randint(0, 256, (120, 200, 3), np.uint8)
    for t in range(n):
        img = world[:, 3 * t: 3 * t + 160].copy()
        img[20:60, 10 + 8 * t: 50 + 8 * t] = (230, 60, 60)
        img[60:110, 120 - 6 * t: 150 - 6 * t] = (60, 230, 60)
        yield img


@pytest.fixture(scope="module")
def facades():
    """The JAX facade and the port on the same yolo11n-fce weights (the
    port's seeded init with every parameter moved by N(0, 0.05), so scores
    and boxes differ from anchor to anchor), bridged to flax."""
    jy, port = jax_facade("yolo11n-fce.yaml", 2, bias_prior=False)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in port.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    jy.variables = jax.tree_util.tree_map(jax.numpy.asarray, state_dict_to_variables(port.model))
    return jy, port


@pytest.mark.parametrize("name,kw", [("ObjectCounter", {"region": [(80, 0), (80, 120)]}), ("Heatmap", {})])
def test_solution_call_matches_jax_facade(facades, name, kw, monkeypatch):
    jy, port = facades
    sols, tracks = [getattr(JS, name)(model=jy, **kw), getattr(PS, name)(model=port, **kw)], [[], []]
    for i, s in enumerate(sols):
        s.imgsz = 128
        real = s.process
        s.process = lambda res, trk, _r=real, _i=i: (tracks[_i].append(trk), _r(res, trk))[1]
    frames = list(_panned())
    ref = list(sols[0](frames))
    with pytest.MonkeyPatch.context() as m:
        rec = _Drawn(m)
        out = list(sols[1](frames))
    assert len(out) == len(ref) == 4 and sum(len(t) for t in tracks[1]) > 0
    for a, b, ta, tb in zip(ref, out, *tracks):
        np.testing.assert_array_equal(tb[:, [4, 6]], ta[:, [4, 6]])
        np.testing.assert_allclose(tb[:, 5], ta[:, 5], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tb[:, :4], ta[:, :4], rtol=0, atol=1e-3)
        assert _fields(b) == _fields(a)
        assert set(b.speed) == {"track", "solution"} and min(b.speed.values()) > 0
        _assert_plot(a.plot_im, b.plot_im, rec.boxes)


def test_call_takes_imgsz(facades):
    """ROADMAP queue 3, item 40: the port's ``__call__`` takes ``imgsz=``
    (the solution's own 640 otherwise); JAX passes its 640 and the keyword
    both, and raises."""
    jy, port = facades
    frames = list(_panned(2))
    sol = PS.ObjectCounter(model=port, region=LINE)
    with pytest.MonkeyPatch.context() as m:
        seen = []
        real = port.predict
        m.setattr(port, "predict", lambda src, **kw: (seen.append(kw["imgsz"]), real(src, **kw))[1])
        assert len(list(sol(frames, imgsz=64))) == 2
        assert len(list(sol(frames[:1]))) == 1
    assert seen == [64, 640]
    with pytest.raises(TypeError, match="imgsz"):
        list(JS.ObjectCounter(model=jy, region=LINE)(frames, imgsz=64))


# ------------------------------------------------------------------ the command line
@pytest.fixture()
def small_solutions(monkeypatch):
    """Both packages' solutions at 128 px (their ``BaseSolution`` fixes 640)."""
    for mod in (JS.base, PS.base):
        real = mod.BaseSolution.__init__

        def init(self, *a, _real=real, **kw):
            _real(self, *a, **kw)
            self.imgsz = 128

        monkeypatch.setattr(mod.BaseSolution, "__init__", init)


def test_cli_solutions_match_jax(jax_ckpt, small_solutions, tmp_path):
    frames = list(_panned(3))
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(src / f"{i}.png"), f)
    common = ["count", f"model={jax_ckpt}", f"source={src}", "region=[(80, 0), (80, 120)]", "conf=0.74",
              "classes=[0, 1, 2]"]
    ref = jax_handle_solutions(common)
    out = entrypoint(["solutions", *common, "device=cpu", f"save_dir={tmp_path / 'out'}"])
    assert len(out) == len(ref) == 3 and sum(r.total_tracks for r in out) > 0
    for a, b in zip(ref, out):
        assert _fields(b) == _fields(a)
    written = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in written] == [f"{i:06d}.jpg" for i in range(3)]
    for p, r in zip(written, out):  # each frame's plot_im, as cv2.imencode writes it
        assert p.read_bytes() == cv2.imencode(".jpg", r.plot_im)[1].tobytes()
    assert entrypoint(["solutions", "help"]) == []
    assert sorted(SOLUTION_MAP) == sorted(__import__("fce_yolo_tpu.cfg", fromlist=["x"]).SOLUTION_MAP)


@pytest.fixture(scope="module")
def port_ckpt(jax_ckpt, tmp_path_factory):
    """The narrow model of ``jax_ckpt`` saved by the port (read without the Python zstd decoder)."""
    d = tmp_path_factory.mktemp("solutions_ckpt") / "narrow"
    YOLO(jax_ckpt, device="cpu").save(d)
    return str(d)


@pytest.mark.parametrize("name", sorted(SOLUTION_MAP))
def test_every_cli_solution_runs(name, jax_ckpt, port_ckpt, small_solutions, tmp_path):
    """``solutions NAME`` for each of the 12 names on two frames; ``inference``
    writes its frames (ROADMAP queue 3, item 41: the JAX CLI raises there)."""
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(_panned(2)):
        cv2.imwrite(str(src / f"{i}.png"), f)
    extra = {"crop": [f"crop_dir={tmp_path / 'crops'}"], "inference": [f"out_dir={tmp_path / 'inf'}", "imgsz=128"],
             "isegment": [], "workout": []}.get(name, [])
    model = f"model={port_ckpt}"
    if name == "isegment":
        model = "model=yolo11n-seg.yaml"
    if name == "workout":
        model = "model=yolo11n-pose.yaml"
    out = entrypoint(["solutions", name, model, f"source={src}", "device=cpu", "conf=0.75", *extra])
    assert len(out) == 2
    if name == "inference":
        assert [Path(p).name for p in out] == ["frame_00000.jpg", "frame_00001.jpg"]
        with pytest.raises(AttributeError, match="plot_im"):  # with save_dir=, the JAX CLI reads plot_im of a path
            jax_handle_solutions(["inference", f"model={jax_ckpt}", f"source={src}", f"out_dir={tmp_path / 'j'}",
                                  "imgsz=128", "conf=0.75", f"save_dir={tmp_path / 'js'}"])
        assert entrypoint(["solutions", name, model, f"source={src}", "device=cpu", "conf=0.75", *extra,
                           f"save_dir={tmp_path / 'ps'}"]) == out
    else:
        assert all(isinstance(r, PS.SolutionResults) and r.plot_im is not None for r in out)
