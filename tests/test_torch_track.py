"""Tracking in the port (``fce_yolo_tpu_torch/trackers/``, ``YOLO.embed``,
``YOLO.track``) against the JAX package.

The trackers run the same seeded 60-frame sequences in both packages
(objects that cross, a stretch of scores in ByteTrack's low band (0.1,
0.25), an object gone for fewer and one for more than ``track_buffer``
frames, six classes with the clutter): the Kalman state within 1e-12, and every
frame's (M, 7) output with equal ids, scores and classes and boxes within
1e-9. The facade, at yolo11n-fce and 64 px on the same weights: ``embed``
within 1e-5 * max|ref| of JAX's, ``track(conf=0.25)`` with JAX's ids and
classes every frame, scores within 1e-5 and boxes within 1e-3 px. Two differences from the JAX
facade, each stated by a test: ``conf`` defaults to 0.1 (JAX's 0.25 drops
the low band before the tracker) and ``persist=True`` keeps the tracker
between calls (JAX builds a new one every call). A third: the ReID crop
of a box on the image's far edge is never empty, where JAX's raises.
"""

import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu import trackers as jt
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.engine.results import Results as JaxResults
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu.trackers.track import _crop_embed_encoder as jax_crop_encoder
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch import trackers as pt
from fce_yolo_tpu_torch.engine.results import Results
from fce_yolo_tpu_torch.trackers.track import _crop_embed_encoder
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

COLORS = [(40, 40, 230), (40, 230, 40), (230, 40, 40), (230, 230, 40), (230, 40, 230)]

torch.set_num_threads(1)


def _sequence(seed: int, n: int = 60):
    """Per frame (boxes (N, 4), scores, classes, a 480x640 image with each
    object painted in its colour). A and B cross; C's scores sit in the low
    band on frames 20-29; D is gone on frames 15-24 (10 frames) and E on
    10-45 (36 frames, over the 30 of ``track_buffer``); 0-3 clutter boxes
    of classes 4-5."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(-20, 20, (5, 2))
    for t in range(n):
        low = 20 <= t < 30
        objs = [  # (box, class, score)
            ((60 + 8 * t, 100, 140 + 8 * t, 180), 0, rng.uniform(0.5, 0.95)),
            ((560 - 8 * t, 110, 640 - 8 * t, 190), 0, rng.uniform(0.5, 0.95)),
            ((100 + 2 * t, 300, 170 + 2 * t, 400), 1, rng.uniform(0.12, 0.24) if low else rng.uniform(0.5, 0.9)),
            ((400, 250 + t, 470, 330 + t), 2, rng.uniform(0.4, 0.9)) if not 15 <= t < 25 else None,
            ((250 + 3 * t, 20, 300 + 3 * t, 80), 3, rng.uniform(0.6, 0.9)) if not 10 <= t < 46 else None,
        ]
        img = np.zeros((480, 640, 3), np.uint8)
        boxes, scores, classes = [], [], []
        for k, o in enumerate(objs):
            if o is None:
                continue
            box = np.array(o[0], float) + np.r_[start[k], start[k]] + rng.normal(0, 1.5, 4)
            x1, y1, x2, y2 = np.clip(box, 0, [640, 480, 640, 480]).astype(int)
            img[y1:y2, x1:x2] = COLORS[k]
            boxes.append(box)
            scores.append(o[2])
            classes.append(o[1])
        for _ in range(rng.randint(0, 4)):
            c = rng.uniform([0, 0], [600, 440])
            boxes.append(np.r_[c, c + rng.uniform(10, 60, 2)])
            scores.append(rng.uniform(0.05, 0.6))
            classes.append(4 + rng.randint(0, 2))
        yield np.array(boxes), np.array(scores), np.array(classes, float), img


def _color_encoder(img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """A ReID stand-in: the mean colour inside each box, and a constant."""
    out = []
    for x1, y1, x2, y2 in np.clip(boxes, 0, [640, 480, 640, 480]).astype(int):
        patch = img[y1: max(y2, y1 + 1), x1: max(x2, x1 + 1)].reshape(-1, 3)
        out.append(np.r_[patch.mean(0) / 255.0, 0.2])
    return np.array(out, np.float32)


def _assert_same_tracks(out: np.ndarray, exp: np.ndarray, atol: float = 1e-9, score_atol: float = 0.0):
    """Equal ids and classes, scores within ``score_atol`` and boxes within ``atol``."""
    assert out.shape == exp.shape and out.shape[1] == 7
    np.testing.assert_array_equal(out[:, [4, 6]], exp[:, [4, 6]])
    np.testing.assert_allclose(out[:, 5], exp[:, 5], rtol=0, atol=score_atol)
    np.testing.assert_allclose(out[:, :4], exp[:, :4], rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kalman_matches_jax(seed):
    rng = np.random.RandomState(seed)
    kj, kp = jt.KalmanFilterXYAH(), pt.KalmanFilterXYAH()
    z = np.array([320.0, 240.0, 0.7, 80.0])
    mj, cj = kj.initiate(z)
    mp, cp = kp.initiate(z)
    for _ in range(60):
        z = z + rng.normal(0, [3, 3, 0.01, 1])
        mj, cj = kj.update(*kj.predict(mj, cj), z)
        mp, cp = kp.update(*kp.predict(mp, cp), z)
        np.testing.assert_allclose(mp, mj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-12)
    means = rng.uniform(10, 100, (5, 8))
    covs = np.stack([np.diag(rng.uniform(1, 5, 8)) for _ in range(5)])
    for a, b in zip(kj.multi_predict(means, covs), kp.multi_predict(means, covs)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["bytetrack", "botsort", "botsort-reid"])
def test_trackers_match_jax(kind, seed):
    """ByteTrack, and BoT-SORT without camera motion (``gmc_method: none``)
    with and without appearance features, frame by frame."""
    if kind == "bytetrack":
        tj, tp = jt.BYTETracker(jt.TrackerArgs()), pt.BYTETracker(pt.TrackerArgs())
    else:
        reid = kind == "botsort-reid"
        kw = dict(tracker_type="botsort", gmc_method="none", with_reid=reid)
        tj = jt.BOTSORT(jt.TrackerArgs(**kw), encoder=_color_encoder if reid else None)
        tp = pt.BOTSORT(pt.TrackerArgs(**kw), encoder=_color_encoder if reid else None)
    ids = set()
    for t, (boxes, scores, classes, img) in enumerate(_sequence(seed)):
        exp = tj.update(boxes, scores, classes, img=img)
        out = tp.update(boxes, scores, classes, img=img)
        _assert_same_tracks(out, exp)
        ids |= set(out[:, 4].astype(int).tolist())
        if t == 27:  # C (class 1) rides the low band on the second association
            assert (out[:, 6] == 1).any()
    assert len(ids) >= 5


def test_tracker_lifecycle():
    """In the port alone: D comes back within ``track_buffer`` under its
    own id, E after it under a new one; ``reset`` starts the ids at 1."""
    tk = pt.BYTETracker(pt.TrackerArgs())
    seen: dict[int, list[int]] = {}
    for t, (boxes, scores, classes, img) in enumerate(_sequence(0)):
        out = tk.update(boxes, scores, classes)
        for cls in (2, 3):
            seen.setdefault(cls, []).extend(out[out[:, 6] == cls, 4].astype(int).tolist())
    assert len(set(seen[2])) == 1  # gone for 10 frames: the same id
    assert len(set(seen[3])) == 2  # gone for 36 frames: a new id
    tk.reset()
    assert tk.update(np.array([[0, 0, 50, 50.0]]), np.array([0.9]), np.array([0.0]))[0, 4] == 1


def test_build_tracker_and_exports():
    assert jt.__all__ == pt.__all__
    for name in ("bytetrack.yaml", "botsort.yaml"):
        a, b = jt.build_tracker(name), pt.build_tracker(name)
        assert type(a).__name__ == type(b).__name__ and vars(a.args) == vars(b.args)
        assert (Path(pt.__file__).parent / "cfg" / name).read_bytes() == (
            Path(jt.__file__).parent / "cfg" / name).read_bytes()
    assert isinstance(pt.build_tracker("botsort"), pt.BOTSORT)


# ------------------------------------------------------------------ the facade
@pytest.fixture(scope="module")
def pair():
    """The JAX facade and the port on the same yolo11n-fce weights: a seeded
    init with every parameter moved by N(0, 0.05), so the head's outputs,
    scores and boxes differ from anchor to anchor."""
    jy = JaxYOLO("yolo11n-fce.yaml")
    v = jax.jit(lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"] = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype), v["params"])
    jy.variables = jax.tree_util.tree_map(jax.numpy.asarray, v)
    return jy, YOLO("yolo11n-fce.yaml", device="cpu").load_jax_variables(v)


def _frames(n: int = 6):
    """Noise with two rectangles that move, 96x128 BGR."""
    rng = np.random.RandomState(4)
    base = rng.randint(0, 256, (96, 128, 3), np.uint8)
    out = []
    for t in range(n):
        img = base.copy()
        img[10:50, 5 + 6 * t: 45 + 6 * t] = (230, 60, 60)
        img[50:90, 80 - 5 * t: 120 - 5 * t] = (60, 230, 60)
        out.append(img)
    return out


def test_embed_and_crop_encoder_match_jax(pair):
    jy, port = pair
    imgs = _frames(3)
    ref, out = np.stack(jy.embed(imgs, imgsz=64)), np.stack(port.embed(imgs, imgsz=64))
    assert out.shape == ref.shape == (3, 64 + port.nc) and out.dtype == np.float32
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    boxes = np.array([[5, 10, 45, 50], [80, 50, 120, 90], [120, 90, 140, 99], [-3, -2, 1, 1.5]], float)
    ref = jax_crop_encoder(jy, imgsz=64)(imgs[0], boxes)
    out = _crop_embed_encoder(port, imgsz=64)(imgs[0], boxes)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_track_matches_jax_facade(pair):
    jy, port = pair
    frames = _frames()
    ref = jy.track(frames, conf=0.25, imgsz=64)
    out = port.track(frames, conf=0.25, imgsz=64)
    assert len(out) == len(ref) == len(frames)
    n = 0
    for (r_res, r_trk), (o_res, o_trk) in zip(ref, out):
        assert isinstance(o_res, Results) and len(o_res) == len(r_res)
        _assert_same_tracks(o_trk, r_trk, atol=1e-3, score_atol=1e-5)
        n += len(o_trk)
    assert n > 0
    stream = port.track(frames[:2], conf=0.25, imgsz=64, stream=True)
    assert inspect.isgenerator(stream) and len(list(stream)) == 2


def _band_sequence():
    """Two objects at 0.9 for 3 frames, then one of them at 0.18 for 4."""
    for t in range(7):
        boxes = np.array([[10 + 3 * t, 10, 50 + 3 * t, 50, 0.9, 0], [70, 40 + 2 * t, 110, 80 + 2 * t,
                                                                       0.9 if t < 3 else 0.18, 1]])
        yield boxes


def _stub_predict(results_cls, default_conf: float, calls: list):
    """A ``predict`` that gives ``_band_sequence``'s rows above ``conf`` (the
    default being the facade's own ``predict``'s) and records the conf."""
    def predict(source, conf=default_conf, stream=False, **kw):
        calls.append(conf)
        img = np.zeros((120, 160, 3), np.uint8)
        gen = (results_cls(img, "f", {0: "a", 1: "b"}, boxes=rows[rows[:, 4] > conf]) for rows in _band_sequence())
        return gen if stream else list(gen)
    return predict


def test_default_conf_keeps_low_band_tracks_where_jax_drops_them(pair, monkeypatch):
    """The port's ``track`` predicts at conf 0.1 (Ultralytics' tracking
    default), so a detection at 0.18 reaches ByteTrack's second association
    and keeps its track; the JAX facade predicts at predict's 0.25
    (fce_yolo_tpu/api.py:260, 388-397), so the track is lost."""
    jy, port = pair
    jax_calls, port_calls = [], []
    jax_default = inspect.signature(JaxYOLO.predict).parameters["conf"].default
    monkeypatch.setattr(jy, "predict", _stub_predict(JaxResults, jax_default, jax_calls))
    monkeypatch.setattr(port, "predict", _stub_predict(Results, inspect.signature(YOLO.predict).parameters[
        "conf"].default, port_calls))
    ref, out = jy.track(None), port.track(None)
    assert set(jax_calls) == {0.25} and set(port_calls) == {0.1}
    for t in range(3, 7):
        assert len(out[t][1]) == 2 and sorted(out[t][1][:, 4]) == [1, 2]
        assert len(ref[t][1]) == 1 and ref[t][1][0, 4] == 1
    assert port.track(None, conf=0.25)[-1][1].shape == (1, 7)  # a conf given explicitly is kept


def test_crop_on_the_far_edge_embeds_where_jax_raises(pair):
    """A box that the clip to the image flattened on its far edge (a
    detection wholly in the letterbox's bottom padding): the JAX crop
    encoder cuts an empty crop and raises (fce_yolo_tpu/trackers/track.py:47-52);
    the port's embeds the edge's last 2 px."""
    jy, port = pair
    img = _frames(1)[0]
    boxes = np.array([[30, 96, 60, 96], [128, 20, 128, 40]], float)
    with pytest.raises(ZeroDivisionError):
        jax_crop_encoder(jy, imgsz=64)(img, boxes)
    out = _crop_embed_encoder(port, imgsz=64)(img, boxes)
    np.testing.assert_array_equal(out, np.stack(port.embed([img[94:96, 30:60], img[20:40, 126:128]], imgsz=64)))


def test_persist_keeps_the_tracker_where_jax_resets_it(pair):
    """``track(frame, persist=True)`` frame by frame gives the ids of one
    ``track`` over the list; with ``persist=False`` every call starts a new
    tracker, as the JAX facade's every call does (its ``persist`` is
    accepted and ignored)."""
    jy, port = pair
    frames = _frames(4)
    whole = port.track(frames, conf=0.25, imgsz=64)
    for f, (_, exp) in zip(frames, whole):
        _, out = port.track(f, conf=0.25, imgsz=64, persist=True)[0]
        _assert_same_tracks(out, exp)
    first = port._tracker[1]
    port.track(frames[0], tracker="botsort.yaml", conf=0.25, imgsz=64, persist=True)
    assert port._tracker[1] is not first  # another tracker config builds anew
    for f in frames[2:]:
        (_, out), = port.track(f, conf=0.25, imgsz=64)
        (_, ref), = jy.track(f, conf=0.25, imgsz=64, persist=True)
        _assert_same_tracks(out, ref, atol=1e-3, score_atol=1e-5)
        assert len(out) and out[:, 4].min() == 1  # a new tracker, ids from 1
    obb = YOLO("yolo11n-obb.yaml", device="cpu")  # OBB models track too (test_torch_video.py holds them to JAX)
    (res, trk), = obb.track(frames[0], imgsz=64, persist=True)
    assert res.obb is not None and trk.shape[1] == 7 and obb._tracker is not None
