"""Classification in the port (``nn/heads.py::Classify``, the parser rule,
the weight bridge's Linear, ``data/classify.py``, ``engine/results.py::
Probs``, ``train/task_losses.py::classification_loss`` and ``YOLO.predict``
/ ``val`` / ``train`` / ``track`` of a classify model) against the JAX
package, at yolo11n-cls on conftest's ``tiny_cls_dataset`` (64x64 JPEGs,
two classes, 16 train and 8 val images).

Tolerances:
- the head in eval mode and ``predict``'s probabilities: 1e-5 of the
  largest (float32 in both; the port predicts with Conv+BN folded, the JAX
  facade unfolded), top-1 and top-5 equal (the margins are checked to be
  far above that);
- the head in training mode: 1e-3 of the largest logit (at 128 px and B=2
  BatchNorm over the 4x4 maps normalises by the statistics of 32 values a
  channel, which amplifies float32 rounding; ``test_torch_train_step.py``
  states the same);
- train items: bit-equal for the same seed and epoch (``resize_linear`` is
  cv2's INTER_LINEAR bit for bit), val items and ``val_transform`` too;
- the loss and its gradient: 1e-6;
- ``train`` against the JAX facade at 128 px: the epochs' mean losses within
  1e-3 relative, the same top-1 and top-5.

One difference on purpose (ROADMAP queue 3, item 21): the per-epoch val of
``train`` takes the mean over the val images; the JAX facade's pads the last
batch with copies of its last image and averages the per-batch means
(``fce_yolo_tpu/api.py:972-979``), as its ``val`` does not.
"""

import dataclasses
import inspect
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.data.classify import ClassificationDataset as JaxDataset
from fce_yolo_tpu.data.classify import classify_collate as jax_collate
from fce_yolo_tpu.data.classify import val_transform as jax_val_transform
from fce_yolo_tpu.engine.results import Probs as JaxProbs
from fce_yolo_tpu.engine.results import Results as JaxResults
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu.nn.model import param_count as jax_param_count
from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu.train.task_losses import classification_loss as jax_classification_loss
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.data.classify import ClassificationDataset, classify_collate, val_transform
from fce_yolo_tpu_torch.engine.results import Probs, Results
from fce_yolo_tpu_torch.nn.heads import Classify
from fce_yolo_tpu_torch.nn.model import param_count
from fce_yolo_tpu_torch.nn.parser import load_model_yaml
from fce_yolo_tpu_torch.train.task_losses import classification_loss

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from test_torch_modules import jax_known_strides  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)


def _moved(v: dict, seed: int = 1) -> dict:
    """``v`` with every parameter moved by N(0, 0.05): distinct logits an image."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"] = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype), v["params"])
    return v


@pytest.fixture(scope="module")
def weights():
    """yolo11n-cls with two classes: the JAX init from seed 0, moved."""
    jy = JaxYOLO("yolo11n-cls.yaml", nc=2)
    v = jax.jit(lambda k: init_variables(jy.model, k, imgsz=64))(jax.random.PRNGKey(0))
    return _moved(v)


def _pair(v: dict):
    jy = JaxYOLO("yolo11n-cls.yaml", nc=2)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, v)
    return jy, YOLO("yolo11n-cls.yaml", device="cpu", nc=2).load_jax_variables(v)


@pytest.mark.parametrize("scale", ["n", "s"])
def test_classify_spec_matches_jax(scale):
    """The parser's Classify rule: ``args = [c1, nc]`` with c1 the input's
    channels; the task is classify and there are no strides."""
    ref = jax_load_model_yaml(REPO / "fce_yolo_tpu" / "cfg" / "models" / "yolo11-cls.yaml", scale=scale)
    spec = load_model_yaml("yolo11-cls.yaml", scale=scale)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
    assert spec.task == "classify" and spec.layers[-1].args[1] == 1000
    port = YOLO(f"yolo11{scale}-cls.yaml", device="cpu")
    assert port.task == "classify" and port.strides == () and isinstance(port.model.detect, Classify)


def test_classify_head_matches_flax(weights):
    """The whole yolo11n-cls graph through the bridge (flax Dense kernel
    (in, out) -> Linear weight (out, in)): eval probabilities and logits,
    training-mode logits, and the parameter count."""
    jy, port = _pair(weights)
    assert param_count(port.model) == jax_param_count(weights)
    x = np.random.RandomState(2).rand(2, 128, 128, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jy.model.apply(v, x, train=False))(weights, jnp.asarray(x))
    with torch.no_grad():
        out = port.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(out) == {"probs", "logits"} and out["probs"].dtype == torch.float32
    for k in ("probs", "logits"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    ref_train, _ = jax.jit(lambda v, x: jy.model.apply(v, x, train=True, mutable=["batch_stats"]))(
        weights, jnp.asarray(x))
    with torch.no_grad():
        out_train = port.model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    port.model.eval()
    assert set(out_train) == {"logits"} and set(ref_train) == {"logits"}
    r = np.asarray(ref_train["logits"])
    np.testing.assert_allclose(out_train["logits"].numpy(), r, rtol=0, atol=1e-3 * np.abs(r).max())


@pytest.mark.parametrize("imgsz", [64, 96])
def test_classification_dataset_matches_jax(tiny_cls_dataset, imgsz):
    """Names, order, train items (two epochs and a reseed) and val items bit-equal."""
    for split, mode in (("train", "train"), ("val", "val")):
        ref = JaxDataset(f"{tiny_cls_dataset}/{split}", imgsz=imgsz, mode=mode, seed=3)
        ds = ClassificationDataset(f"{tiny_cls_dataset}/{split}", imgsz=imgsz, mode=mode, seed=3, device="cpu")
        assert ds.names == ref.names == {0: "class0", 1: "class1"} and ds.samples == ref.samples
        for epoch in (None, 1, 2):
            if epoch is not None:
                ref.set_epoch(epoch)
                ds.set_epoch(epoch)
            items = [ds[i] for i in range(len(ds))]
            ref_items = [ref[i] for i in range(len(ref))]
            for a, b in zip(items, ref_items):
                assert a["label"] == b["label"] and a["img"].shape == (imgsz, imgsz, 3)
                np.testing.assert_array_equal(a["img"], b["img"])
            out, exp = classify_collate(items[:3]), jax_collate(ref_items[:3])
            np.testing.assert_array_equal(out["img"], exp["img"])
            np.testing.assert_array_equal(out["label"], exp["label"])
            assert out["label"].dtype == exp["label"].dtype


def test_val_transform_matches_jax():
    """Shorter side to s (down and up), centre crop: bit-equal to the cv2 version."""
    rng = np.random.RandomState(4)
    for h, w in [(64, 64), (48, 80), (100, 37), (17, 500), (224, 300), (481, 641)]:
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        for s in (32, 64, 224):
            np.testing.assert_array_equal(val_transform(img, s), jax_val_transform(img, s))


def test_probs_and_results_match_jax():
    """``Probs``' top-1/top-5 and confidences, ``verbose`` (the top-5 line),
    ``summary`` (empty: no boxes) and indexing."""
    rng = np.random.RandomState(5)
    img = np.zeros((8, 8, 3), np.uint8)
    names = {i: f"c{i}" for i in range(7)}
    for n in (2, 7):
        data = rng.dirichlet(np.ones(n)).astype(np.float32)
        p, q = Probs(data), JaxProbs(data)
        assert (p.top1, p.top5, p.top1conf) == (q.top1, q.top5, q.top1conf)
        np.testing.assert_array_equal(p.top5conf, q.top5conf)
        r, s = Results(img, "x", names, probs=data), JaxResults(img, "x", names, probs=data)
        assert r.verbose() == s.verbose() and r.summary() == s.summary() == [] and len(r) == len(s) == 0
        np.testing.assert_array_equal(r[[]].probs.data, data)


def test_classification_loss_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.normal(0, 3, (5, 7)).astype(np.float32)
    labels = rng.randint(0, 7, 5).astype(np.int32)
    ref, ref_parts = jax_classification_loss(jnp.asarray(logits), jnp.asarray(labels))
    ref_grad = jax.grad(lambda z: jax_classification_loss(z, jnp.asarray(labels))[0])(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    out, parts = classification_loss(t, torch.from_numpy(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(parts["cls"].item(), float(ref_parts["cls"]), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad), rtol=0, atol=1e-6)


def _assert_same_probs(out, ref):
    assert [o.path for o in out] == [r.path for r in ref]
    p, q = np.stack([o.probs.data for o in out]), np.stack([r.probs.data for r in ref])
    np.testing.assert_allclose(p, q, rtol=0, atol=1e-5)
    top2 = np.sort(q, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3  # far above the tolerance: the same top-1 is meaningful
    assert [o.probs.top1 for o in out] == [r.probs.top1 for r in ref]
    assert [o.probs.top5 for o in out] == [r.probs.top5 for r in ref]
    assert [o.verbose() for o in out] == [r.verbose() for r in ref]


def test_predict_and_val_match_jax_facade(weights, tiny_cls_dataset, tmp_path):
    """``predict`` on the val directory (64 px, and the 224 px default) and
    on the same images as an MJPEG AVI; ``val`` (batch 3: the JAX side pads
    its last batch and drops the pad) at 64 px and at the default."""
    jy, port = _pair(weights)
    val_dir = f"{tiny_cls_dataset}/val"
    _assert_same_probs(port.predict(val_dir, imgsz=64, batch=3), jy.predict(val_dir, imgsz=64))
    _assert_same_probs(port.predict(val_dir), jy.predict(val_dir))
    files = sorted(Path(val_dir).rglob("*.jpg"))
    path = tmp_path / "val.avi"
    path.write_bytes(chip_smoke.avi_bytes([f.read_bytes() for f in files], 64, 64))
    arrays = [cv2.imread(str(f)) for f in files]
    on_avi = port.predict(str(path), imgsz=64, stream=True)
    assert inspect.isgenerator(on_avi)
    on_avi = list(on_avi)
    ref = jy.predict(arrays, imgsz=64)
    assert [r.path for r in on_avi] == [f"{path}#frame{i}" for i in range(len(files))]
    np.testing.assert_allclose(np.stack([o.probs.data for o in on_avi]), np.stack([r.probs.data for r in ref]),
                               rtol=0, atol=1e-5)
    for kw in ({"imgsz": 64, "batch": 3}, {}):
        ref = jy.val(tiny_cls_dataset, verbose=False, **kw)
        out = port.val(tiny_cls_dataset, verbose=False, **kw)
        assert out == ref and 0 < out["metrics/accuracy_top1"] < 1
    assert port.names == jy.names == {0: "class0", 1: "class1"}


def test_track_on_a_classifier_gives_empty_tracks_as_jax(weights):
    """A classify model has no boxes: ``track`` yields each frame's probs and
    an empty (0, 7) track array, as the JAX facade does."""
    jy, port = _pair(weights)
    frames = [np.random.RandomState(i).randint(0, 256, (64, 80, 3), np.uint8) for i in range(3)]
    ref, out = jy.track(frames, imgsz=64), port.track(frames, imgsz=64)
    assert len(out) == len(ref) == 3
    for (r_res, r_trk), (o_res, o_trk) in zip(ref, out):
        assert o_trk.shape == np.asarray(r_trk).reshape(-1, 7).shape == (0, 7)
        np.testing.assert_allclose(o_res.probs.data, r_res.probs.data, rtol=0, atol=1e-5)


TRAIN = dict(epochs=2, imgsz=128, optimizer="AdamW", lr0=0.002, warmup_epochs=0.0, momentum=0.9, verbose=False)


def test_train_matches_jax_facade(weights, tiny_cls_dataset, tmp_path):
    """``train`` (batch 4: no padding in either val) against the JAX facade
    from the same weights: the epochs' mean losses within 1e-3 relative and
    the same top-1/top-5; ``results.csv``, ``last`` and ``best`` written
    with the class names; ``best`` reloads as a classifier whose ``val``
    gives the run's best top-1."""
    jy, port = _pair(weights)
    ref = jy.train(data=tiny_cls_dataset, batch=4, project=str(tmp_path / "jax"), name="c", **TRAIN)
    out = port.train(data=tiny_cls_dataset, batch=4, project=str(tmp_path / "port"), name="c", **TRAIN)
    assert out["epochs_run"] == ref["epochs_run"] == 2
    for o, r in zip(out["results"], ref["results"]):
        np.testing.assert_allclose(o["train/loss"], r["train/loss"], rtol=1e-3)
        for k in ("metrics/accuracy_top1", "metrics/accuracy_top5"):
            assert o[k] == r[k]
    assert out["best_fitness"] == ref["best_fitness"]
    save = Path(out["save_dir"])
    assert (save / "results.csv").read_text().splitlines()[0].startswith("epoch,train/loss,metrics/accuracy_top1")
    best = YOLO(str(save / "weights" / "best"), device="cpu")
    assert best.task == "classify" and best.names == port.names == {0: "class0", 1: "class1"}
    assert best.val(tiny_cls_dataset, imgsz=128, batch=4, verbose=False)["metrics/accuracy_top1"] == \
        out["best_fitness"]
    assert YOLO(str(save / "weights" / "last"), device="cpu").task == "classify"


def test_train_val_takes_the_mean_over_images_where_jax_pads(weights, tiny_cls_dataset, tmp_path):
    """Item 21: with batch 3 the 8 val images come as 3 + 3 + 2, and the JAX
    facade pads the last batch with a copy of its last image and averages
    the three batch means. A classifier held on class 0 (the Linear bias
    +10/-10, lr0 0, so no step moves it) is right on the 4 class-0 images:
    the port reports 4/8 = 0.5, the JAX facade (1 + 1/3 + 0) / 3."""
    v = jax.tree_util.tree_map(np.array, weights)
    v["params"]["layers_10"]["linear"]["bias"][:] = (10.0, -10.0)
    jy, port = _pair(v)
    kw = dict(TRAIN, epochs=1, lr0=0.0, batch=3)
    ref = jy.train(data=tiny_cls_dataset, project=str(tmp_path / "jax"), name="c", **kw)
    out = port.train(data=tiny_cls_dataset, project=str(tmp_path / "port"), name="c", **kw)
    assert out["results"][0]["metrics/accuracy_top1"] == 0.5
    np.testing.assert_allclose(ref["results"][0]["metrics/accuracy_top1"], (1 + 1 / 3 + 0) / 3, rtol=1e-6)
    assert port.val(tiny_cls_dataset, imgsz=128, batch=3, verbose=False)["metrics/accuracy_top1"] == 0.5
