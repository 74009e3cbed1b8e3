"""yolov8n and yolo12n through the port's facade against the JAX package's,
and the training pieces the new families touch:

- ``YOLO.predict`` on the same bridged float32 weights gives the JAX
  facade's detections (counts and classes exact, boxes within 1e-3 px,
  scores within 1e-5, as ``test_torch_predict.py``);
- one step's loss and parameter gradients (BatchNorm frozen, so both sides
  normalise by the same statistics; float32, the assigner's overlaps in
  float32): loss parts within 1e-5 relative, fg counts equal, each
  parameter's gradient within 1e-4 of its leaf's largest;
- the optimizer's groups of every parameter (``gamma`` and CBLinear's
  kernel "decay", its bias "bias") equal to the JAX ``_param_group_masks``
  on the same flax tree;
- ``detection_loss`` on four levels (P2 and P6 strides) equal to JAX's, and
  ``YOLO.train`` of a P2 detect, a P6 pose and a P6 segment model on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train.optim import _param_group_masks
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg.models import load_model_dict
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from fce_yolo_tpu_torch.nn.weights import key_to_flax, state_dict_to_variables
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train.optim import param_groups
from test_torch_families_models import narrow_v9e
from test_torch_modules import jax_known_strides  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)


def _port(name: str, seed: int = 1) -> YOLO:
    """The port's facade with seeded weights (and random BatchNorm statistics,
    so frozen BN is not the identity)."""
    port = YOLO(name, device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(seed), bias_prior=False)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in port.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    return port


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolo12n.yaml"])
def test_predict_matches_jax_facade(name):
    port = _port(name)
    jy = JaxYOLO(name)
    jy.variables = state_dict_to_variables(port.model)
    imgs = _images()
    ref = jy.predict(imgs, imgsz=128, batch=2)
    out = port.predict(imgs, imgsz=128, batch=2)
    assert len(out) == len(ref) == len(imgs)
    for r, o in zip(ref, out):
        assert o.orig_shape == r.orig_shape
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


def _batch(seed: int, b: int = 2, m: int = 4, nc: int = 80) -> dict:
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, nc, (b, m)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2))], -1)
    mask = np.ones((b, m), bool)
    mask[0, 3:] = False
    boxes[0, 3:] = 0
    return {"cls": cls, "bboxes": boxes.astype(np.float32), "mask": mask}


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolo12n.yaml"])
def test_step_loss_and_gradients_match_jax(name):
    port = _port(name)
    model = port.model.eval()  # BatchNorm frozen; the head's maps are the same in both modes
    v = state_dict_to_variables(model)
    jy = JaxYOLO(name)
    x = np.random.RandomState(3).rand(2, 128, 128, 3).astype(np.float32)
    batch = _batch(4)
    jcfg = jloss.DetectionLossCfg(nc=80, strides=tuple(port.strides), tal_dtype="float32")
    pcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(port.strides), tal_dtype="float32")

    def jax_loss(params):
        feats = jy.model.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=False)["feats"]
        total, parts, _ = jloss.detection_loss(feats, {k: jnp.asarray(a) for k, a in batch.items()}, jcfg,
                                               jloss.LossState.init())
        return total, parts

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(v["params"])
    feats = model(torch.from_numpy(x).permute(0, 3, 1, 2))["feats"]
    ptotal, pparts, _ = ploss.detection_loss(feats, {k: torch.from_numpy(a) for k, a in batch.items()}, pcfg,
                                             ploss.LossState.init("cpu"))
    ptotal.backward()
    assert float(pparts["fg_count"]) == float(jparts["fg_count"]) > 0
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    grads = state_dict_to_variables(model, {n: p.grad for n, p in model.named_parameters()})["params"]
    jflat = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    pflat = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert pflat.keys() == jflat.keys()
    for path, g in jflat.items():
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert np.abs(pflat[path] - g).max() <= 1e-4 * scale + 1e-12, jax.tree_util.keystr(path)


def _narrow_cfg(name: str) -> dict:
    d, _ = load_model_dict(name)
    if name == "yolov9e.yaml":
        return narrow_v9e(d)
    d["scales"]["l"] = [0.5, 0.25, 1024]
    return d


@pytest.mark.parametrize("name,scale", [("yolo12l.yaml", "l"), ("yolov9e.yaml", None)])
def test_optimizer_groups_match_jax(name, scale):
    """Every parameter's group equals the JAX label of its flax leaf; A2C2f's
    ``gamma`` decays, CBLinear's conv kernel decays and its bias is a bias."""
    model, _, _ = build_model(_narrow_cfg(name), scale=scale, device="cpu")
    groups = param_groups(model)
    decay, norm, bias = _param_group_masks(state_dict_to_variables(model)["params"])
    assert len(jax.tree_util.tree_leaves(decay)) == len(groups)
    for n, g in groups.items():
        path = key_to_flax(model, n)[1]
        d, nm, b = (functools.reduce(lambda t, k: t[k], path, tree) for tree in (decay, norm, bias))
        assert g == ("decay" if d else "norm" if nm else "bias" if b else "?"), n
    if name == "yolo12l.yaml":
        assert groups["model.6.gamma"] == "decay"
    else:
        assert groups["model.10.conv.weight"] == "decay" and groups["model.10.conv.bias"] == "bias"


@pytest.mark.parametrize("strides", [(4, 8, 16, 32), (8, 16, 32, 64)])
def test_detection_loss_on_four_levels_matches_jax(strides):
    rng = np.random.RandomState(5)
    imgsz, nc = 128, 3
    feats = [rng.normal(0, 1.5, (2, imgsz // s, imgsz // s, 64 + nc)).astype(np.float32) for s in strides]
    batch = _batch(6, nc=nc)
    jcfg = jloss.DetectionLossCfg(nc=nc, strides=strides, tal_dtype="float32")
    pcfg = ploss.DetectionLossCfg(nc=nc, strides=strides, tal_dtype="float32")
    jtotal, jparts, _ = jax.jit(jloss.detection_loss, static_argnums=(2,))(
        [jnp.asarray(f) for f in feats], {k: jnp.asarray(a) for k, a in batch.items()}, jcfg, jloss.LossState.init())
    ptotal, pparts, _ = ploss.detection_loss([torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats],
                                             {k: torch.from_numpy(a) for k, a in batch.items()}, pcfg,
                                             ploss.LossState.init("cpu"))
    assert float(pparts["fg_count"]) == float(jparts["fg_count"]) > 0
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,data,task", [("yolov8n-p2.yaml", "tiny_dataset", "detect"),
                                            ("yolov8n-pose-p6.yaml", "tiny_pose_dataset", "pose"),
                                            ("yolov8n-seg-p6.yaml", "tiny_seg_dataset", "segment")])
def test_train_runs_on_the_new_heads(name, data, task, request, tmp_path):
    """One epoch of ``YOLO.train`` on the CPU at 64 px on four-level heads:
    finite losses, the task read from the head, the epoch's val run."""
    y = YOLO(name, device="cpu")
    out = y.train(data=request.getfixturevalue(data), epochs=1, batch=2, imgsz=64, project=str(tmp_path / "runs"),
                  plots=False, verbose=False)
    assert out["epochs_run"] == 1 and y.task == task and len(y.strides) == 4
    assert all(np.isfinite(v) for r in out["results"] for k, v in r.items() if k.startswith("train/"))


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov9t.yaml"])
def test_track_runs_on_a_legacy_head(name):
    """``YOLO.track`` (ByteTrack) over three frames of a v8-era model: a
    (Results, tracks) pair a frame, tracks of 7 columns."""
    frames = [np.roll(_images(1)[0], 4 * i, axis=1) for i in range(3)]
    out = _port(name).track(frames, imgsz=128)
    assert len(out) == 3
    for r, tracks in out:
        assert len(r) > 0 and tracks.ndim == 2 and tracks.shape[1] == 7
