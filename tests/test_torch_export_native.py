"""The port's native export (``engine/export_native.py``: ``torch.export``,
then ATen translated into the ``.fyir`` op set) run by the unedited C++
interpreter ``native/infer/fy_infer.cpp``, against the JAX package on the
same weights (the port's seeded weights carried to flax by
``nn/weights.py::state_dict_to_variables``, the class biases jittered as in
``tests/test_native_infer.py:44-55``):

- ``--raw`` against the JAX eager forward: ``rtol=1e-3, atol=2e-3`` (the
  bound of ``tests/test_native_infer.py:72``);
- image mode on a PPM: the rows from the port's artifact against the rows
  from the JAX exporter's artifact, in keep order: the same count and
  classes (top-5 classes for classify), every other column (boxes, scores,
  mask areas, keypoints, probabilities) within ``IMAGE_ATOL`` of the
  printed value, which is the print's own rounding (3 decimals for pixels,
  5 to 7 for scores) plus float noise between two graphs of the same model;
- the lowerings the yolo11 family does not reach (padding, average
  pooling, an unfolded BatchNorm) against the port's eager forward;
- an op outside the runtime's set raises at export time, naming it.

The image is noise (no flat region, whose anchors tie exactly and are
kept in an order that float noise decides), at the export size (the
letterbox is the identity).
"""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.engine.export_native import export_native as jax_export_native
from fce_yolo_tpu_torch.api import YOLO
from fce_yolo_tpu_torch.engine.export_native import export_native
from fce_yolo_tpu_torch.nn.autobackend import fy_infer_binary
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from test_torch_modules import jax_detection_model

IMGSZ = 64
RTOL, ATOL = 1e-3, 2e-3  # tests/test_native_infer.py:72
IMAGE_ATOL = 2e-3  # image mode: the printed rows' rounding (%.3f pixels) plus float noise
MODELS = {"yolo11": "yolo11n.yaml", "yolo11-fce": "yolo11n-fce.yaml", "segment": "yolo11n-seg.yaml",
          "pose": "yolo11n-pose.yaml", "classify": "yolo11n-cls.yaml"}
JAX_CFG = {"yolo11": "yolo11.yaml", "yolo11-fce": "yolo11-fce.yaml", "segment": "yolo11-seg.yaml",
           "pose": "yolo11-pose.yaml", "classify": "yolo11-cls.yaml"}


@pytest.fixture(scope="module")
def fy_infer():
    return fy_infer_binary()


def bridged(name: str):
    """(port facade, JAX model, flax variables) on the same weights: seed 0,
    each class conv's bias jittered by N(0, 1) (tests/test_native_infer.py:44-55)."""
    yolo = YOLO(MODELS[name], device="cpu")
    head = yolo.model.detect
    rng = np.random.RandomState(5)
    with torch.no_grad():
        convs = [branch[-1] for branch in head.cv3] if name != "classify" else [head.linear]
        for conv in convs:
            conv.bias += torch.from_numpy(rng.randn(*conv.bias.shape).astype(np.float32))
    jmodel, _, _ = jax_detection_model(f"fce_yolo_tpu/cfg/models/{JAX_CFG[name]}", "n", strides=yolo.strides)
    v = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(yolo.model))
    return yolo, jmodel, v


def run(exe, ir, *args) -> subprocess.CompletedProcess:
    return subprocess.run([str(exe), str(ir), str(ir.with_suffix(".fybin")), *map(str, args)], check=True,
                          capture_output=True, text=True, timeout=300)


def rows(stdout: str) -> np.ndarray:
    return np.array([[float(v) for v in line.split()] for line in stdout.splitlines()], np.float64)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_native_artifact_matches_jax(name, fy_infer, tmp_path):
    yolo, jmodel, v = bridged(name)
    ir = export_native(yolo.model, tmp_path / "port", imgsz=IMGSZ)
    header = ir.read_text().splitlines()[:3]
    assert header[0] == "FYIR 1" and header[1].startswith(f"meta task={yolo.task} nc={yolo.nc}")
    assert header[2].endswith(f" 4 1,{IMGSZ},{IMGSZ},3")
    if name == "pose":
        assert header[1].endswith(" kpt=17,3")

    # --raw against the JAX eager forward
    x = np.random.RandomState(0).rand(1, IMGSZ, IMGSZ, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, jnp.asarray(x))
    x.tofile(tmp_path / "in.f32")
    run(fy_infer, ir, "--raw", tmp_path / "in.f32", tmp_path / "out.f32")
    keys = ("probs",) if name == "classify" else ("preds", "proto") if name == "segment" else ("preds",)
    for i, k in enumerate(keys):
        r = np.asarray(ref[k])
        got = np.fromfile(tmp_path / ("out.f32" + (f".{i}" if i else "")), np.float32).reshape(r.shape)
        np.testing.assert_allclose(got, r, rtol=RTOL, atol=ATOL, err_msg=f"{name} {k}")

    # image mode: the port's artifact against the JAX exporter's
    jir = jax_export_native(jmodel, v, tmp_path / "jax", imgsz=IMGSZ)
    ppm = tmp_path / "img.ppm"
    rgb = np.random.RandomState(7).randint(0, 256, (IMGSZ, IMGSZ, 3), np.uint8)
    ppm.write_bytes(f"P6\n{IMGSZ} {IMGSZ}\n255\n".encode() + rgb.tobytes())
    ours, theirs = (rows(run(fy_infer, a, ppm, "0.001", "0.7").stdout) for a in (ir, jir))
    assert len(ours) == len(theirs) > 0, f"{name}: {len(ours)} rows, the JAX artifact {len(theirs)}"
    cls_col = 0 if name == "classify" else 5
    np.testing.assert_array_equal(ours[:, cls_col], theirs[:, cls_col])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=IMAGE_ATOL)


@pytest.mark.parametrize("name", ["yolov3-tiny.yaml", "yolov9t.yaml", "yolo11-cls-resnet18.yaml"])
def test_native_artifact_matches_the_port(name, fy_infer, tmp_path):
    """The lowerings the yolo11 family does not reach, against the port's own
    eager forward (held to JAX by the families tests): ``ZeroPad2d``'s
    ``constant_pad_nd`` (yolov3-tiny), ``AConv``/``ADown``'s ``avg_pool2d``
    (yolov9t), and the ResNet trunk's unfolded BatchNorm."""
    yolo = YOLO(name, device="cpu")
    ir = export_native(yolo.model, tmp_path / "port", imgsz=IMGSZ)
    x = np.random.RandomState(0).rand(1, IMGSZ, IMGSZ, 3).astype(np.float32)
    with torch.no_grad():
        out = yolo._inference_model()(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = out["probs" if yolo.task == "classify" else "preds"].numpy()
    x.tofile(tmp_path / "in.f32")
    run(fy_infer, ir, "--raw", tmp_path / "in.f32", tmp_path / "out.f32")
    got = np.fromfile(tmp_path / "out.f32", np.float32).reshape(ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_unsupported_op_raises_at_export_time(tmp_path):
    """The OBB head's angle decode calls cos and sin, which the runtime lacks
    (so does the JAX exporter's op set): the export raises naming the op."""
    yolo = YOLO("yolo11n-obb.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match=r"aten\.(cos|sin)\.default is not in the native runtime's op set"):
        export_native(yolo.model, tmp_path / "obb", imgsz=IMGSZ)
    assert not (tmp_path / "obb.fyir").exists()
