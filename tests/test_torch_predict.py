"""The port's YOLO.predict vs the JAX facade on the same bridged f32
weights and images, the JAX-free import path, and the letterbox.

Tolerance: counts and classes exact; boxes within 1e-3 px and scores within
1e-5 (f32 forward in both, summation order only). Images are non-square and
no larger than imgsz, so the letterbox (scaleup=False) pads without
resizing and both sides see identical pixels.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.data.augment import letterbox as jax_letterbox
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.data.augment import letterbox
from fce_yolo_tpu_torch.engine.results import Results

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]


@pytest.mark.parametrize("name", ["yolo11n-fce.yaml", "yolo11s.yaml"])
def test_predict_matches_jax_facade(name):
    jy = JaxYOLO(name)
    # bias_prior=False: scores sit near 0.5, so NMS works through every candidate
    jy.variables = jax.jit(lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(
        jax.random.PRNGKey(1))
    imgs = _images()
    ref = jy.predict(imgs, imgsz=128, batch=2)
    port = YOLO(name).load_jax_variables(jax.tree_util.tree_map(np.asarray, jy.variables))
    out = port.predict(imgs, imgsz=128, batch=2)
    assert len(out) == len(ref) == len(imgs)
    for r, o in zip(ref, out):
        assert o.orig_shape == r.orig_shape
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


def test_import_and_predict_without_jax_cv2_pil():
    """Every port module imports, and a CPU predict runs, with jax, flax,
    cv2, PIL, yaml and the JAX package blocked."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "fce_yolo_tpu"):
            sys.modules[m] = None
        import importlib, pkgutil
        import numpy as np
        import fce_yolo_tpu_torch
        for info in pkgutil.walk_packages(fce_yolo_tpu_torch.__path__, "fce_yolo_tpu_torch."):
            importlib.import_module(info.name)
        from fce_yolo_tpu_torch import YOLO
        img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
        res = YOLO("yolo11n-fce.yaml").predict([img, img], imgsz=64, batch=2)
        assert len(res) == 2 and res[0].boxes.data.shape[1] == 6
        print("ok", len(res[0]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("shape,imgsz,scaleup", [
    ((96, 128, 3), 128, False),  # pad only
    ((128, 80, 3), 128, False),
    ((200, 150, 3), 128, False),  # shrink
    ((60, 100, 3), 128, True),  # grow
])
def test_letterbox_matches_jax(shape, imgsz, scaleup):
    """Same ratio, padding and output size; pixels equal when nothing is
    resized, else within one level (cv2 resizes in fixed point, the port in
    float32)."""
    img = np.random.RandomState(3).randint(0, 256, shape, np.uint8)
    ref, r_ref, pad_ref = jax_letterbox(img, imgsz, scaleup=scaleup)
    out, r, pad = letterbox(img, imgsz, scaleup=scaleup)
    assert (r, pad) == (r_ref, pad_ref) and out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= (0 if r == 1 else 1)


def test_results_api():
    data = np.array([[10, 20, 50, 60, 0.9, 1], [0, 0, 8, 8, 0.5, 1], [5, 5, 9, 9, 0.4, 0]], np.float32)
    r = Results(np.zeros((100, 200, 3), np.uint8), "x", {0: "cat", 1: "dog"}, boxes=data)
    assert len(r) == 3 and r.orig_shape == (100, 200)
    np.testing.assert_allclose(r.boxes.xywh[0], [30, 40, 40, 40])
    np.testing.assert_allclose(r.boxes.xyxyn[0], [0.05, 0.2, 0.25, 0.6])
    assert r.verbose() == "1 cat, 2 dogs, "
    assert r.summary()[0]["name"] == "dog" and len(r[1:]) == 2
    assert '"confidence": 0.9' in r.to_json()
