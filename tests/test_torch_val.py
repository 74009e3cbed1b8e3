"""The port's ``YOLO.val`` against the JAX facade's on the tiny dataset (4
val images of 96-160 px), as JPEG and as a PNG copy, yolo11n-fce at imgsz 160, batch
3 (two batches, the second padded with two copies), with the same bridged
float32 weights.

Random weights with ``bias_prior=False`` put every class score near 0.5,
so each image keeps 300 detections; the Detect head's box-branch bias is
raised by 4 on DFL bin 2 of every side so boxes are a few strides wide and
some match the labels (mAP above zero). Tolerance: per-image detection
counts and classes equal, confidences within 1e-5, P, R, mAP50 and
mAP50-95 within 1e-4 absolute, the confusion matrix equal. Two kinds of
near-tie could flip one result: scores at the 300th place (a detection
in or out), and two IoUs with one label within float error of each other
(the confusion matrix's greedy match sorts them with numpy's unstable sort;
equally sized boxes placed symmetrically about a label make such pairs, as
a bias of 6 did). On these inputs neither happens.
"""

import json

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.data.dataset import check_det_dataset
from fce_yolo_tpu_torch.engine.validator import DetectionValidator
from test_torch_data import png_copy
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)
KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness")


@pytest.fixture(scope="module")
def png_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png"))


@pytest.fixture(scope="module")
def variables():
    jy = JaxYOLO("yolo11n-fce.yaml")
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(1)))
    head = max((k for k in v["params"] if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    for name, branch in v["params"][head].items():
        if name.startswith("cv2_") and name.endswith("_2"):  # the last conv of each box branch
            branch["conv2d"]["bias"][2::16] += 4.0
    return v


@pytest.fixture(scope="module")
def jax_runs(png_dataset, tiny_dataset, variables):
    """The JAX facade's val on the PNG copy or the original JPEG files, each run once."""
    runs = {}

    def run(kind: str) -> dict:
        if kind not in runs:
            jy = JaxYOLO("yolo11n-fce.yaml")
            jy.variables = variables
            runs[kind] = jy.val(data=png_dataset if kind == "png" else tiny_dataset, imgsz=160, batch=3,
                                verbose=False)
        return runs[kind]

    return run


@pytest.fixture(scope="module")
def jax_results(jax_runs):
    return jax_runs("png")


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_val_matches_jax_facade(png_dataset, tiny_dataset, variables, jax_runs, kind, tmp_path, capsys):
    """On the PNG copy and on the original JPEG files (the port's plain JPEG
    decoder on the CPU model's device; bit-equal to cv2's, so the same
    pixels reach both models)."""
    jax_results = jax_runs(kind)
    data = png_dataset if kind == "png" else tiny_dataset
    port = YOLO("yolo11n-fce.yaml", device="cpu").load_jax_variables(variables)
    res = port.val(data=data, imgsz=160, batch=3, workers=2, save_json=tmp_path / "dets.json")
    assert port.names == {0: "circle", 1: "square", 2: "tri"}
    assert "all" in capsys.readouterr().out
    ref_stats, stats = jax_results["metrics"].stats, res["metrics"].stats
    assert len(stats["conf"]) == len(ref_stats["conf"]) == 4  # the padded copies do not count
    for k in ("pred_cls", "target_cls"):
        for out, ref in zip(stats[k], ref_stats[k]):
            np.testing.assert_array_equal(out, ref)
    for out, ref in zip(stats["conf"], ref_stats["conf"]):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert jax_results["metrics/mAP50(B)"] > 0
    for k in KEYS:
        assert abs(res[k] - jax_results[k]) <= 1e-4, (k, res[k], jax_results[k])
    np.testing.assert_array_equal(res["confusion_matrix"].matrix, jax_results["confusion_matrix"].matrix)
    dets = json.loads((tmp_path / "dets.json").read_text())
    assert len(dets) == sum(len(c) for c in stats["conf"]) and {d["image_id"] for d in dets} == {0, 1, 2, 3}


def test_validator_takes_the_model_off_train_mode(png_dataset, variables, jax_results):
    """A model left in train mode is validated in eval mode and handed back
    in train mode; the validator alone (names from the data) gives the
    facade's numbers."""
    port = YOLO("yolo11n-fce.yaml", device="cpu").load_jax_variables(variables)
    port.model.train()
    names = check_det_dataset(png_dataset)["names"]
    res = DetectionValidator(port.model, names, imgsz=160, batch_size=3, workers=1)(data=png_dataset, verbose=False)
    assert port.model.training
    for k in KEYS:
        assert abs(res[k] - jax_results[k]) <= 1e-4, k
    assert res["metrics"].speed["inference"] > 0
