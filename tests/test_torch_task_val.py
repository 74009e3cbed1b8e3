"""The port's ``YOLO.val`` for segment, pose and OBB against the JAX facade
on the tiny task datasets (4 val images of 128 px, JPEG), the n scale at
imgsz 96, batch 3 (two batches, the second padded), with the same bridged
float32 weights (seed 1, no class prior) and the data's class count (pose:
4 keypoints).

The Detect trunk's box-branch bias is raised by 4 on one DFL bin of every
side (pose: bin 2; segment: bin 1, with positive prototypes and mask
coefficients so that each mask fills its box; OBB: bin 2 left and right,
bin 1 above and below, and the angle branch's bias set to an angle of 0),
so boxes are a few strides wide and some match the labels (box mAP50, and
for segment mask mAP50, above zero). Tolerance: per-image detection counts
and classes equal,
confidences within 1e-5, P, R, mAP50 and mAP50-95 of every family (B, and
M, P, or the rotated one, which the JAX package tags B) within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg.models import MODELS
from fce_yolo_tpu_torch.nn.model import build_model
from test_torch_modules import jax_detection_model, jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)

TASKS = {  # task -> (dataset fixture, model config, overrides, metric families)
    "segment": ("tiny_seg_dataset", "yolo11-seg", {"nc": 2}, ("B", "M")),
    "pose": ("tiny_pose_dataset", "yolo11-pose", {"nc": 1, "kpt_shape": [4, 3]}, ("B", "P")),
    "obb": ("tiny_obb_dataset", "yolo11-obb", {"nc": 1}, ("B",)),
}
IMGSZ, BATCH = 96, 3


def task_pair(task: str):
    """(JAX facade, port facade) of ``task`` at n with the data's class count and the same weights."""
    _, name, over, _ = TASKS[task]
    cfg = {**MODELS[name], **over}
    jy = JaxYOLO(f"{name.replace('yolo11', 'yolo11n')}.yaml", nc=over["nc"])
    jy.model, jy.spec, jy.strides = jax_detection_model(cfg, scale="n")
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(1)))
    head = max((k for k in v["params"] if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    for br, branch in v["params"][head]["detect"].items():
        if br.startswith("cv2_") and br.endswith("_2"):  # the last conv of each box branch
            bias = branch["conv2d"]["bias"]
            if task == "obb":  # long thin boxes near angle 0 (sigmoid 0.25), like the labels
                bias[[2, 17, 34, 49]] += 4.0  # DFL bins: l 2, t 1, r 2, b 1
            else:
                bias[(1 if task == "segment" else 2)::16] += 4.0
    for br, branch in v["params"][head].items():
        if br.startswith("cv4_") and br.endswith("_2"):  # the last conv of each extra branch
            if task == "obb":
                branch["conv2d"]["bias"][:] = np.log(0.25 / 0.75)
            elif task == "segment":  # positive coefficients on positive prototypes: each mask fills its box
                branch["conv2d"]["bias"][:] += 1.0
    if task == "segment":
        v["params"][head]["proto"]["cv3"]["bn"]["bias"][:] += 5.0
    jy.variables = v
    port = YOLO(f"{name.replace('yolo11', 'yolo11n')}.yaml", device="cpu", nc=over["nc"])
    port.model, port.spec, port.strides = build_model(cfg, scale="n", device="cpu")
    return jy, port.load_jax_variables(v)


@pytest.fixture(scope="module")
def runs(request):
    """Each task's JAX and port val, run once."""
    done = {}

    def run(task: str):
        if task not in done:
            data = request.getfixturevalue(TASKS[task][0])
            jy, port = task_pair(task)
            ref = jy.val(data=data, imgsz=IMGSZ, batch=BATCH, verbose=False)
            out = port.val(data=data, imgsz=IMGSZ, batch=BATCH, workers=2, verbose=False)
            done[task] = (ref, out, port)
        return done[task]

    return run


def _families(res: dict, task: str) -> list:
    m = res["metrics"]
    return list(m.values()) if isinstance(m, dict) else [m]


@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_val_matches_jax_facade(runs, task):
    ref, out, port = runs(task)
    assert port.names == {i: v for i, v in enumerate(["a", "b"] if task == "segment" else ["obj"])}
    for tag in TASKS[task][3]:
        for k in ("precision", "recall", "mAP50", "mAP50-95"):
            key = f"metrics/{k}({tag})"
            assert abs(out[key] - ref[key]) <= 1e-4, (key, out[key], ref[key])
    assert abs(out["fitness"] - ref["fitness"]) <= 1e-4
    assert ref["metrics/mAP50(B)"] > 0 and ref.get("metrics/mAP50(M)", 1) > 0
    for fo, fr in zip(_families(out, task), _families(ref, task)):
        assert len(fo.stats["conf"]) == len(fr.stats["conf"]) == 4  # the padded copies do not count
        for k in ("pred_cls", "target_cls"):
            for a, b in zip(fo.stats[k], fr.stats[k]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(fo.stats["conf"], fr.stats["conf"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_task_validator_takes_the_model_off_train_mode(runs, tiny_obb_dataset):
    """The task validators run the base pass: a model left in train mode is
    validated in eval mode and handed back in train mode, with the facade's numbers."""
    from fce_yolo_tpu_torch.engine.task_validators import OBBValidator

    ref, out, port = runs("obb")
    port.model.train()
    res = OBBValidator(port.model, port.names, imgsz=IMGSZ, batch_size=BATCH, workers=1)(data=tiny_obb_dataset,
                                                                                        verbose=False)
    assert port.model.training
    assert res["metrics/mAP50-95(B)"] == out["metrics/mAP50-95(B)"]
    port.model.eval()


def test_task_val_refuses_a_class_count_it_cannot_split(tiny_seg_dataset):
    """A task head's class scores and extras share one output: an 80-class
    head on 2-class data is refused (the JAX validators would misread it)."""
    with pytest.raises(ValueError, match="class count"):
        YOLO("yolo11n-seg.yaml", device="cpu").val(data=tiny_seg_dataset, imgsz=64, batch=2, verbose=False)
