"""``YOLO.train`` for the segment, pose and OBB heads on the CPU: one epoch
of yolo11n-seg/-pose/-obb at 64 px (mosaic on) on PNG copies of the tiny task datasets,
with the task's loss, the train augment of polygons, keypoints and corners
(``copy_paste`` on segment), the task validator on the EMA model after the
epoch, and checkpoints. A pose dataset with ``kpt_shape: [4, 2]`` rebuilds
the head (the model's default is 17 x 3), and the checkpoints record it:
``YOLO(best)`` and ``YOLO.load`` rebuild that head. The reloaded ``best``
gives the run's fitness within 1e-9.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.utils.checkpoint import is_checkpoint
from test_torch_data import png_copy

torch.set_num_threads(2)

TASKS = {  # task -> (dataset fixture, model, the result families of results.csv)
    "segment": ("tiny_seg_dataset", "yolo11n-seg.yaml", ("B", "M")),
    "pose": ("tiny_pose_dataset", "yolo11n-pose.yaml", ("B", "P")),
    "obb": ("tiny_obb_dataset", "yolo11n-obb.yaml", ("B",)),
}
KW = dict(epochs=1, batch=4, imgsz=64, workers=2, verbose=False, max_labels=8, close_mosaic=0)


def pose_2d_copy(yaml_path: str, dest: Path) -> str:
    """The pose dataset with x, y keypoints only (``kpt_shape: [4, 2]``) and a
    left-right swap map."""
    text = Path(png_copy(yaml_path, dest)).read_text()
    for f in (dest / "labels").rglob("*.txt"):
        rows = []
        for line in f.read_text().splitlines():
            v = line.split()
            kp = np.array(v[5:], float).reshape(-1, 3)[:, :2].ravel()
            rows.append(" ".join(v[:5] + [f"{x:.4f}" for x in kp]))
        f.write_text("\n".join(rows) + "\n")
    (dest / "data.yaml").write_text(text.replace("kpt_shape: [4, 3]", "kpt_shape: [4, 2]\nflip_idx: [1, 0, 3, 2]"))
    return str(dest / "data.yaml")


def assert_run(res: dict, families: tuple) -> dict:
    assert res["epochs_run"] == 1 and len(res["results"]) == 1
    row = res["results"][0]
    for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss"):
        assert math.isfinite(row[k]) and row[k] > 0, k
    for tag in families:
        for k in ("precision", "recall", "mAP50", "mAP50-95"):
            assert 0 <= row[f"metrics/{k}({tag})"] <= 1
    assert 0 <= row["fitness"] <= 1
    save_dir = Path(res["save_dir"])
    header = (save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert header[:5] == ["epoch", "time", "train/box_loss", "train/cls_loss", "train/dfl_loss"]
    assert all(f"metrics/mAP50({tag})" in header for tag in families) and "fitness" in header
    for w in ("last", "best"):
        assert is_checkpoint(save_dir / "weights" / w)
    return row


@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_train_one_epoch(task, request, tmp_path):
    fixture, model, families = TASKS[task]
    data = png_copy(request.getfixturevalue(fixture), tmp_path / "data")
    extra = {"copy_paste": 0.5} if task == "segment" else {}
    yolo = YOLO(model, device="cpu")
    res = yolo.train(data, project=str(tmp_path / "runs"), **KW, **extra)
    row = assert_run(res, families)
    assert yolo.task == task and yolo.nc == (2 if task == "segment" else 1)
    best = Path(res["save_dir"]) / "weights" / "best"
    again = YOLO(str(best), device="cpu")
    assert again.task == task
    out = again.val(data, imgsz=64, batch=4, verbose=False)
    assert abs(out["fitness"] - row["fitness"]) <= 1e-9


def test_pose_train_rebuilds_the_head_for_the_data_kpt_shape(tiny_pose_dataset, tmp_path):
    data = pose_2d_copy(tiny_pose_dataset, tmp_path / "data")
    yolo = YOLO("yolo11n-pose.yaml", device="cpu")
    assert yolo.model.detect.kpt_shape == (17, 3)
    res = yolo.train(data, project=str(tmp_path / "runs"), **KW)
    assert_run(res, ("B", "P"))
    assert yolo.model.detect.kpt_shape == (4, 2) and yolo.yaml_overrides == {"kpt_shape": [4, 2]}
    best = Path(res["save_dir"]) / "weights" / "best"
    assert json.loads((best / "meta.json").read_text())["yaml_overrides"] == {"kpt_shape": [4, 2]}
    again = YOLO(str(best), device="cpu")
    assert again.model.detect.kpt_shape == (4, 2)
    sd, sd2 = yolo.model.state_dict(), again.model.state_dict()
    assert sd.keys() == sd2.keys() and all(torch.equal(sd[k], sd2[k]) for k in sd)
    yolo.fuse().save(tmp_path / "folded")  # a folded save reloads folded with the 4 x 2 head
    folded = YOLO(str(tmp_path / "folded"), device="cpu")
    assert folded.folded and folded.model.detect.kpt_shape == (4, 2)
    folded.load(best)  # unfolds: rebuilt with the override, then loaded
    assert not folded.folded and folded.model.detect.kpt_shape == (4, 2)
    r = again.predict(np.full((64, 64, 3), 90, np.uint8), imgsz=64, conf=0.0)[0]
    assert r.keypoints.data.shape[1:] == (4, 2)

