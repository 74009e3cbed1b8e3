"""The port's train step with each task loss against the JAX package's
``make_train_step(task_loss=...)``: yolo11n-seg, -pose (4 keypoints with
visibility) and -obb at 128 px, B=2, float32, training BatchNorm, SGD with
the warmup accumulate ramp, two steps, from the same weights (the port's
initialisation, bridged to flax) and the same batches, with the assigner's
overlaps stored in float32 on both sides.

Training BatchNorm, because the JAX package's frozen-BN step runs its heads
in eval mode, whose outputs carry no mask coefficients or keypoints. Its
batch statistics amplify float32 rounding (``test_torch_train_step.py``), so
at 128 px (4x4 deepest maps at B=2) the tolerances after two steps are: loss
parts within 1e-4 relative (1.3e-5 seen), foreground counts equal, every
parameter within 1e-3 of the model's largest update (1.6e-4 seen), and each
leaf that moved by more than 1e-3 of it within 2e-3 of its own largest
update plus two float32 ulps of its values (2.1e-4 seen). Leaves that hardly
move (the attention block's BN biases, ~4e-10 at 4x4 maps) are held by the
first bound only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train import optim as jopt
from fce_yolo_tpu.train import task_losses as jtask
from fce_yolo_tpu.train import trainer as jtrainer
from fce_yolo_tpu_torch.cfg.models import MODELS
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from fce_yolo_tpu_torch.nn.weights import key_to_flax, variables_to_state_dict
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import optim as popt
from fce_yolo_tpu_torch.train import task_losses as ptask
from fce_yolo_tpu_torch.train import trainer as ptrainer
from test_torch_modules import jax_detection_model

torch.set_num_threads(1)
IMGSZ, B, M, STEPS, NC = 128, 2, 6, 2, 2
KPT = (4, 3)
TASKS = {"segment": ("yolo11-seg", {}), "pose": ("yolo11-pose", {"kpt_shape": list(KPT)}), "obb": ("yolo11-obb", {})}
OPT = dict(optimizer="SGD", lr0=0.01, batch_size=B, epochs=2, steps_per_epoch=STEPS, nc=NC)


def to_flax(model: torch.nn.Module) -> dict:
    """The port's weights as flax variables (numpy): conv kernels HWIO, the
    Proto's transposed-convolution kernel (kh, kw, in, out) flipped in both
    spatial axes (the inverse of ``variables_to_state_dict``)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        coll, path = key_to_flax(model, name)
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = t.detach().numpy().copy()
        if a.ndim == 4:
            convt = isinstance(model.get_submodule(name.rpartition(".")[0]), torch.nn.ConvTranspose2d)
            a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if convt else a.transpose(2, 3, 1, 0)
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def make_batches(task: str, n: int, seed: int = 0) -> list[dict]:
    """Random images with 1-3 instances each: rectangles as masks at 1/4
    resolution (segment), 4 keypoints with visibility 0-2 (pose), rotated
    boxes (obb)."""
    rng = np.random.RandomState(seed)
    out = []
    hm = IMGSZ // 4
    ys, xs = np.mgrid[:hm, :hm]
    for _ in range(n):
        cls, mask = np.zeros((B, M), np.float32), np.zeros((B, M), bool)
        boxes = np.zeros((B, M, 5 if task == "obb" else 4), np.float32)
        masks, kpts = np.zeros((B, M, hm, hm), np.float32), np.zeros((B, M, *KPT), np.float32)
        for i in range(B):
            k = rng.randint(1, 4)
            cls[i, :k] = rng.randint(0, NC, k)
            mask[i, :k] = True
            boxes[i, :k, :4] = np.concatenate([rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.15, 0.4, (k, 2))], 1)
            if task == "obb":
                boxes[i, :k, 4] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, k)
            for j in range(k):
                cx, cy, w, h = boxes[i, j, :4] * hm
                masks[i, j] = (abs(xs + 0.5 - cx) < w / 2) & (abs(ys + 0.5 - cy) < h / 2)
                lo, hi = boxes[i, j, :2] - boxes[i, j, 2:4] / 2, boxes[i, j, :2] + boxes[i, j, 2:4] / 2
                kpts[i, j, :, :2] = rng.uniform(lo, hi, (KPT[0], 2))
                kpts[i, j, :, 2] = rng.randint(0, 3, KPT[0])
        b = {"img": rng.randint(0, 256, (B, IMGSZ, IMGSZ, 3), np.uint8), "cls": cls, "bboxes": boxes, "mask": mask}
        if task == "segment":
            b["masks"] = masks
        if task == "pose":
            b["keypoints"] = kpts
        out.append(b)
    return out


def run_jax(task, variables, batches):
    name, over = TASKS[task]
    model, _, strides = jax_detection_model({**MODELS[name], "nc": NC, **over}, scale="n")
    cfg = jopt.OptimCfg(**OPT)
    bounds, ni_map = jopt.boundary_schedule(cfg)
    acc = jopt.accumulate_steps(cfg)
    tx = jopt.build_optimizer(cfg, variables["params"], ni_map=ni_map)
    state = jtrainer.create_train_state(model, variables, tx, accumulate=acc)
    lcfg = jloss.DetectionLossCfg(nc=NC, strides=tuple(strides), tal_dtype="float32")
    task_loss = {"segment": jtask.segmentation_loss, "obb": jtask.obb_loss,
                 "pose": lambda o, b, c, s: jtask.pose_loss(o, b, jtask.PoseLossCfg(det=lcfg, kpt_shape=KPT), s)}[task]
    step = jax.jit(jtrainer.make_train_step(model, tx, lcfg, task_loss=task_loss, accumulate=acc, boundaries=bounds))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(jax.tree_util.tree_map(float, m))
    return jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}), metrics


def run_port(task, model, batches):
    cfg = popt.OptimCfg(**OPT)
    bounds, ni_map = popt.boundary_schedule(cfg)
    acc = popt.accumulate_steps(cfg)
    opt = popt.Optimizer(cfg, model, ni_map=ni_map)
    state = ptrainer.create_train_state(model, opt, accumulate=acc)
    lcfg = ploss.DetectionLossCfg(nc=NC, strides=tuple(model.strides), tal_dtype="float32")
    task_loss = {"segment": ptask.segmentation_loss, "obb": ptask.obb_loss,
                 "pose": lambda o, b, c, s: ptask.pose_loss(o, b, ptask.PoseLossCfg(det=lcfg, kpt_shape=KPT), s)}[task]
    step = ptrainer.make_train_step(model, opt, lcfg, accumulate=acc, boundaries=bounds, task_loss=task_loss)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return model.state_dict(), metrics


@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_train_step_trajectory_matches_jax(task):
    name, over = TASKS[task]
    model, _, _ = build_model({**MODELS[name], "nc": NC, **over}, scale="n", device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    variables = to_flax(model)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    back = variables_to_state_dict(variables)
    assert all(torch.equal(back[k], v) for k, v in sd0.items() if not k.endswith("num_batches_tracked"))
    batches = make_batches(task, STEPS, seed={"segment": 0, "pose": 1, "obb": 2}[task])
    ref, ref_m = run_jax(task, variables, batches)
    sd, m = run_port(task, model, batches)
    extra = {"segment": ("seg",), "pose": ("kpt", "kobj"), "obb": ()}[task]
    for step, (a, r) in enumerate(zip(m, ref_m)):
        assert a["finite"] and r["finite"] == 1.0
        assert a["fg_count"] == r["fg_count"] > 0, step
        for k in ("box", "cls", "dfl", "loss", *extra):
            assert abs(a[k] - r[k]) <= 1e-4 * abs(r[k]), (step, k, a[k], r[k])
    rows = []
    for key, r in variables_to_state_dict(ref).items():
        if "running" not in key:
            ulp = float(np.spacing(np.float32(float(r.abs().max()))))
            rows.append((key, float((sd[key] - r).abs().max()), float((r - sd0[key]).abs().max()), ulp))
    largest = max(dp for _, _, dp, _ in rows)
    assert sum(dp > 0 for _, _, dp, _ in rows) > 150
    for key, err, dp, ulp in rows:
        assert err <= 1e-3 * largest, (key, err, largest)
        if dp > 1e-3 * largest:
            assert err <= 2e-3 * dp + 2 * ulp, (key, err, dp)
