"""The port's train step against the JAX package's ``make_train_step``:
yolo11n-fce at 64 px, B=2, float32, SGD with the warmup accumulate ramp and
WIoU v3, from the same weights (the port's initialisation, bridged to flax)
and the same batches, with the assigner's overlaps stored in float32 on
both sides.

Tolerances:
- frozen BatchNorm, 3 steps: loss parts within 1e-5 relative, fg counts
  equal, the WIoU running mean within 1e-6 relative, every parameter within
  1e-4 of its leaf's largest update (plus 1e-12 absolute, for leaves whose
  gradient vanishes, such as the attention key biases);
- training BatchNorm, 1 step: the running statistics within 1e-5, the mean
  measured against the running standard deviation and the variance against
  itself. At 64 px the deepest maps are 2x2 (8 values a channel at B=2), and
  normalising by such batch statistics amplifies float32 rounding in the
  forward to ~1e-4 of a running mean's largest value; so the mean is held in
  units of the channel's spread, where it is ~3e-6 (the BatchNorm module
  alone is held to flax's within 1e-6 in ``test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train import optim as jopt
from fce_yolo_tpu.train import trainer as jtrainer
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.nn.model import init_weights
from fce_yolo_tpu_torch.nn.weights import variables_to_state_dict
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import optim as popt
from fce_yolo_tpu_torch.train import trainer as ptrainer
from test_torch_train import (B, FLAT_OPT, STEPS, flat_mosaic_batch, float64_step, make_batches,  # noqa: F401
                              png_dataset, step_distance, to_flax)
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def start():
    """yolo11n-fce's initial weights (the port's init from seed 1) and the JAX model."""
    port = YOLO("yolo11n-fce.yaml", device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(1))
    return to_flax(port.model), JaxYOLO("yolo11n-fce.yaml")


OPT = dict(optimizer="SGD", lr0=0.01, batch_size=B, epochs=2, steps_per_epoch=STEPS, nc=80)


def run_jax(jy, variables, batches, frozen_bn):
    cfg = jopt.OptimCfg(**OPT)
    bounds, ni_map = jopt.boundary_schedule(cfg)
    acc = jopt.accumulate_steps(cfg)
    tx = jopt.build_optimizer(cfg, variables["params"], ni_map=ni_map)
    state = jtrainer.create_train_state(jy.model, variables, tx, accumulate=acc)
    lcfg = jloss.DetectionLossCfg(nc=80, strides=(8, 16, 32), iou_type="WIoU", tal_dtype="float32")
    step = jax.jit(jtrainer.make_train_step(jy.model, tx, lcfg, accumulate=acc, frozen_bn=frozen_bn,
                                            boundaries=bounds))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({**jax.tree_util.tree_map(float, m), "wiou": float(state.loss_state.wiou_loss_mean)})
    return jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}), metrics


def run_port(variables, batches, frozen_bn):
    port = YOLO("yolo11n-fce.yaml", device="cpu").load_jax_variables(variables)
    cfg = popt.OptimCfg(**OPT)
    bounds, ni_map = popt.boundary_schedule(cfg)
    acc = popt.accumulate_steps(cfg)
    opt = popt.Optimizer(cfg, port.model, ni_map=ni_map)
    state = ptrainer.create_train_state(port.model, opt, accumulate=acc)
    lcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(port.strides), iou_type="WIoU", tal_dtype="float32")
    step = ptrainer.make_train_step(port.model, opt, lcfg, accumulate=acc, frozen_bn=frozen_bn, boundaries=bounds)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()} | {"wiou": float(state.loss_state.wiou_loss_mean)})
    return port.model.state_dict(), metrics


def test_frozen_bn_trajectory_matches_jax(start):
    variables, jy = start
    batches = make_batches(STEPS)
    ref, ref_m = run_jax(jy, variables, batches, frozen_bn=True)
    sd, m = run_port(variables, batches, frozen_bn=True)
    for step, (a, r) in enumerate(zip(m, ref_m)):
        for k in ("box", "cls", "dfl", "loss"):
            assert abs(a[k] - r[k]) <= 1e-5 * abs(r[k]), (step, k, a[k], r[k])
        assert a["fg_count"] == r["fg_count"] > 0
        assert abs(a["wiou"] - r["wiou"]) <= 1e-6 * abs(r["wiou"])
        assert a["finite"] and r["finite"] == 1.0
    p0 = variables_to_state_dict(variables)
    for key, r in variables_to_state_dict(ref).items():
        if "running" in key:
            np.testing.assert_array_equal(sd[key].numpy(), r.numpy())  # frozen: never updated
            continue
        dp = float((r - p0[key]).abs().max())
        assert float((sd[key] - r).abs().max()) <= 1e-4 * dp + 1e-12, key
    assert sum(float((r - p0[k]).abs().max()) > 0 for k, r in variables_to_state_dict(ref).items()) > 100


def test_training_bn_step_matches_jax(start):
    variables, jy = start
    batches = make_batches(1, seed=1)
    ref, ref_m = run_jax(jy, variables, batches, frozen_bn=False)
    sd, m = run_port(variables, batches, frozen_bn=False)
    for k in ("box", "cls", "dfl"):  # the amplification of the module docstring, at 1e-3
        assert abs(m[0][k] - ref_m[0][k]) <= 1e-3 * abs(ref_m[0][k]), k
    stats = variables_to_state_dict({"batch_stats": ref["batch_stats"]})
    for key, r in stats.items():
        if key.endswith("running_var"):
            continue
        var_key = key.replace("running_mean", "running_var")
        rv = stats[var_key]
        assert float((sd[key] - r).abs().max() / rv.sqrt().min()) <= 1e-5, key
        assert float(((sd[var_key] - rv).abs() / rv).max()) <= 1e-5, var_key
    moved = [k for k, r in stats.items() if float((r - variables_to_state_dict(variables)[k]).abs().max()) > 1e-3]
    assert len(moved) > 100  # the step did move the statistics


def test_training_bn_step_on_flat_images_jax_strays_from_float64(start, png_dataset):
    """On a flat-colour mosaic batch (160 px, B=2) the JAX package's float32
    step with training BatchNorm computes the same step as the port's
    float64 one (updates within 5e-2 of the largest) but strays from it by
    more than 1e-3 (3.5e-3 is seen), over three times the 3e-4 the port's
    float32 step is held to and ~90 times the 4e-5 it shows
    (``test_torch_train.py``): flax takes the batch variance as E[x^2] -
    E[x]^2 in float32, which cancels on flat maps; the port's BatchNorm
    takes torch's two-pass statistics. A difference on purpose (ROADMAP
    queue 3)."""
    variables, jy = start
    batch = flat_mosaic_batch(png_dataset)
    sd0 = variables_to_state_dict(variables)
    ref, _ = float64_step(sd0, batch)
    cfg = jopt.OptimCfg(**FLAT_OPT)
    tx = jopt.build_optimizer(cfg, variables["params"])
    state = jtrainer.create_train_state(jy.model, variables, tx, accumulate=1)
    lcfg = jloss.DetectionLossCfg(nc=80, strides=(8, 16, 32), tal_dtype="float32")
    step = jax.jit(jtrainer.make_train_step(jy.model, tx, lcfg, accumulate=1, frozen_bn=False))
    state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert float(m["finite"]) == 1.0
    got = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                                      "batch_stats": state.batch_stats}))
    du, bn = step_distance(got, ref, sd0)
    assert 1e-3 < du < 5e-2, (du, bn)
