"""YOLOv10's training in the port against the JAX package: the
dual-assignment ``e2e_detect_loss`` (one-to-many with top-10 TAL, then
one-to-one with top-1 TAL on detached features) and its gradients against
``jax.grad``, the WIoU v3 state threaded through both calls, the optimizer's
groups of the v10 parameters, and ``YOLO.train`` with the epoch's
end-to-end val on the CPU (the JAX package's own v10 train test runs with
``val=False``: its validator cannot read a v10 head, ROADMAP queue 3, item 26).

Tolerance: loss parts within 1e-5 relative, fg counts and the WIoU mean
equal within 1e-6 relative, each parameter's gradient within 1e-4 of its
leaf's largest (``test_torch_families_train.py``'s bounds; float32, the
assigner's overlaps in float32, BatchNorm frozen so both sides normalise by
the same statistics).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train import task_losses as jtask
from fce_yolo_tpu.train.optim import _param_group_masks
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.nn.weights import key_to_flax, state_dict_to_variables
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import task_losses as ptask
from fce_yolo_tpu_torch.train.optim import param_groups
from test_torch_families_train import _batch, _port
from test_torch_v10 import JAX_V10N
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def v10n_port():
    return _port("yolov10n.yaml")


def test_e2e_loss_and_gradients_match_jax(v10n_port):
    """WIoU v3 from a fresh state: the one-to-many call sets the running
    mean, the one-to-one call reads it and moves it again; parts of both
    branches, their sums, the totals, the gradients and the state after the
    step equal JAX's. The one-to-one head's gradient comes from its own
    loss only, and the backbone's from the one-to-many loss only."""
    from fce_yolo_tpu.api import YOLO as JaxYOLO

    model = v10n_port.model.eval()
    v = state_dict_to_variables(model)
    jy = JaxYOLO(JAX_V10N)
    x = np.random.RandomState(3).rand(2, 128, 128, 3).astype(np.float32)
    batch = _batch(4)
    jcfg = jloss.DetectionLossCfg(nc=80, strides=tuple(v10n_port.strides), iou_type="WIoU", tal_dtype="float32")
    pcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(v10n_port.strides), iou_type="WIoU", tal_dtype="float32")

    def jax_loss(params):
        out = jy.model.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=False)
        total, parts, state = jtask.e2e_detect_loss(out, {k: jnp.asarray(a) for k, a in batch.items()}, jcfg,
                                                    jloss.LossState.init())
        return total, (parts, state)

    (jtotal, (jparts, jstate)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(v["params"])
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    ptotal, pparts, pstate = ptask.e2e_detect_loss(out, tbatch, pcfg, ploss.LossState.init("cpu"))
    ptotal.backward()
    assert set(pparts) == set(jparts)
    for branch in ("one2many", "one2one"):
        assert float(pparts[f"{branch}_fg_count"]) == float(jparts[f"{branch}_fg_count"]) > 0
    assert float(pparts["one2one_fg_count"]) < float(pparts["one2many_fg_count"])  # top-1 against top-10
    for k in jparts:
        if not k.endswith("fg_count"):
            np.testing.assert_allclose(pparts[k].item(), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(pstate.wiou_loss_mean), float(jstate.wiou_loss_mean), rtol=1e-6)
    grads = state_dict_to_variables(model, {n: p.grad for n, p in model.named_parameters()})["params"]
    jflat = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    pflat = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert pflat.keys() == jflat.keys()
    for path, g in jflat.items():
        g = np.asarray(g)
        assert np.abs(pflat[path] - g).max() <= 1e-4 * float(np.abs(g).max()) + 1e-12, jax.tree_util.keystr(path)

    # the one-to-one loss alone moves only its own head; the state after the
    # step depends on the order: one-to-one first gives another mean
    model.zero_grad()
    ploss.detection_loss(model(torch.from_numpy(x).permute(0, 3, 1, 2))["one2one_feats"], tbatch,
                         pcfg._replace(tal_topk=1), ploss.LossState.init("cpu"))[0].backward()
    moved = {n for n, p in model.named_parameters() if p.grad is not None and p.grad.abs().sum() > 0}
    assert moved and all(n.startswith("model.23.one2one_") for n in moved)
    _, _, s1 = ploss.detection_loss(out["one2one_feats"], tbatch, pcfg._replace(tal_topk=1),
                                    ploss.LossState.init("cpu"))
    _, _, swapped = ploss.detection_loss(out["feats"], tbatch, pcfg, s1)
    assert abs(float(swapped.wiou_loss_mean) - float(pstate.wiou_loss_mean)) > 1e-4


def test_task_loss_for_picks_the_dual_loss_for_a_v10_head():
    """As the JAX ``YOLO.train`` (api.py:674-677): a detect model whose head is
    v10Detect trains with ``e2e_detect_loss``, any other detect model with
    ``detection_loss``."""
    cfg = ploss.DetectionLossCfg()
    assert ptask.task_loss_for("detect", cfg, end2end=True) == (ptask.e2e_detect_loss, ())
    assert ptask.task_loss_for("detect", cfg) == (None, ())


def test_optimizer_groups_match_jax(v10n_port):
    """Every yolov10n parameter's group (the one-to-one head, RepVGGDW's
    branches, PSA's attention) equals the JAX label of its flax leaf."""
    model = v10n_port.model
    groups = param_groups(model)
    decay, norm, bias = _param_group_masks(state_dict_to_variables(model)["params"])
    assert len(jax.tree_util.tree_leaves(decay)) == len(groups)
    for n, g in groups.items():
        path = key_to_flax(model, n)[1]
        d, nm, b = (functools.reduce(lambda t, k: t[k], path, tree) for tree in (decay, norm, bias))
        assert g == ("decay" if d else "norm" if nm else "bias" if b else "?"), n
    assert groups["model.23.one2one_cv2.0.2.weight"] == "decay"
    assert groups["model.22.m.0.cv1.2.conv.bn.weight"] == "norm"


def test_train_runs_with_the_end_to_end_val(tiny_dataset, tmp_path):
    """One epoch of ``YOLO.train`` of yolov10n on the CPU at 64 px: the dual
    loss (finite), then the epoch's val on the EMA model end to end, which
    the JAX facade cannot run; the best weights reload with the v10 head."""
    y = YOLO("yolov10n.yaml", device="cpu")
    out = y.train(data=tiny_dataset, epochs=1, batch=4, imgsz=64, project=str(tmp_path / "runs"), plots=False,
                  verbose=False)
    row = out["results"][0]
    assert out["epochs_run"] == 1 and y.nc == 3
    assert all(np.isfinite(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss"))
    assert "metrics/mAP50(B)" in row and np.isfinite(row["fitness"])
    back = YOLO(out["save_dir"] + "/weights/last", device="cpu")
    assert back.spec.layers[-1].name == "v10Detect"
    r = back.predict(np.full((64, 64, 3), 128, np.uint8), imgsz=64, conf=0.0)[0]
    assert len(r) == 8 * 8 + 4 * 4 + 2 * 2 and np.isfinite(r.boxes.xyxy).all()  # k = min(300, anchors)
