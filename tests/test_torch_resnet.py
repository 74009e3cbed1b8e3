"""The ``TorchVision`` ResNet trunks and ``yolo11-cls-resnet18`` in the port
against the JAX package (``fce_yolo_tpu/nn/resnet.py``): the trunks' layout
and forward on a torchvision-layout state dict (read unchanged by the JAX
importer ``resnet_state_dict_to_variables``), the BatchNorm constants
(torchvision's eps 1e-5 and momentum 0.1, flax's 0.9) in a training-mode
step, the bridge both ways, the fold that leaves the trunk's BatchNorms,
and ``YOLO.predict``/``YOLO.val`` against the JAX facade and a CPU train.

Tolerance: max|port - jax| <= 1e-5 * max|jax| on every float output, as
``test_torch_modules.py``; running statistics within 1e-6 relative;
probabilities within 1e-5 (``test_torch_classify.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.nn import resnet as JR
from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold_conv_bn
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.nn import resnet as PR
from fce_yolo_tpu_torch.nn.model import fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables, variables_to_state_dict
from test_torch_classify import _assert_same_probs
from test_torch_modules import _close, _nchw_to_nhwc, jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)


def _randomize(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded conv weights and random BatchNorm statistics and affines."""
    init_weights(model, torch.Generator().manual_seed(seed), bias_prior=False)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    return model.eval()


@pytest.mark.parametrize("variant,hw", [("resnet18", (64, 48)), ("resnet34", (32, 32)), ("resnet50", (40, 32))])
def test_trunk_matches_flax_on_a_torchvision_state_dict(variant, hw):
    """The trunk's ``state_dict`` has torchvision's keys (``conv1.weight``,
    ``layer2.0.downsample.1.running_var``, ...), every one of which the JAX
    importer reads, filling the flax trunk's whole tree; both give the same
    stage-4 map."""
    trunk = _randomize(PR.ResNetTrunk(variant))
    sd = {k: t.numpy() for k, t in trunk.state_dict().items()}
    assert "layer2.0.downsample.0.weight" in sd
    assert ("layer1.0.downsample.0.weight" in sd) == (variant == "resnet50")  # 64 -> 256 channels there
    v = JR.resnet_state_dict_to_variables(sd, variant)
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    jm = JR.ResNetTrunk(variant)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(v)
    ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        out = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ref, _nchw_to_nhwc(out))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_block_batchnorm_step_uses_torchvision_constants(block):
    """A training-mode forward of a stride-2 block with its downsample: the
    output and every BatchNorm's new running statistics equal flax's
    (momentum 0.9, eps 1e-5, the biased batch variance); YOLO's own
    1e-3 / 0.03 would miss them. (A whole trunk's last stages see 4-16
    values a channel at these sizes, where flax's one-pass variance strays;
    ROADMAP queue 3, item 10.)"""
    pm = PR.BasicBlock(16, 32, 2) if block == "basic" else PR.BottleneckBlock(32, 16, 2)
    jm = JR.BasicBlock(32, 2) if block == "basic" else JR.BottleneckBlock(16, 2)
    _randomize(pm)
    assert {(m.eps, m.momentum) for m in pm.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {(1e-5, 0.1)}

    def flax_vars(module):
        sd = {f"layer1.0.{k}": t.numpy() for k, t in module.state_dict().items()}
        return {c: t["layer1_0"] for c, t in JR.resnet_state_dict_to_variables(sd).items()}

    x = np.random.RandomState(2).rand(4, 16, 12, pm.conv1.in_channels).astype(np.float32)
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(flax_vars(pm), jnp.asarray(x))
    out = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ref, _nchw_to_nhwc(out))
    new = flax_vars(pm)["batch_stats"]
    for (path, r), (_, o) in zip(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]),
                                 jax.tree_util.tree_leaves_with_path(new)):
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kw,what", [({"model": "resnet101"}, "supports"), ({"truncate": 1}, "trunk form"),
                                     ({"unwrap": False}, "trunk form"), ({"split": True}, "trunk form")])
def test_torchvision_refuses_what_jax_refuses(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        PR.TorchVision(512, **kw)
    with pytest.raises(NotImplementedError, match=what):
        JR.TorchVision(512, **kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))


@pytest.fixture(scope="module")
def cls18():
    """yolo11-cls-resnet18 with 2 classes on random weights, its flax
    variables through ``state_dict_to_variables`` and the JAX facade on them."""
    port = YOLO("yolo11-cls-resnet18.yaml", device="cpu", nc=2)
    _randomize(port.model)
    v = state_dict_to_variables(port.model)
    jy = JaxYOLO("yolo11-cls-resnet18.yaml", nc=2)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, v)
    return jy, port, v


def test_cls_resnet18_forward_bridge_and_fold_match_jax(cls18):
    """The bridge maps the trunk's flax ``down_conv``/``down_bn`` to
    torchvision's ``downsample.0``/``.1`` and its bare convs without the
    ``conv2d`` scope, both ways; logits and probabilities equal JAX's; the
    fold takes the Classify conv's BatchNorm and leaves the trunk's, as the
    JAX fold does, and gives the folded JAX model's outputs."""
    jy, port, v = cls18
    trunk = v["params"]["layers_0"]["m"]
    assert "down_conv" in trunk["layer2_0"] and "conv2d" not in trunk["conv1"]
    back = variables_to_state_dict(v, port.model)
    assert back.keys() == {k for k in port.model.state_dict() if not k.endswith("num_batches_tracked")}
    sd = port.model.state_dict()
    assert all(torch.equal(t, sd[k]) for k, t in back.items())
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    fwd = jax.jit(lambda v, x: jy.model.apply(v, x, train=False))
    ref = fwd(v, jnp.asarray(x))
    with torch.no_grad():
        out = port.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(out) == set(ref) == {"probs", "logits"}
    for k in out:
        _close(ref[k], out[k])
    folded = fold_conv_bn(port._inference_model())
    bns = [m for m in folded.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 20 and all(m.eps == 1e-5 for m in bns)  # resnet18's, none of YOLO's
    ref = fwd(jax_fold_conv_bn(v), jnp.asarray(x))
    with torch.no_grad():
        out = folded(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in out:
        _close(ref[k], out[k])


def test_cls_resnet18_predict_and_val_match_jax_facade(cls18, tiny_cls_dataset):
    jy, port, _ = cls18
    val_dir = f"{tiny_cls_dataset}/val"
    _assert_same_probs(port(val_dir, imgsz=64, batch=4), jy(val_dir, imgsz=64))
    ref = jy.val(tiny_cls_dataset, imgsz=64, batch=4, verbose=False)
    out = port.val(tiny_cls_dataset, imgsz=64, batch=4, verbose=False)
    assert out == ref


def test_cls_resnet18_trains_on_the_cpu(tiny_cls_dataset, tmp_path):
    """One epoch at 64 px: a finite loss, the trunk's BatchNorms updated by
    their own momentum, a reloadable ``last`` with the trunk."""
    y = YOLO("yolo11-cls-resnet18.yaml", device="cpu")
    before = y.model.model[0].m.bn1.running_mean.clone()
    out = y.train(data=tiny_cls_dataset, epochs=1, batch=8, imgsz=64, project=str(tmp_path), verbose=False)
    assert out["epochs_run"] == 1 and np.isfinite(out["results"][0]["train/loss"]) and y.nc == 2
    assert not torch.equal(y.model.model[0].m.bn1.running_mean, before)
    back = YOLO(out["save_dir"] + "/weights/last", device="cpu")
    assert isinstance(back.model.model[0], PR.TorchVision) and back.task == "classify"
