"""The JAX -> port weight bridge (nn/weights.py) is a bijection: every port
state_dict tensor comes from exactly one flax leaf and back through the
JAX importer's ``torch_key_to_flax``, with matching shapes; the bridge's
own inverse ``key_to_flax`` gives the importer's paths (for the task heads,
with their Detect trunk under the ``detect`` scope)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn.import_torch import torch_key_to_flax
from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold_conv_bn
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn
from fce_yolo_tpu_torch.nn.weights import flax_path_to_key, key_to_flax, variables_to_state_dict
from test_torch_modules import jax_detection_model

CFG_DIR = Path(__file__).resolve().parent.parent / "fce_yolo_tpu" / "cfg" / "models"
CONFIGS = [("yolo11", "n"), ("yolo11-fce", "s"), ("yolo11-fce", "n"), ("yolo11-bifpn", "n"),
           ("yolo11-seg", "n"), ("yolo11-pose", "n"), ("yolo11-obb", "n")]

torch.set_num_threads(1)


def _jax_leaves(model) -> dict:
    """{(collection, path): shape} of the JAX variables, from shapes only."""
    shapes = jax.eval_shape(
        lambda k: init_variables(model, k, imgsz=64), jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        out[(keys[0], keys[1:])] = tuple(leaf.shape)
    return out


def _port_state(model) -> dict:
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_bridge_is_a_bijection(name, scale):
    jmodel, _, _ = jax_detection_model(str(CFG_DIR / f"{name}.yaml"), scale=scale)
    leaves = _jax_leaves(jmodel)
    model, _, _ = build_model(f"{name}.yaml", scale=scale, device="cpu")
    port = _port_state(model)

    # port key -> flax leaf (the JAX importer), one leaf each, all leaves hit; a task head's Detect trunk
    # sits under its ``detect`` scope in flax, where the importer's template step puts it
    hit = {}
    for key, t in port.items():
        coll, path, kind = torch_key_to_flax(key)
        if (coll, path) not in leaves and (coll, (path[0], "detect", *path[1:])) in leaves:
            path = (path[0], "detect", *path[1:])
        assert (coll, path) in leaves, key
        assert (coll, path) not in hit, f"{key} and {hit.get((coll, path))} share a leaf"
        hit[(coll, path)] = key
        shape = leaves[(coll, path)]
        want = shape
        if kind == "conv_kernel":
            want = (shape[3], shape[2], shape[0], shape[1])
        elif kind == "convT_kernel":  # flax (kh, kw, in, out) -> torch (in, out, kh, kw)
            want = (shape[2], shape[3], shape[0], shape[1])
        assert tuple(t.shape) == want, (key, tuple(t.shape), shape)
    assert set(hit) == set(leaves)
    # flax leaf -> port key (the bridge) inverts the importer exactly, and key_to_flax is the importer
    for (coll, path), key in hit.items():
        assert flax_path_to_key(coll, path) == key
        assert key_to_flax(model, key) == (coll, path)


def test_bridge_loads_values_and_folded_variables():
    """Values land transposed where they belong; a JAX-folded tree loads
    into a port-folded model."""
    jmodel, _, _ = jax_detection_model(str(CFG_DIR / "yolo11.yaml"), scale="n")
    v = jax.jit(lambda k: init_variables(jmodel, k, imgsz=64))(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, v)
    model, _, _ = build_model("yolo11n.yaml", device="cpu")
    model.load_state_dict(variables_to_state_dict(v), strict=True)
    k = v["params"]["layers_0"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(model.model[0].conv.weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    det = v["params"]["layers_23"]["cv3_0_2"]["conv2d"]["bias"]
    np.testing.assert_array_equal(model.model[23].cv3[0][2].bias.detach().numpy(), det)

    folded = jax.tree_util.tree_map(np.asarray, jax_fold_conv_bn(v))
    fold_conv_bn(model)
    sd = variables_to_state_dict(folded)
    assert "model.0.conv.bias" in sd and "model.0.bn.weight" not in sd
    model.load_state_dict(sd, strict=True)


def test_flax_path_to_key_examples():
    assert flax_path_to_key("params", ("layers_0", "conv", "kernel")) == "model.0.conv.weight"
    assert flax_path_to_key("batch_stats", ("layers_2", "m_0", "cv1", "bn", "var")) == \
        "model.2.m.0.cv1.bn.running_var"
    assert flax_path_to_key("params", ("layers_23", "cv3_1_0_1", "bn", "scale")) == \
        "model.23.cv3.1.0.1.bn.weight"
    assert flax_path_to_key("params", ("layers_5", "proj_q_h", "conv2d", "bias")) == "model.5.proj_q_h.bias"
    assert flax_path_to_key("params", ("layers_14", "w")) == "model.14.w"
