"""The v3, v5, v6, v8, v9 and yolo12 families in the port's parser and
``build_model`` against the JAX package: the packaged YAML files, the names
``load_model_dict`` resolves, the ``LayerSpec``s of all 32 YAMLs at every
scale they list (exact: integer channel math), and every parameter and
BatchNorm statistic's shape against ``jax.eval_shape`` of the JAX init (no
arithmetic, so yolov9e, yolov3 and the ResNet classifiers come at full
width).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu_torch.cfg.models import MODELS_DIR, load_model_dict, packaged_models
from fce_yolo_tpu_torch.nn.model import build_model, make_layer, param_count, resolve_strides
from fce_yolo_tpu_torch.nn.parser import LayerSpec, load_model_yaml
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables

JAX_CFG = Path(__file__).resolve().parent.parent / "fce_yolo_tpu" / "cfg" / "models"

FAMILIES = [
    "yolov3", "yolov3-spp", "yolov3-tiny", "yolov5", "yolov5-p6", "yolov6",
    "yolov8", "yolov8-p2", "yolov8-p6", "yolov8-ghost", "yolov8-ghost-p2", "yolov8-ghost-p6",
    "yolov8-seg", "yolov8-seg-p6", "yolov8-pose", "yolov8-pose-p6", "yolov8-obb",
    "yolov8-cls", "yolov8-cls-resnet50", "yolov8-cls-resnet101",
    "yolov9t", "yolov9s", "yolov9m", "yolov9c", "yolov9e", "yolov9c-seg", "yolov9e-seg",
    "yolo12", "yolo12-seg", "yolo12-pose", "yolo12-obb", "yolo12-cls",
]

OPEN_VOCAB = ["yolov8-world", "yolov8-worldv2", "yoloe-v8", "yoloe-v8-seg", "yoloe-11", "yoloe-11-seg"]

torch.set_num_threads(1)


def _scales(name: str) -> list:
    with open(JAX_CFG / f"{name}.yaml") as fh:
        return list((yaml.safe_load(fh).get("scales") or {None: None}).keys())


def test_packaged_yaml_files_are_the_jax_files():
    """The 32 family YAMLs above and the v10, ResNet-classify, RT-DETR and
    World/YOLOE ones (``test_torch_v10.py``, ``test_torch_resnet.py``,
    ``test_torch_transformer.py``, ``test_torch_world.py``), byte-equal."""
    others = ["yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x", "yolo11-cls-resnet18",
              "rtdetr-l", "rtdetr-x", "rtdetr-resnet50", "rtdetr-resnet101", "yolov8-rtdetr", *OPEN_VOCAB]
    assert sorted(p.stem for p in MODELS_DIR.glob("*.yaml")) == sorted(FAMILIES + others)
    for name in FAMILIES + others:
        assert (MODELS_DIR / f"{name}.yaml").read_bytes() == (JAX_CFG / f"{name}.yaml").read_bytes(), name


@pytest.mark.parametrize("name,base,scale", [
    ("yolov8s.yaml", "yolov8", "s"), ("yolov8s-seg.yaml", "yolov8-seg", "s"),
    ("yolov8s-ghost-p2.yaml", "yolov8-ghost-p2", "s"), ("yolo12s-obb.yaml", "yolo12-obb", "s"),
    ("yolov9c.yaml", "yolov9c", None), ("yolov3-tiny.yaml", "yolov3-tiny", None),
    ("yolov8x-cls-resnet101.yaml", "yolov8-cls-resnet101", "x"), ("yolo12-pose.yaml", "yolo12-pose", None),
])
def test_load_model_dict_resolves_packaged_names(name, base, scale):
    d, got = load_model_dict(name)
    with open(JAX_CFG / f"{base}.yaml") as fh:
        assert d == yaml.safe_load(fh)
    assert got == scale
    ref = jax_load_model_yaml(name)  # the JAX facade's resolution of the same name
    assert dataclasses.asdict(load_model_yaml(name)) == dataclasses.asdict(ref)


def test_unknown_model_lists_what_is_packaged():
    with pytest.raises(FileNotFoundError) as e:
        load_model_dict("yolov7s.yaml")
    assert all(n in str(e.value) for n in packaged_models())
    assert "yolov9e-seg" in str(e.value) and "yolo11-fce" in str(e.value)


@pytest.mark.parametrize("name", FAMILIES)
def test_model_specs_match_jax_at_every_scale(name):
    for scale in _scales(name):
        ref = jax_load_model_yaml(JAX_CFG / f"{name}.yaml", scale=scale)
        spec = load_model_yaml(f"{name}.yaml", scale=scale)
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref), (name, scale)


def test_legacy_flips_and_the_a2c2f_residual_form():
    """v8-era YAMLs keep ``legacy``; C3k2 and A2C2f turn it off; yolo12 l/x
    append (residual=True, mlp_ratio=1.2) to A2C2f's args."""
    assert load_model_yaml("yolov8n.yaml").legacy and load_model_yaml("yolov9c.yaml").legacy
    assert not load_model_yaml("yolo12n.yaml").legacy
    n, l = load_model_yaml("yolo12n.yaml"), load_model_yaml("yolo12l.yaml")
    assert n.layers[6].args == [128, 128, 2, True, 4] and l.layers[6].args == [512, 512, 4, True, 4, True, 1.2]
    e = load_model_yaml("yolov9e.yaml")
    assert e.layers[14].c2 == [64, 128, 256, 512, 1024] and e.layers[14].args == [1024, [64, 128, 256, 512, 1024]]
    assert e.layers[16].c2 == 64 and e.layers[0].name == "nn.Identity" and e.layers[0].c2 == 3
    r = load_model_yaml("yolov8n-cls-resnet50.yaml")
    assert [ls.c2 for ls in r.layers[:3]] == [64, 256, 512]


def _jax_shapes(name: str, scale: str | None) -> dict:
    spec = jax_load_model_yaml(JAX_CFG / f"{name}.yaml", scale=scale)
    model = JaxDetectionModel(spec=spec, strides=None)
    v = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=True), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), {c: dict(t) for c, t in v.items()})


@pytest.mark.parametrize("name", FAMILIES)
def test_parameter_shapes_and_counts_match_jax(name):
    """Every leaf of the JAX init, and nothing else, at the YAML's first
    scale: the port's weights taken to flax paths and layouts by
    ``state_dict_to_variables``, compared by shape; ``param_count`` equals
    the JAX params' count."""
    scale = _scales(name)[0]
    ref = _jax_shapes(name, scale)
    model, spec, _ = build_model(f"{name}.yaml", scale=scale, device="meta")
    sd = {k: torch.empty(t.shape) for k, t in model.state_dict().items()}  # meta -> shapes on the CPU
    got = jax.tree_util.tree_map(np.shape, state_dict_to_variables(model, sd))
    assert got == ref
    assert param_count(model) == sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        ref["params"], is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("name,strides", [
    ("yolov8n-p2.yaml", (4, 8, 16, 32)), ("yolov8n-ghost-p2.yaml", (4, 8, 16, 32)),
    ("yolov8n-p6.yaml", (8, 16, 32, 64)), ("yolov5n-p6.yaml", (8, 16, 32, 64)),
    ("yolov8n-pose-p6.yaml", (8, 16, 32, 64)), ("yolov3-tiny.yaml", (16, 32)), ("yolov9t.yaml", (8, 16, 32)),
])
def test_meta_stride_probe_with_two_to_four_levels(name, strides):
    """The JAX ``resolve_strides`` gives these (its eval_shape probe is left out for time)."""
    assert resolve_strides(load_model_yaml(name)) == strides


@pytest.mark.parametrize("layer,item", [
    ("C1", "7.2"), ("C3x", "7.2"), ("Focus", "7.2"), ("Conv2", "7.2"), ("BottleneckCSP", "7.2"), ("C3TR", "7.2"),
    ("CBAM", "7.2"), ("Index", "7.2"), ("C2fPSA", "7.2"), ("AGLU", "7.2"),
    ("DWConvTranspose2d", "7.2"),
])
def test_refused_layers_name_their_roadmap_item(layer, item):
    with pytest.raises(KeyError, match=rf"not ported yet \(ROADMAP queue 1, item {item}\)"):
        make_layer(LayerSpec(i=3, f=-1, name=layer, args=[16, 16], c2=16), None)


@pytest.mark.parametrize("layer,args", [
    ("C2fAttn", [16, 32, 1, 16, 2]), ("ImagePoolingAttn", [32, [16, 24, 32]]),
    ("WorldDetect", [3, 512, True, [16, 24, 32]]), ("YOLOEDetect", [3, 512, True, [16, 24, 32]]),
    ("YOLOESegment", [3, 8, 16, 512, True, [16, 24, 32]]),
])
def test_layers_of_item_12_2_build_by_name(layer, args):
    """The layers ROADMAP item 12.2 ported (YOLO-World's and YOLOE's) are no
    longer refused: ``make_layer`` builds each from its parsed arguments;
    the six YAMLs build (``test_families_of_items_7_4_and_7_5_build``)."""
    built = make_layer(LayerSpec(i=3, f=-1, name=layer, args=args, c2=16), (8, 16, 32))
    assert isinstance(built, torch.nn.Module) and sum(p.numel() for p in built.parameters()) > 0


@pytest.mark.parametrize("name,item", [("Focus", "7.2"), ("C3TR", "7.2"), ("CBAM", "7.2")])
def test_refused_families_name_their_roadmap_item(name, item):
    """A config with a block the port does not build yet (here a yolov8n
    with its second layer swapped for one of ROADMAP item 7.2's) is refused
    by ``build_model`` naming the item."""
    d, _ = load_model_dict("yolov8n.yaml")
    d["backbone"][1] = [-1, 1, name, [128, 3] if name == "Focus" else [128]]
    with pytest.raises(KeyError, match=rf"ROADMAP queue 1, item {item}\)"):
        build_model(d, device="cpu")


@pytest.mark.parametrize("layer,args", [
    ("HGStem", [3, 16, 32]), ("HGBlock", [16, 8, 32, 3, 2, True, False]), ("RepC3", [16, 32, 2]),
    ("AIFI", [16, 32, 4]), ("RTDETRDecoder", [3, [16, 16, 16], 32, 10, 1]), ("LightConv", [16, 16, 3]),
])
def test_layers_of_item_12_1_build_by_name(layer, args):
    """The layers ROADMAP item 12.1 ported (RT-DETR's, and LightConv, which
    item 7.2 listed) are no longer refused: ``make_layer`` builds each from
    its parsed arguments; rtdetr-l builds (``test_torch_transformer.py``)."""
    built = make_layer(LayerSpec(i=3, f=-1, name=layer, args=args, c2=16), (8, 16, 32))
    assert isinstance(built, torch.nn.Module) and sum(p.numel() for p in built.parameters()) > 0


@pytest.mark.parametrize("layer,args", [
    ("v10Detect", [3, [16, 32]]), ("C2fCIB", [16, 32, 1, True, True]), ("PSA", [128, 128]), ("SCDown", [16, 32, 3, 2]),
    ("RepVGGDW", [16]), ("CIB", [16, 16]), ("TorchVision", [512, "resnet18", "DEFAULT", True, 2]),
    ("CoordAtt", [16, 16, 8]), ("CoordCrossAtt", [16, 16, 8, 2]),
])
def test_layers_of_items_7_4_and_7_5_build_by_name(layer, args):
    """The layers ROADMAP items 7.4 and 7.5 ported are no longer refused:
    ``make_layer`` builds each from its parsed arguments."""
    built = make_layer(LayerSpec(i=3, f=-1, name=layer, args=args, c2=16), (8, 16))
    assert isinstance(built, torch.nn.Module) and sum(p.numel() for p in built.parameters()) > 0


@pytest.mark.parametrize("name", ["yolov10n.yaml", "yolo11-cls-resnet18.yaml", *(f"{n}.yaml" for n in OPEN_VOCAB)])
def test_families_of_items_7_4_and_7_5_build(name):
    """The JAX package's own YAML files of the families items 7.4 and 7.5
    (and 12.2: YOLO-World and YOLOE) ported build in the port, with the
    packaged copies' layers."""
    model, spec, _ = build_model(JAX_CFG / name, device="meta")
    assert [ls.name for ls in spec.layers] == [ls.name for ls in load_model_yaml(name).layers]
