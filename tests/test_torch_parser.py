"""Port parser and packaged configs vs the JAX package: the config dicts
equal the YAML files, and the parsed ModelSpec equals the JAX ModelSpec for
yolo11 and yolo11-fce at every scale (exact: it is integer channel math)."""

import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu_torch.cfg.models import MODELS, load_model_dict
from fce_yolo_tpu_torch.nn.model import build_model, resolve_strides
from fce_yolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

CFG_DIR = Path(__file__).resolve().parent.parent / "fce_yolo_tpu" / "cfg" / "models"

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["yolo11", "yolo11-fce"])
def test_config_dicts_equal_yaml(name):
    with open(CFG_DIR / f"{name}.yaml") as fh:
        assert MODELS[name] == yaml.safe_load(fh)


@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
@pytest.mark.parametrize("name", ["yolo11", "yolo11-fce"])
def test_model_spec_matches_jax(name, scale):
    ref = jax_load_model_yaml(CFG_DIR / f"{name}.yaml", scale=scale)
    spec = load_model_yaml(f"{name}.yaml", scale=scale)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref)


def test_forced_c3k_and_fce_args():
    """m/l/x force C3k inner blocks; BiCoordCrossAtt keeps its explicit
    reduction/heads and width-scales its output (parser.py:143-148, 177-193)."""
    s = load_model_yaml("yolo11s-fce.yaml")
    m = load_model_yaml("yolo11m-fce.yaml")
    assert s.scale == "s" and m.scale == "m"
    assert s.layers[2].args == [64, 128, 1, False, 0.25]
    assert m.layers[2].args[3] is True
    assert s.layers[5].name == "BiCoordCrossAtt" and s.layers[5].args == [256, 256, 8, 4]
    assert s.layers[14].args == [[512, 256], 256]  # BiFPN_Concat([c1...], c2)


def test_load_model_dict_names(tmp_path):
    d, scale = load_model_dict("yolo11n.yaml")
    assert scale == "n" and d == MODELS["yolo11"]
    d["nc"] = 3  # a copy: the packaged dict stays untouched
    assert MODELS["yolo11"]["nc"] == 80
    assert load_model_dict("yolo11-fce")[1] is None
    p = tmp_path / "custom.yaml"
    p.write_text(yaml.safe_dump({**MODELS["yolo11"], "nc": 5}))
    d, _ = load_model_dict(p)
    assert parse_model_yaml(d, scale="n").nc == 5
    with pytest.raises(FileNotFoundError):
        load_model_dict("yolov99q.yaml")


@pytest.mark.parametrize("name", ["yolo11n.yaml", "yolo11s-fce.yaml"])
def test_meta_stride_probe(name):
    """Strides come from a forward on the meta device: no memory, no FLOPs."""
    spec = load_model_yaml(name)
    assert resolve_strides(spec) == (8, 16, 32)
    model, _, strides = build_model(name)
    assert strides == (8, 16, 32) and model.detect.strides == (8, 16, 32)
    assert not model.training
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_unported_module_raises():
    d = {**MODELS["yolo11"], "backbone": [[-1, 1, "GhostConv", [64, 3, 2]]] + MODELS["yolo11"]["backbone"][1:]}
    with pytest.raises(KeyError, match="not ported"):
        build_model(d, scale="n")
