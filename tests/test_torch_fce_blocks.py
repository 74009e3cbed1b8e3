"""``CoordAtt`` and ``CoordCrossAtt`` (``fce_yolo_tpu/nn/fce.py:56-119``)
in the port against their flax twins, in eval and in training mode, and a
user's own model YAML that places them (the paper's detector with its two
BiCoordCrossAtt layers swapped for them), parsed by both packages' rules
(``fce_yolo_tpu/nn/parser.py:182-205``) and run whole against JAX.

Tolerance: max|port - jax| <= 1e-5 * max|jax| on every output, as
``test_torch_modules.py`` (both sides float32, sums in another order);
running statistics within 1e-6 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fce_yolo_tpu.nn import fce as jfce
from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.parser import parse_model_yaml as jax_parse_model_yaml
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg.models import MODELS
from fce_yolo_tpu_torch.nn import fce as pfce
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from test_torch_families_models import assert_forward_matches
from test_torch_modules import _close, _nchw_to_nhwc, _pair, _x

torch.set_num_threads(1)

CASES = {
    "coordatt": (lambda: jfce.CoordAtt(32, 32, 8), lambda: pfce.CoordAtt(32, 32, 8), (2, 9, 7, 32)),
    "coordatt_identity": (lambda: jfce.CoordAtt(16, 24, 4), lambda: pfce.CoordAtt(16, 24, 4), (1, 8, 10, 16)),
    "coordcrossatt_2heads": (lambda: jfce.CoordCrossAtt(32, 32, 4, 2), lambda: pfce.CoordCrossAtt(32, 32, 4, 2),
                             (2, 9, 7, 32)),
    "coordcrossatt_1head": (lambda: jfce.CoordCrossAtt(64, 64, 8, 1), lambda: pfce.CoordCrossAtt(64, 64, 8, 1),
                            (1, 6, 11, 64)),
    "coordcrossatt_4heads": (lambda: jfce.CoordCrossAtt(256, 256, 8, 4), lambda: pfce.CoordCrossAtt(256, 256, 8, 4),
                             (1, 5, 4, 256)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    jf, pf, shape = CASES[case]
    ref, out = _pair(jf(), pf(), [_x(shape, 1)])
    _close(ref, _nchw_to_nhwc(out))


def test_coordatt_training_step_matches_flax():
    """Training mode: ``cv1``'s BatchNorm normalises over both strips'
    H + W positions; the output and its new running statistics equal
    flax's (YOLO's momentum 0.03, the biased batch variance)."""
    jm, pm = jfce.CoordAtt(16, 24, 4), pfce.CoordAtt(16, 24, 4)
    x = _x((3, 9, 7, 16), 2)
    _pair(jm, pm, [x])
    v = state_dict_to_variables(pm)
    ref, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    out = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ref, _nchw_to_nhwc(out))
    new = state_dict_to_variables(pm)["batch_stats"]
    for (path, r), (_, o) in zip(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]),
                                 jax.tree_util.tree_leaves_with_path(new)):
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))


def _coord_yaml() -> dict:
    """yolo11-fce with layer 5 a CoordAtt (explicit reduction) and layer 8 a
    CoordCrossAtt (adaptive reduction and heads: no arguments beyond c2)."""
    d = copy.deepcopy(MODELS["yolo11-fce"])
    d["backbone"][5] = [-1, 1, "CoordAtt", [512, 8]]
    d["backbone"][8] = [-1, 1, "CoordCrossAtt", [512]]
    return d


def test_user_yaml_with_coord_blocks_matches_jax(tmp_path):
    """A user's model YAML file: ``YOLO(path)`` reads it with the port's
    reader; both parsers give the same layers (CoordAtt [inp, oup,
    reduction], CoordCrossAtt [inp, oup, reduction, heads] with the adaptive
    defaults), and the whole model's eval forward equals JAX's on the same
    weights."""
    d = _coord_yaml()
    path = tmp_path / "yolo11-coord.yaml"
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    port = YOLO(str(path), device="cpu")
    jspec = jax_parse_model_yaml(yaml.safe_load(path.read_text()), scale="n")
    assert [(ls.name, ls.args, ls.c2) for ls in port.spec.layers] == [(ls.name, ls.args, ls.c2) for ls in jspec.layers]
    assert port.spec.layers[5].args == [128, 128, 8] and port.spec.layers[8].args[:2] == [128, 128]
    assert isinstance(port.model.model[5], pfce.CoordAtt) and isinstance(port.model.model[8], pfce.CoordCrossAtt)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in port.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    jmodel = JaxDetectionModel(spec=jspec, strides=port.strides)
    x = np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32)
    assert_forward_matches(jmodel, state_dict_to_variables(port.model), port.model, x)
