"""Whole models of the v3, v5, v6, v8, v9 and yolo12 families against the
JAX package: eval forwards at n, 64x128 px, float32, on the same weights
(the port's seeded init with random BatchNorm statistics, taken to flax by
``state_dict_to_variables`` and back by ``variables_to_state_dict``), the
ConvTranspose rule of the bridge on yolov6n, and the Conv+BN fold (RepConv's
branches each on its own) against the JAX fold.

Tolerance: max|port - jax| <= 1e-5 * max|jax| on every output (preds and
the per-level maps; prototypes, keypoints, angles; logits and
probabilities), as ``test_torch_modules.py``. yolov9e has no scales: its
narrowed copy divides every channel count of its YAML by 8 before both
parsers read it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold_conv_bn
from fce_yolo_tpu.nn.parser import parse_model_yaml as jax_parse_model_yaml
from fce_yolo_tpu_torch.cfg.models import load_model_dict
from fce_yolo_tpu_torch.nn import modules as PM
from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables, variables_to_state_dict
from test_torch_modules import _close, _nchw_to_nhwc

torch.set_num_threads(1)


def narrow_v9e(d: dict, div: int = 8) -> dict:
    """yolov9e with every channel count divided by ``div`` (the CBLinear
    splits with them, so each CBFuse still sums maps of equal width)."""
    d = copy.deepcopy(d)
    for layer in d["backbone"] + d["head"]:
        name, args = layer[2], layer[3]
        if name in ("Conv", "ADown", "SPPELAN", "RepNCSPELAN4"):
            k = {"SPPELAN": 2, "RepNCSPELAN4": 3}.get(name, 1)
            args[:k] = [a // div for a in args[:k]]
        elif name == "CBLinear":
            args[0] = [a // div for a in args[0]]
    return d


MODELS = {  # test name -> (config, scale)
    "yolov8n": ("yolov8.yaml", "n"), "yolov8n-seg": ("yolov8-seg.yaml", "n"),
    "yolov8n-pose": ("yolov8-pose.yaml", "n"), "yolov8n-obb": ("yolov8-obb.yaml", "n"),
    "yolov8n-cls": ("yolov8-cls.yaml", "n"), "yolov8n-p2": ("yolov8-p2.yaml", "n"),
    "yolov8n-ghost-p6": ("yolov8-ghost-p6.yaml", "n"), "yolov5n-p6": ("yolov5-p6.yaml", "n"),
    "yolov3-tiny": ("yolov3-tiny.yaml", None), "yolov6n": ("yolov6.yaml", "n"), "yolov9t": ("yolov9t.yaml", None),
    "yolov9e-narrow": ("yolov9e.yaml", None), "yolo12n": ("yolo12.yaml", "n"), "yolo12n-cls": ("yolo12-cls.yaml", "n"),
}


def bridged(name: str):
    """(JAX model, flax variables, port model) of ``name`` on the same weights."""
    cfg, scale = MODELS[name]
    d, _ = load_model_dict(cfg)
    if name == "yolov9e-narrow":
        d = narrow_v9e(d)
    model, _, strides = build_model(copy.deepcopy(d), scale=scale, device="cpu")
    # the port's strides (test_torch_families_parse.py holds the probe to JAX's)
    jmodel = JaxDetectionModel(spec=jax_parse_model_yaml(d, scale=scale), strides=strides)
    init_weights(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    v = state_dict_to_variables(model)
    back = variables_to_state_dict(v, model)
    assert back.keys() == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    sd = model.state_dict()
    for k, t in back.items():
        assert torch.equal(t, sd[k]), k
    return jmodel, v, model


def _x(seed: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).rand(2, 64, 128, 3).astype(np.float32)


def assert_forward_matches(jmodel, v, model, x: np.ndarray) -> None:
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert set(out) == set(ref)
    for k, r in ref.items():
        if k == "feats":
            assert len(out[k]) == len(r)
            for rf, of in zip(r, out[k]):
                _close(rf, _nchw_to_nhwc(of))
        elif k == "proto":
            _close(r, _nchw_to_nhwc(out[k]))
        else:
            _close(r, out[k])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_whole_model_forward_matches_jax(name):
    assert_forward_matches(*bridged(name), _x())


def test_yolov6_conv_transpose_follows_the_module_type():
    """yolov6n's two ``nn.ConvTranspose2d`` layers: the flax kernels under
    ``conv_transpose2d`` are flipped into the layers' own ``weight`` whether
    the bridge reads the kind from the model or from the flax scope, and
    ``key_to_flax`` puts the scope back; the bridged model gives JAX's
    outputs (``test_whole_model_forward_matches_jax[yolov6n]``). Each layer's
    own output equals the JAX layer's; with the kernel unflipped it misses
    it by over a tenth of its largest value."""
    jmodel, v, model = bridged("yolov6n")
    layers = [i for i, m in enumerate(model.model) if isinstance(m, torch.nn.ConvTranspose2d)]
    assert layers and all(f"layers_{i}" in v["params"] and "conv_transpose2d" in v["params"][f"layers_{i}"]
                          for i in layers)
    by_type, by_scope = variables_to_state_dict(v, model), variables_to_state_dict(v)
    assert by_type.keys() == by_scope.keys()
    assert all(torch.equal(by_type[k], by_scope[k]) for k in by_type)
    k = f"model.{layers[0]}.weight"
    np.testing.assert_array_equal(by_type[k].numpy(),
                                  v["params"][f"layers_{layers[0]}"]["conv_transpose2d"]["kernel"][::-1, ::-1]
                                  .transpose(2, 3, 0, 1))
    x = _x(3)
    _, inter = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(v, jnp.asarray(x))
    outs = {}
    hooks = [model.model[i].register_forward_hook(lambda m, a, o, i=i: outs.__setitem__(i, (a[0], o))) for i in layers]
    with torch.no_grad():
        model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        for i in layers:
            ref = np.asarray(inter["intermediates"][f"layers_{i}"]["__call__"][0])
            inp, out = outs[i]
            _close(ref, _nchw_to_nhwc(out))
            layer = model.model[i]  # the same layer with the kernel unflipped
            bad = torch.nn.functional.conv_transpose2d(inp, layer.weight.flip(2, 3), layer.bias, 2)
            assert np.abs(_nchw_to_nhwc(bad).numpy() - ref).max() > 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["yolov9t", "yolo12n"])
def test_fold_conv_bn_matches_the_jax_fold(name):
    """RepConv's two branches fold each on its own, as the JAX fold does; the
    folded port model gives the folded JAX model's outputs."""
    jmodel, v, model = bridged(name)
    folded = fold_conv_bn(copy.deepcopy(model))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    if name == "yolov9t":
        rep = next(m for m in folded.modules() if isinstance(m, PM.RepConv))
        assert rep.conv1.folded and rep.conv2.folded and rep.conv1.conv.bias is not None
    assert_forward_matches(jmodel, jax_fold_conv_bn(v), folded.eval(), _x(4))


@pytest.mark.parametrize("name", ["yolov3", "yolov5", "yolov6", "yolov8", "yolov8-p2", "yolov8-ghost", "yolov9t",
                                  "yolov9e", "yolo12", "yolo12-seg", "yolo12-cls"])
def test_stem_gate_matches_jax(name):
    """The fused stem's gate on the new families, every scale, at 640 px:
    only yolo12 (layers 0-2 Conv k3 s2, Conv k3 s2, C3k2 e=0.25, as yolo11)
    matches, at s and m (n has c2=64); the JAX gate says the same."""
    from fce_yolo_tpu.ops import pallas_stem as PS
    from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
    from fce_yolo_tpu_torch.nn.parser import load_model_yaml
    from fce_yolo_tpu_torch.ops import stem as S
    from test_torch_families_parse import JAX_CFG, _scales

    for scale in _scales(name):
        ref = PS.stem_spec_from_model(jax_load_model_yaml(JAX_CFG / f"{name}.yaml", scale=scale), (640, 640))
        out = S.stem_spec_from_model(load_model_yaml(f"{name}.yaml", scale=scale), (640, 640))
        assert (out is None) == (ref is None), scale
        if ref is not None:
            assert name.startswith("yolo12") and scale in "sm"
            assert all(getattr(out, f) == getattr(ref, f) for f in ("H", "W", "c0", "c1", "c2", "ch", "n", "c3k"))


def test_yolo12s_layers_0_to_2_are_what_the_stem_computes():
    """yolo12s at 160 px: the stem's plain version on the folded layers 0-2
    (weights rounded to bf16 by ``fold_stem_params``) is within
    0.02 * max|ref| of the graph's own float32 layers 0-2, the bound the
    card holds the kernel to, and the stem's output resumed at layer 3 gives
    the plain forward's preds (the JAX kernel test's bound,
    test_pallas_stem.py:99-100)."""
    from fce_yolo_tpu_torch.ops import stem as S

    model, spec, _ = build_model("yolo12s.yaml", device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    fold_conv_bn(model)
    ss = S.stem_spec_from_model(spec, (160, 160))
    assert ss is not None and ss.c2 == 128 and not ss.c3k and ss.n == 1
    img = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 160, 160, 3)).astype(np.uint8))
    x = img.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        layers = model.model[2](model.model[1](model.model[0](x)))
        ref = S.stem_reference(img, S.fold_stem_params(model, ss), ss)  # (B, H/4, W/4, c2)
        _close(layers.permute(0, 2, 3, 1).numpy(), ref, rtol=0.02)
        base = model(x)["preds"].numpy()
        fused = S.apply_with_fused_stem(model, img, ss, S.stem_weights(S.fold_stem_params(model, ss), ss))["preds"]
    assert np.abs(base - fused.numpy()).max() <= 0.02 * max(np.abs(base).max(), 1.0)
    assert np.corrcoef(base.ravel(), fused.numpy().ravel())[0, 1] > 0.9999
