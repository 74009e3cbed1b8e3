"""Each module of the inference slice vs its flax twin in float32 on the
same (bridged) weights and inputs.

Tolerance: max|port - jax| <= 1e-5 * max|jax|. Both sides compute in f32;
only the summation order of convolutions, matmuls and means differs, which
stays orders of magnitude below that bound at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import fce as jfce
from fce_yolo_tpu.nn import modules as JM
from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold_conv_bn
from fce_yolo_tpu.nn.import_torch import state_dict_to_variables
from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu.nn.parser import parse_model_yaml
from fce_yolo_tpu.ops import anchors as janchors
from fce_yolo_tpu_torch.nn import fce as pfce
from fce_yolo_tpu_torch.nn import modules as PM
from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import variables_to_state_dict
from fce_yolo_tpu_torch.ops import anchors as panchors

RTOL = 1e-5  # f32 vs f32, summation order only


def jax_detection_model(cfg, scale: str | None = None, strides: tuple = (8, 16, 32)):
    """(JAX ``DetectionModel``, spec, strides) of ``cfg`` (a YAML path or a
    model dict) with ``strides`` given: ``jax_build_model`` without its
    ``eval_shape`` stride probe, which traces the whole model twice (the
    port's probe is held to these strides in ``test_torch_parser.py`` and
    ``test_torch_families_parse.py``)."""
    spec = parse_model_yaml(dict(cfg), ch=3, scale=scale) if isinstance(cfg, dict) else jax_load_model_yaml(cfg, scale)
    strides = () if spec.task == "classify" else strides
    return JaxDetectionModel(spec=spec, strides=strides), spec, strides

def _known_strides(spec):
    return () if spec.task == "classify" else (8, 16, 32)


@pytest.fixture(scope="module")
def jax_known_strides():
    """JAX facades built in the module take the known strides (8, 16, 32)
    (none for a classifier) in place of their ``eval_shape`` stride probe,
    which traces the whole model twice (the port's probe is held to these
    strides in ``test_torch_parser.py`` and ``test_torch_families_parse.py``)."""
    import fce_yolo_tpu.nn.model as jax_model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "resolve_strides", _known_strides)
        yield


def jax_facade(name, seed: int, bias_prior: bool = True, **kw):
    """(JAX facade, port facade on the CPU) of ``name`` on the same weights:
    the port's initialisation from ``seed`` (``init_weights``: flax's
    initialisers, drawn by torch), bridged to flax for the JAX facade. The
    JAX facade is built with the known strides (8, 16, 32) in place of its
    ``eval_shape`` stride probe; the weights are not the JAX ``init_variables``
    (a jitted flax init of a whole model costs 7-30 s on the CPU)."""
    import fce_yolo_tpu.nn.model as jax_model
    from fce_yolo_tpu.api import YOLO as JaxYOLO
    from fce_yolo_tpu_torch import YOLO
    from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables as to_flax

    port = YOLO(name, device="cpu", **kw)
    init_weights(port.model, torch.Generator().manual_seed(seed), bias_prior=bias_prior)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "resolve_strides", _known_strides)
        jy = JaxYOLO(name, **kw)
    jy.variables = to_flax(port.model)
    return jy, port


torch.set_num_threads(1)


def _randomize(tree, rng):
    """Seeded random values for every leaf; BN scale/var and BiFPN weights
    stay positive so the modules see realistic statistics."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var", "w"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(jmod, pmod, inputs, seed=0, **apply_kw):
    """Randomize the flax module's variables (their shapes from an abstract
    init), bridge them to the torch module, run both on the NHWC ``inputs``
    (a list for multi-input modules); the flax side under one ``jax.jit``,
    whose compile the persistent cache keeps (op-by-op dispatch compiles
    each op again in every session)."""
    rng = np.random.RandomState(seed)
    xs = [jnp.asarray(x) for x in inputs]
    arg = xs if len(xs) > 1 or isinstance(jmod, (JM.Detect, jfce.BiFPN_Concat, JM.Concat)) else xs[0]
    v = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False, **apply_kw), arg)
    v = _randomize(dict(v), rng)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False, **apply_kw))(v, arg)
    sd = variables_to_state_dict({c: {"layers_0": t} for c, t in v.items()})
    pmod.load_state_dict({k.removeprefix("model.0."): t for k, t in sd.items()}, strict=True)
    pmod.eval()
    px = [torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2) for x in inputs]
    with torch.no_grad():
        out = pmod(px if isinstance(arg, list) else px[0])
    return ref, out


def _close(ref, out, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(ref - out).max())
    assert err <= rtol * scale, f"max|d|={err:.3e} > {rtol} * {scale:.3e}"


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1)


def _x(shape, seed=1):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


CASES = {
    "conv_k3_s2": (lambda: JM.ConvBNAct(16, 3, 2), lambda: PM.ConvBNAct(8, 16, 3, 2), [(2, 17, 12, 8)]),
    "conv_1x1_noact": (lambda: JM.ConvBNAct(16, 1, act=False), lambda: PM.ConvBNAct(8, 16, 1, act=False), [(1, 8, 8, 8)]),
    "dwconv": (lambda: JM.DWConvBNAct.make(16, 16, 3), lambda: PM.DWConvBNAct(16, 16, 3), [(1, 9, 10, 16)]),
    "bottleneck": (lambda: JM.Bottleneck(16, 16), lambda: PM.Bottleneck(16, 16), [(1, 8, 8, 16)]),
    "c3k2_bottleneck": (lambda: JM.C3k2(16, 64, n=1, c3k=False, e=0.25),
                        lambda: PM.C3k2(16, 64, n=1, c3k=False, e=0.25), [(1, 10, 12, 16)]),
    "c3k2_c3k_n2": (lambda: JM.C3k2(32, 32, n=2, c3k=True), lambda: PM.C3k2(32, 32, n=2, c3k=True), [(1, 8, 8, 32)]),
    "sppf": (lambda: JM.SPPF(32, 32, 5), lambda: PM.SPPF(32, 32, 5), [(1, 7, 9, 32)]),
    "c2psa": (lambda: JM.C2PSA(128, 128, n=1), lambda: PM.C2PSA(128, 128, n=1), [(1, 4, 6, 128)]),
    "upsample": (lambda: JM.Upsample(2), lambda: PM.Upsample(2), [(1, 3, 5, 4)]),
    "concat": (lambda: JM.Concat(), lambda: PM.Concat(), [(1, 4, 4, 3), (1, 4, 4, 5)]),
    "bifpn_2": (lambda: jfce.BiFPN_Concat((32, 16), 16), lambda: pfce.BiFPN_Concat((32, 16), 16),
                [(1, 6, 6, 32), (1, 6, 6, 16)]),
    "bifpn_3": (lambda: jfce.BiFPN_Concat((16, 24, 16), 16), lambda: pfce.BiFPN_Concat((16, 24, 16), 16),
                [(1, 5, 5, 16), (1, 5, 5, 24), (1, 5, 5, 16)]),
    "bicoord": (lambda: jfce.BiCoordCrossAtt(64, 64, 8, 4), lambda: pfce.BiCoordCrossAtt(64, 64, 8, 4),
                [(2, 6, 10, 64)]),
    "bicoord_identity": (lambda: jfce.BiCoordCrossAtt(32, 48, 8, 2), lambda: pfce.BiCoordCrossAtt(32, 48, 8, 2),
                         [(1, 7, 5, 32)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_flax(case):
    jf, pf, shapes = CASES[case]
    ref, out = _pair(jf(), pf(), [_x(s, i + 1) for i, s in enumerate(shapes)])
    _close(ref, _nchw_to_nhwc(out))


@pytest.mark.parametrize("nc", [5, 80])
def test_detect_decode_matches_flax(nc):
    """Detect in eval mode: anchor-major (B, N, 4 + nc) f32 decode (DFL
    expectation, dist2bbox, sigmoid) and the raw per-level maps."""
    ch, strides = (16, 32, 64), (8, 16, 32)
    shapes = [(2, 8, 6, 16), (2, 4, 3, 32), (2, 2, 2, 64)]
    jmod = JM.Detect(nc=nc, ch=ch, strides=strides)
    pmod = PM.Detect(nc=nc, ch=ch, strides=strides)
    ref, out = _pair(jmod, pmod, [_x(s, i + 1) for i, s in enumerate(shapes)])
    _close(ref["preds"], out["preds"])
    for rf, of in zip(ref["feats"], out["feats"]):
        _close(rf, _nchw_to_nhwc(of))


def test_anchor_ops_match_jax():
    shapes, strides = [(4, 6), (2, 3)], [8, 16]
    ja, js = janchors.make_anchors(shapes, strides)
    pa, ps = panchors.make_anchors(shapes, strides)
    np.testing.assert_array_equal(np.asarray(ja), pa.numpy())
    np.testing.assert_array_equal(np.asarray(js), ps.numpy())
    logits = _x((2, 30, 64))
    _close(janchors.dfl_expectation(jnp.asarray(logits)), panchors.dfl_expectation(torch.from_numpy(logits)))
    d, a = np.abs(_x((2, 30, 4))), _x((30, 2))
    for xywh in (True, False):
        _close(janchors.dist2bbox(jnp.asarray(d), jnp.asarray(a), xywh),
               panchors.dist2bbox(torch.from_numpy(d), torch.from_numpy(a), xywh))


def _bridged_model(name: str):
    """``name`` at n in both frameworks on the same seeded weights, random BN
    statistics included; the flax variables come from the port's state_dict
    through the JAX package's own importer (no flax init compile)."""
    jmodel, _, _ = jax_detection_model(f"fce_yolo_tpu/cfg/models/{name}.yaml", scale="n")
    model, _, _ = build_model(f"{name}.yaml", scale="n", device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, pfce.BiFPN_Concat):  # unequal fusion weights, so a swapped input shows
                m.w.uniform_(0.5, 1.5, generator=gen)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    v = state_dict_to_variables(sd)
    return jmodel, v, model


@pytest.fixture(scope="module")
def fce_n():
    return _bridged_model("yolo11-fce")


def _assert_forward_matches(jmodel, v, model):
    """Eval preds and train-mode-shaped per-level maps of the whole graph."""
    x = np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    _close(ref["preds"], out["preds"])
    for rf, of in zip(ref["feats"], out["feats"]):
        _close(rf, _nchw_to_nhwc(of))


def test_full_model_forward_matches_flax(fce_n):
    _assert_forward_matches(*fce_n)


def test_full_model_forward_matches_flax_bifpn():
    """yolo11n-bifpn, the ablation's M2: the four BiFPN_Concat necks of the stock graph."""
    _assert_forward_matches(*_bridged_model("yolo11-bifpn"))


def test_fold_conv_bn_matches_flax(fce_n):
    """The port's in-place fold gives the JAX folded model's outputs."""
    jmodel, v, model = fce_n
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jax_fold_conv_bn(v), jnp.asarray(x))["preds"]
    import copy

    folded = fold_conv_bn(copy.deepcopy(model))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    assert fold_conv_bn(folded) is folded  # idempotent
    with torch.no_grad():
        out = folded(torch.from_numpy(x).permute(0, 3, 1, 2))["preds"]
    _close(ref, out)


def test_fold_keeps_bf16():
    """Folding a bf16 model keeps every tensor bf16 (the JAX fold emits f32),
    and the folded bf16 weights equal the f32 fold rounded once to bf16."""
    model, _, _ = build_model("yolo11n.yaml", device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)
                m.running_mean.normal_(0, 0.1)
    model.to(torch.bfloat16)
    conv = model.model[0]
    w = conv.conv.weight.float()
    g_std = conv.bn.weight.float() / torch.sqrt(conv.bn.running_var.float() + conv.bn.eps)
    fold_conv_bn(model)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert conv.folded and conv.conv.bias.dtype == torch.bfloat16
    torch.testing.assert_close(conv.conv.weight, (w * g_std[:, None, None, None]).to(torch.bfloat16),
                               rtol=0, atol=0)
