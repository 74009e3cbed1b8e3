"""YOLO-World and YOLOE in the port against the JAX package: every block
and head of ``nn/world.py`` and ``nn/yoloe.py`` on the same random
variables, the six packaged YAMLs' parameter shapes against
``jax.eval_shape``, tiny World and YOLOE graphs through the weight bridge
(text and visual prompts, eval and train outputs), text- and
visual-prompt predict and val through both facades, three train steps with
``txt_feats`` and with ``visual_prompts``, a ``.pt`` read by both readers,
and the port's multimodal and visual-prompt trainings.

Tolerances: blocks and heads within 1e-5 * max|ref| (float32 on both
sides, summation order only); graph outputs the same; predict's boxes
within 1e-3 px, scores within 1e-5, classes and order equal; val's P, R,
mAP50 and mAP50-95 within 1e-4; train losses within 1e-4 relative;
weights read from a ``.pt`` equal.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import world as JW
from fce_yolo_tpu.nn import yoloe as JY
from fce_yolo_tpu.nn.import_torch import load_pt_state_dict as jax_load_pt
from fce_yolo_tpu.nn.import_torch import state_dict_to_variables as jax_pt_to_variables
from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu.train import optim as jopt
from fce_yolo_tpu.train import trainer as jtrainer
from fce_yolo_tpu.train.loss import DetectionLossCfg as JaxDetectionLossCfg
from fce_yolo_tpu_torch import YOLO, YOLOE, YOLOWorld
from fce_yolo_tpu_torch.models.world import YOLOWorldTrainable
from fce_yolo_tpu_torch.nn import world as PW
from fce_yolo_tpu_torch.nn import yoloe as PY
from fce_yolo_tpu_torch.nn.import_torch import import_torch_state_dict, load_pt_state_dict
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables, variables_to_state_dict
from fce_yolo_tpu_torch.train import optim as popt
from fce_yolo_tpu_torch.train import trainer as ptrainer
from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
from test_torch_data import png_copy
from test_torch_modules import _randomize, jax_detection_model
from test_torch_modules import jax_known_strides  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

RTOL = 1e-5
JAX_CFG = Path(__file__).resolve().parent.parent / "fce_yolo_tpu" / "cfg" / "models"
OPEN_VOCAB = ["yolov8-world", "yolov8-worldv2", "yoloe-v8", "yoloe-v8-seg", "yoloe-11", "yoloe-11-seg"]

WORLD_TINY = """nc: 3
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, C2f, [32, True]]
  - [-1, 1, Conv, [32, 3, 2]] # 3 P3/8
  - [-1, 1, Conv, [48, 3, 2]] # 4 P4/16
  - [-1, 1, Conv, [64, 3, 2]] # 5 P5/32
head:
  - [-1, 1, nn.Upsample, [None, 2, "nearest"]]
  - [[-1, 4], 1, Concat, [1]]
  - [-1, 1, C2fAttn, [48, 24, 2]] # 8
  - [-1, 1, nn.Upsample, [None, 2, "nearest"]]
  - [[-1, 3], 1, Concat, [1]]
  - [-1, 1, C2fAttn, [32, 16, 2]] # 11
  - [[11, 8, 5], 1, ImagePoolingAttn, [32]] # 12 text update
  - [11, 1, Conv, [32, 3, 2]]
  - [[-1, 8], 1, Concat, [1]]
  - [-1, 1, C2fAttn, [48, 24, 2]] # 15
  - [[11, 15, 5], 1, WorldDetect, [nc, 512, False]]
"""
YOLOE_TINY = """nc: 3
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, C3k2, [32, False, 0.25]]
  - [-1, 1, Conv, [32, 3, 2]] # 3 P3/8
  - [-1, 1, Conv, [48, 3, 2]] # 4 P4/16
  - [-1, 1, Conv, [64, 3, 2]] # 5 P5/32
head:
  - [[3, 4, 5], 1, {head}]
"""


@pytest.fixture(scope="module")
def yamls(tmp_path_factory):
    root = tmp_path_factory.mktemp("world_yaml")
    texts = {"world": WORLD_TINY, "yoloe": YOLOE_TINY.format(head="YOLOEDetect, [nc, 512, True]"),
             "yoloe-seg": YOLOE_TINY.format(head="YOLOESegment, [nc, 8, 16, 512, True]")}
    for k, t in texts.items():
        (root / f"{k}-tiny.yaml").write_text(t)
    return {k: str(root / f"{k}-tiny.yaml") for k in texts}


# ------------------------------------------------------------------ blocks
def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _masks(b, q, h, w, empty=()):
    """Seeded binary prompt masks (B, Q, H, W); prompts in ``empty`` have none."""
    m = (np.random.default_rng(7).random((b, q, h, w)) > 0.6).astype(np.float32)
    for i in empty:
        m[:, i] = 0
    return m


def _block_pair(jmod, pmod, j_args: tuple, p_args: tuple, seed=0, **kw):
    """Random variables for the flax module (shapes from an abstract init),
    bridged to the port module; both applied in eval mode."""
    v = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, train=False, **kw), *j_args)
    v = _randomize(dict(v), np.random.RandomState(seed))
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False, **kw))(v, *j_args)
    sd = variables_to_state_dict({c: {"layers_0": t} for c, t in v.items()})
    pmod.load_state_dict({k.removeprefix("model.0."): t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        out = pmod.eval()(*p_args)
    return ref, out


def _close(ref, out, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err, scale = float(np.abs(ref - out).max()), max(float(np.abs(ref).max()), 1e-6)
    assert err <= rtol * scale, f"max|d|={err:.3e} > {rtol} * {scale:.3e}"


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _maps(ref_maps):
    return [np.asarray(f).transpose(0, 3, 1, 2) for f in ref_maps]


LEVELS = [(2, 8, 12, 16), (2, 4, 6, 24), (2, 2, 3, 32)]  # NHWC P3-P5; 3x3 pooling of 4x6 and 2x3: bins overlap


def _levels():
    return [_x(s, seed=i) for i, s in enumerate(LEVELS)]


def _case_maxsigmoid():
    x, g = _x((2, 6, 7, 16)), _x((2, 5, 24), 2)
    j = JW.MaxSigmoidAttnBlock(c1=16, c2=32, nh=4, ec=32, gc=24)
    ref, out = _block_pair(j, PW.MaxSigmoidAttnBlock(16, 32, nh=4, ec=32, gc=24),
                           (jnp.asarray(x), jnp.asarray(g)), (_nchw(x), torch.from_numpy(g)))
    return _maps([ref])[0], out


def _case_c2fattn():
    x, g = _x((2, 6, 7, 24)), _x((2, 5, 24), 2)
    j = JW.C2fAttn(c1=24, c2=32, n=2, ec=16, nh=2, gc=24, shortcut=True)
    ref, out = _block_pair(j, PW.C2fAttn(24, 32, n=2, ec=16, nh=2, gc=24, shortcut=True),
                           (jnp.asarray(x), jnp.asarray(g)), (_nchw(x), torch.from_numpy(g)))
    return _maps([ref])[0], out


def _case_ipa(scale):
    xs, t = _levels(), _x((2, 5, 64), 3)
    j = JW.ImagePoolingAttn(ec=32, ch=(16, 24, 32), ct=64, nh=4, k=3, scale=scale)
    p = PW.ImagePoolingAttn(32, (16, 24, 32), ct=64, nh=4, k=3, scale=scale)
    return _block_pair(j, p, ([jnp.asarray(x) for x in xs], jnp.asarray(t)), ([_nchw(x) for x in xs],
                                                                              torch.from_numpy(t)))


def _case_contrastive(bn):
    x, w = _x((2, 6, 7, 32)), _x((2, 5, 32), 2)
    j, p = (JW.BNContrastiveHead(32), PW.BNContrastiveHead(32)) if bn else (JW.ContrastiveHead(), PW.ContrastiveHead())
    ref, out = _block_pair(j, p, (jnp.asarray(x), jnp.asarray(w)), (_nchw(x), torch.from_numpy(w)))
    return np.asarray(ref).transpose(0, 3, 1, 2), out


def _case_world_detect(with_bn):
    xs, t = _levels(), _x((2, 5, 64), 3)
    j = JW.WorldDetect(nc=3, ch=(16, 24, 32), embed=64, with_bn=with_bn, strides=(8, 16, 32))
    p = PW.WorldDetect(3, embed=64, with_bn=with_bn, ch=(16, 24, 32), strides=(8, 16, 32))
    ref, out = _block_pair(j, p, ([jnp.asarray(x) for x in xs], jnp.asarray(t)),
                           ([_nchw(x) for x in xs], torch.from_numpy(t)))
    for r, o in zip(_maps(ref["feats"]), out["feats"]):
        _close(r, o)
    return ref["preds"], out["preds"]


def _case_swiglu(residual):
    x = _x((2, 5, 32))
    j = JY.Residual(32, 32) if residual else JY.SwiGLUFFN(32, 32)
    p = PY.Residual(PY.SwiGLUFFN(32, 32)) if residual else PY.SwiGLUFFN(32, 32)
    return _block_pair(j, p, (jnp.asarray(x),), (torch.from_numpy(x),))


def _case_savpe():
    xs = _levels()
    vp = _masks(2, 4, 8, 12, empty=(2,))
    return _block_pair(JY.SAVPE(ch=(16, 24, 32), c3=24, embed=64), PY.SAVPE((16, 24, 32), 24, 64),
                       ([jnp.asarray(x) for x in xs], jnp.asarray(vp)), ([_nchw(x) for x in xs], torch.from_numpy(vp)))


def _case_yoloe(seg, visual):
    xs, t = _levels(), _x((2, 5, 64), 3)
    vp = _masks(2, 4, 8, 12, empty=(1,)) if visual else None
    if seg:
        j = JY.YOLOESegment(nc=3, ch=(16, 24, 32), nm=8, npr=16, embed=64, strides=(8, 16, 32))
        p = PY.YOLOESegment(3, nm=8, npr=16, embed=64, ch=(16, 24, 32), strides=(8, 16, 32))
    else:
        j = JY.YOLOEDetect(nc=3, ch=(16, 24, 32), embed=64, strides=(8, 16, 32))
        p = PY.YOLOEDetect(3, embed=64, ch=(16, 24, 32), strides=(8, 16, 32))
    j_args = ([jnp.asarray(x) for x in xs], jnp.asarray(t))
    p_args = ([_nchw(x) for x in xs], torch.from_numpy(t)) + ((torch.from_numpy(vp),) if visual else ())
    kw = {"visual_prompts": jnp.asarray(vp)} if visual else {}
    ref, out = _block_pair(j, p, j_args, p_args, **kw)
    for r, o in zip(_maps(ref["feats"]), out["feats"]):
        _close(r, o)
    if seg:
        _close(np.asarray(ref["proto"]).transpose(0, 3, 1, 2), out["proto"])
    return ref["preds"], out["preds"]


CASES = {
    "MaxSigmoidAttnBlock": _case_maxsigmoid, "C2fAttn": _case_c2fattn, "ImagePoolingAttn": lambda: _case_ipa(False),
    "ImagePoolingAttn-scale": lambda: _case_ipa(True), "ContrastiveHead": lambda: _case_contrastive(False),
    "BNContrastiveHead": lambda: _case_contrastive(True), "WorldDetect": lambda: _case_world_detect(False),
    "WorldDetect-bn": lambda: _case_world_detect(True), "SwiGLUFFN": lambda: _case_swiglu(False),
    "Residual": lambda: _case_swiglu(True), "SAVPE": _case_savpe,
    "YOLOEDetect-text": lambda: _case_yoloe(False, False), "YOLOEDetect-visual": lambda: _case_yoloe(False, True),
    "YOLOESegment-text": lambda: _case_yoloe(True, False), "YOLOESegment-visual": lambda: _case_yoloe(True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    """The block in float32 on random variables (BN statistics and scales
    in [0.5, 1.5]); ImagePoolingAttn on 8x12, 4x6 and 2x3 maps, whose 3x3
    max-pool bins overlap (floor / ceil edges); SAVPE and the visual heads
    with a prompt whose mask is empty."""
    ref, out = CASES[case]()
    _close(ref, out)


def test_norm_eps_follow_the_jax_package():
    """ImagePoolingAttn's LayerNorms take flax's eps 1e-6 and
    BNContrastiveHead's BatchNorm the port's 1e-3 (momentum 0.03), as the
    JAX modules do, where Ultralytics' torch defaults are 1e-5 (and 0.1):
    ROADMAP queue 3, item 35. On a text row of tiny variance the LayerNorm's
    eps shows."""
    ipa = PW.ImagePoolingAttn(32, (16,), ct=64, nh=4)
    assert all(ln.eps == 1e-6 for ln in (ipa.query[0], ipa.key[0], ipa.value[0]))
    bn = PW.BNContrastiveHead(32).norm
    assert (bn.eps, bn.momentum) == (1e-3, 0.03)
    t = torch.full((1, 1, 64), 0.5) + torch.linspace(-1, 1, 64) * 1e-3
    a = ipa.query[0](t)
    b = torch.nn.functional.layer_norm(t, (64,), ipa.query[0].weight, ipa.query[0].bias, 1e-5)
    assert float((a - b).abs().max()) > 0.01


def test_savpe_empty_prompt_pools_uniformly_in_bf16():
    """A prompt with an all-zero mask scores every cell ``finfo.min``: its
    softmax is uniform over the grid, in bfloat16 too, without NaN; the
    bfloat16 embedding stays near the float32 one."""
    torch.manual_seed(0)
    m = PY.SAVPE((16, 24, 32), 24, 64).eval()
    xs = [_nchw(x) for x in _levels()]
    vp = torch.from_numpy(_masks(2, 3, 8, 12, empty=(0,)))
    with torch.no_grad():
        f32 = m(xs, vp)
        bf16 = copy.deepcopy(m).to(torch.bfloat16)([x.bfloat16() for x in xs], vp)
    assert torch.isfinite(bf16).all() and bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), rtol=0, atol=0.05)
    # uniform pooling: the empty prompt's embedding is the normalized grid mean of the 16 channel groups
    with torch.no_grad():
        x = m.cv3(torch.cat([c(t) for c, t in zip(m.cv1, xs)], 1))
    e = x.shape[1]
    mean = x.reshape(2, 16, e // 16, -1).mean(-1).reshape(2, e)
    np.testing.assert_allclose(f32[:, 0].numpy(), torch.nn.functional.normalize(mean, dim=-1).numpy(), atol=1e-5)


# ------------------------------------------------------------ the six YAMLs
def _jax_shapes(name: str, scale: str | None) -> dict:
    spec = jax_load_model_yaml(JAX_CFG / f"{name}.yaml", scale=scale)
    model = JaxDetectionModel(spec=spec, strides=(8, 16, 32))
    v = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=True), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), {c: dict(t) for c, t in v.items()})


@pytest.mark.parametrize("name", OPEN_VOCAB)
def test_parameter_shapes_match_jax(name):
    """Every leaf of the JAX init (SAVPE's included), and nothing else, at
    s scale: the port's weights taken to flax paths by
    ``state_dict_to_variables``, compared by shape; the spec as the JAX
    parser's, the task (segment for YOLOESegment) and ``needs_text``."""
    import dataclasses

    ref = _jax_shapes(name, "s")
    model, spec, strides = build_model(f"{name}.yaml", scale="s", device="meta")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jax_load_model_yaml(JAX_CFG / f"{name}.yaml", scale="s"))
    assert strides == (8, 16, 32) and spec.needs_text and spec.task == ("segment" if "seg" in name else "detect")
    sd = {k: torch.empty(t.shape) for k, t in model.state_dict().items()}
    got = jax.tree_util.tree_map(np.shape, state_dict_to_variables(model, sd))
    assert got == ref
    assert tuple(model.txt_feats.shape) == (1, 80, 512) and "txt_feats" not in model.state_dict()


def test_yoloe_names_take_a_scale_letter():
    """``yoloe-11s.yaml`` and ``yoloe-v8s-seg.yaml`` resolve to the packaged
    YAML at s; the JAX facade does not resolve them (ROADMAP queue 3, item 36)."""
    from fce_yolo_tpu.api import _resolve_yaml

    with pytest.raises(FileNotFoundError):
        _resolve_yaml("yoloe-11s.yaml")
    for name, base in (("yoloe-11s.yaml", "yoloe-11"), ("yoloe-v8s-seg.yaml", "yoloe-v8-seg"),
                       ("yolov8s-worldv2.yaml", "yolov8-worldv2")):
        m = YOLO(name, device="meta")
        assert m.scale == "s" and m.spec.yaml_dict == build_model(f"{base}.yaml", device="meta")[1].yaml_dict


# ------------------------------------------------------------- tiny graphs
def _port_model(path, seed=0):
    """The port model of ``path`` on its init from ``seed`` with spread BN
    statistics, contrastive biases 0 (scores spread around 0.5) and a
    non-zero ``reprta`` output layer and attention biases, in eval mode, with
    its weights as flax variables."""
    model, spec, strides = build_model(path, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
            elif n.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
        for n, p in model.named_parameters():
            if ".cv4." in n and n.endswith(".bias"):
                p.zero_()
            elif ".w3." in n or n.endswith("attn.bias"):
                p.normal_(0.0, 0.05, generator=g)
    model.eval()
    return model, state_dict_to_variables(model)


@pytest.fixture(scope="module")
def tiny(yamls):
    return {k: _port_model(p) for k, p in yamls.items()}


@pytest.mark.parametrize("name,visual", [("world", False), ("yoloe", False), ("yoloe", True), ("yoloe-seg", True)])
def test_tiny_graph_matches_jax(yamls, tiny, name, visual):
    """Eval preds and train feats of the whole graph from the same weights:
    the text threaded through C2fAttn, ImagePoolingAttn and the head, or the
    head's SAVPE on visual prompts; a (1, K, 512) text broadcast to the batch."""
    model, v = tiny[name]
    jm = jax_detection_model(yamls[name])[0]
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    txt = _x((1, 4, 512), 5)
    kw = {"visual_prompts": _masks(2, 3, 8, 8, empty=(2,))} if visual else {}
    ref = jax.jit(lambda v, x, t, **k: jm.apply(v, x, train=False, txt_feats=jnp.broadcast_to(t, (2, 4, 512)), **k))(
        v, jnp.asarray(x), jnp.asarray(txt), **{k: jnp.asarray(a) for k, a in kw.items()})
    with torch.no_grad():
        out = model(_nchw(x), txt_feats=torch.from_numpy(txt), **{k: torch.from_numpy(a) for k, a in kw.items()})
    assert out["preds"].shape[-1] == 4 + (3 if visual else 4) + (8 if "seg" in name else 0)
    _close(ref["preds"], out["preds"])
    scores = np.asarray(ref["preds"])[..., 4:7]
    assert scores.std() > 1e-3  # the class channels carry signal
    _close(scores, out["preds"][..., 4:7])


def test_tiny_world_train_feats_match_jax(yamls, tiny):
    model, v = tiny["world"]
    jm = jax_detection_model(yamls["world"])[0]
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    txt = _x((2, 6, 512), 6)
    ref, _ = jax.jit(lambda v, x, t: jm.apply(v, x, train=True, txt_feats=t, mutable=["batch_stats"]))(
        v, jnp.asarray(x), jnp.asarray(txt))
    m = build_model(yamls["world"], device="cpu")[0]
    m.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = m.train()(_nchw(x), txt_feats=torch.from_numpy(txt))
    for r, o in zip(_maps(ref["feats"]), out["feats"]):
        assert o.shape[1] == 64 + 6
        _close(r, o)


def test_bound_text_survives_fold_and_copy(yamls):
    """The ``txt_feats`` buffer scores the graph when no text is passed, and
    ``fold_conv_bn`` of a deep copy and ``weights_version`` carry and see it."""
    from fce_yolo_tpu_torch.nn.model import fold_conv_bn, weights_version

    model, _ = _port_model(yamls["yoloe"])
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    txt = torch.from_numpy(_x((1, 5, 512), 9))
    key = weights_version(model)
    model.txt_feats = txt
    assert weights_version(model) != key
    with torch.no_grad():
        ref = model(x, txt_feats=txt)["preds"]
        bound = model(x)["preds"]
        folded = fold_conv_bn(copy.deepcopy(model))(x)["preds"]
    torch.testing.assert_close(bound, ref, rtol=0, atol=0)
    torch.testing.assert_close(folded, ref, rtol=1e-4, atol=1e-4)
    assert folded.shape[-1] == 4 + 5


# ------------------------------------------------------------------ facades
@pytest.fixture(scope="module")
def facades(yamls, tiny):
    """(JAX facade, port facade) of each tiny model on the same weights,
    classes bound to the same names (the hash encoder's embeddings)."""
    from fce_yolo_tpu.models.world import YOLOWorldTrainable as JaxWorld
    from fce_yolo_tpu.models.yoloe import YOLOE as JaxYOLOE

    out = {}
    for name, jcls, pcls in (("world", JaxWorld, YOLOWorldTrainable), ("yoloe", JaxYOLOE, YOLOE),
                             ("yoloe-seg", JaxYOLOE, YOLOE)):
        model, v = tiny[name]
        jy = jcls(yamls[name], nc=3)
        jy.variables = jax.tree_util.tree_map(jnp.asarray, v)
        port = pcls(yamls[name], device="cpu", nc=3)
        port.model.load_state_dict(model.state_dict())
        for f in (jy, port):
            f.set_classes(["circle", "square", "tri"])
        out[name] = (jy, port)
    return out


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]


def _same_results(ref, out):
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        assert o.orig_shape == r.orig_shape and 0 < len(o) == len(r), (len(o), len(r))
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["world", "yoloe", "yoloe-seg"])
def test_text_predict_matches_jax_facade(facades, name):
    """Text-prompt predict at a conf that keeps about half the candidates;
    the segment model's masks too (same pixels where both agree on a box)."""
    jy, port = facades[name]
    imgs = _images(5)
    conf = float(np.median(np.concatenate([r.boxes.conf for r in port.predict(imgs, imgsz=64, conf=0.0)])))
    ref = jy.predict(imgs, imgsz=64, batch=2, conf=conf)
    out = port.predict(imgs, imgsz=64, batch=2, conf=conf)
    _same_results(ref, out)
    if name == "yoloe-seg":
        for r, o in zip(ref, out):
            assert o.masks.data.shape == r.masks.data.shape
            assert (o.masks.data != r.masks.data).mean() < 0.01


@pytest.mark.parametrize("name", ["world", "yoloe"])
def test_rebinding_classes_rescores_predict(yamls, tiny, name):
    """Predict, bind two other class lists in turn, predict again: the
    result is a fresh facade's bound to the last list (the text buffers of
    the first and the last list may share an address and a version)."""
    pcls = YOLOWorldTrainable if name == "world" else YOLOE
    imgs = _images(6)

    def facade(classes):
        port = pcls(yamls[name], device="cpu", nc=3)
        port.model.load_state_dict(tiny[name][0].state_dict())
        port.set_classes(classes)
        return port

    port = facade(["circle", "square", "tri"])
    port.predict(imgs, imgsz=64, conf=0.0)
    port.set_classes(["dog", "cat", "bird"])
    port.set_classes(["red", "green", "blue"])
    out = port.predict(imgs, imgsz=64, conf=0.0)
    ref = facade(["red", "green", "blue"]).predict(imgs, imgsz=64, conf=0.0)
    assert out[0].names == ref[0].names == {0: "red", 1: "green", 2: "blue"}
    _same_results(ref, out)


@pytest.mark.parametrize("name", ["yoloe", "yoloe-seg"])
def test_visual_prompt_predict_matches_jax_facade(facades, name):
    """One image, two prompt classes (7 with two boxes): the prompt masks,
    the detections and the caller's class ids; a segment model scores its
    prompt slots only (the JAX facade takes its mask coefficients for class
    scores too: ROADMAP queue 3, item 37)."""
    jy, port = facades[name]
    img = _images(6)[0]
    vp = {"bboxes": np.array([[10, 10, 60, 60], [70, 20, 120, 90], [5, 60, 40, 95]], np.float32),
          "cls": np.array([7, 2, 7])}
    out = port.predict(img, visual_prompts=vp, imgsz=64, conf=0.0, max_det=8)
    assert len(out) == 1 and len(out[0]) == 8 and set(out[0].boxes.cls.astype(int)) <= {2, 7}
    if name == "yoloe-seg":
        return
    ref = jy.predict(img, visual_prompts=vp, imgsz=64, conf=0.0, max_det=8)
    np.testing.assert_array_equal(out[0].boxes.cls, ref[0].boxes.cls)
    np.testing.assert_allclose(out[0].boxes.xyxy, ref[0].boxes.xyxy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out[0].boxes.conf, ref[0].boxes.conf, rtol=0, atol=1e-5)
    from fce_yolo_tpu.models.yoloe import YOLOE as JaxYOLOE

    for ratio, pad in ((0.5, (0.0, 8.0)), (0.37, (3.5, 0.0))):
        a = YOLOE._prompt_masks(vp["bboxes"], vp["cls"], 64, ratio, pad)
        b = JaxYOLOE._prompt_masks(vp["bboxes"], vp["cls"], 64, ratio, pad)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def png_world_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_world"))


@pytest.mark.parametrize("name", ["world", "yoloe"])
def test_val_matches_jax_facade(facades, png_world_dataset, name):
    jy, port = facades[name]
    ref = jy.val(data=png_world_dataset, imgsz=64, batch=2, verbose=False)
    res = port.val(data=png_world_dataset, imgsz=64, batch=2, workers=1, verbose=False)
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"):
        assert abs(res[k] - ref[k]) <= 1e-4, (k, res[k], ref[k])
    assert len(res["metrics"].stats["conf"]) == len(ref["metrics"].stats["conf"]) > 0
    np.testing.assert_array_equal(res["confusion_matrix"].matrix, ref["confusion_matrix"].matrix)


def test_export_track_and_embed_name_the_roadmap_item(facades):
    port = facades["yoloe"][1]
    for call in (port.export, lambda: port.track(np.zeros((64, 64, 3), np.uint8)),
                 lambda: port.embed(np.zeros((64, 64, 3), np.uint8))):
        with pytest.raises(NotImplementedError, match=r"item 12\.2"):
            call()
    with pytest.raises(ValueError, match="not an open-vocabulary config"):
        YOLOWorld("yolov8n.yaml", device="meta")


# -------------------------------------------------------------- train steps
def _train_batch(extra: str):
    img = np.full((2, 64, 64, 3), 40, np.uint8)
    img[0, 15:35, 10:40] = 200
    img[1, 30:55, 25:50] = 180
    img[1, 5:20, 5:15] = 90
    b = {"img": img, "cls": np.array([[0, 2], [1, 0]], np.float32),
         "bboxes": np.array([[[0.39, 0.39, 0.47, 0.31], [0, 0, 0, 0]],
                             [[0.58, 0.66, 0.39, 0.39], [0.16, 0.2, 0.16, 0.23]]], np.float32),
         "mask": np.array([[True, False], [True, True]])}
    if extra == "txt_feats":  # M = 3 texts a sample, each sample its own (the JAX loss takes K = nc channels)
        b["txt_feats"] = _x((2, 3, 512), 8)
    else:  # one mask a class, the ground truth's cells
        vp = np.zeros((2, 3, 8, 8), np.float32)
        vp[0, 0, 2:5, 1:5] = 1
        vp[1, 1, 4:7, 3:6] = 1
        vp[1, 0, 0:3, 0:2] = 1
        b["visual_prompts"] = vp
    return b


@pytest.mark.parametrize("name,extra,freeze", [("world", "txt_feats", None),
                                               ("yoloe", "visual_prompts", ["except:savpe"])])
def test_three_train_steps_match_jax(yamls, tiny, name, extra, freeze):
    """``make_train_step`` against the JAX one (training BatchNorm, AdamW,
    float32) from the same weights, three steps on one batch whose
    ``txt_feats`` or ``visual_prompts`` go to the forward; the visual-prompt
    run frozen but for ``savpe``, whose parameters alone move."""
    model, v = tiny[name]
    jm = jax_detection_model(yamls[name])[0]
    b = _train_batch(extra)
    opt = dict(optimizer="AdamW", lr0=1e-3, warmup_epochs=0, batch_size=2, nbs=2, epochs=1, steps_per_epoch=3, nc=3)
    tx = jopt.build_optimizer(jopt.OptimCfg(**opt), v["params"], freeze=freeze)
    state = jtrainer.create_train_state(jm, jax.tree_util.tree_map(jnp.asarray, v), tx)
    step = jax.jit(jtrainer.make_train_step(jm, tx, JaxDetectionLossCfg(nc=3, strides=(8, 16, 32))))
    ref = []
    for _ in range(3):
        state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()})
        ref.append(float(m["loss"]))

    pmodel = build_model(yamls[name], device="cpu")[0]
    pmodel.load_state_dict(model.state_dict())
    before = {k: t.clone() for k, t in pmodel.named_parameters()}
    o = popt.Optimizer(popt.OptimCfg(**opt), pmodel, freeze=freeze)
    pstate = ptrainer.create_train_state(pmodel, o)
    pstep = ptrainer.make_train_step(pmodel, o, DetectionLossCfg(nc=3, strides=(8, 16, 32)))
    out = []
    for _ in range(3):
        pstate, m = pstep(pstate, {k: torch.from_numpy(a) for k, a in b.items()})
        out.append(float(m["loss"]))
    assert np.isfinite(ref).all() and ref[0] != ref[2]
    for a, r in zip(out, ref):
        assert abs(a - r) <= 1e-4 * abs(r), (out, ref)
    moved = {k for k, t in pmodel.named_parameters() if not torch.equal(t, before[k])}
    assert moved and (freeze is None or all(".savpe." in k for k in moved)), sorted(moved)[:5]
    for (k, t), e in zip(pmodel.named_parameters(), pstate.ema.params):  # a frozen parameter's EMA is itself
        if freeze is not None and k not in moved:  # (the JAX EMA rounds it: ROADMAP queue 3, item 38)
            assert torch.equal(e, t), k


def test_pt_in_ultralytics_layout_reads_the_same_in_both(yamls, tmp_path):
    """A ``.pt`` of the tiny World and YOLOE-seg graphs with Ultralytics' keys
    (``attn.gl``, ``query.0``, ``projections.0``, ``cv4.0.logit_scale``,
    ``reprta.m.w12``, ``savpe.cv6.1``, ``cv5.0.2``), written here: the port's
    strict reader and the JAX reader (its ``detect`` scope from the
    template) give the same weights, but for Proto's transposed-conv
    kernel, which the JAX reader takes unflipped (ROADMAP queue 3, item 14)."""
    for name, keys in (("world", ("model.8.attn.gl.weight", "model.12.query.0.weight", "model.12.projections.2.bias",
                                  "model.16.cv4.0.logit_scale", "model.8.attn.bias")),
                       ("yoloe-seg", ("model.6.reprta.m.w12.weight", "model.6.savpe.cv6.1.weight",
                                      "model.6.cv4.1.norm.running_var", "model.6.cv5.0.2.weight",
                                      "model.6.proto.upsample.weight"))):
        model, ours0 = _port_model(yamls[name], seed=3)
        sd = model.state_dict()
        assert all(k in sd for k in keys), [k for k in keys if k not in sd]
        path = tmp_path / f"{name}.pt"
        torch.save({"model": {k: v.clone() for k, v in sd.items()}}, path)
        port = build_model(yamls[name], device="cpu")[0]
        import_torch_state_dict(load_pt_state_dict(str(path)), port)
        ours = state_dict_to_variables(port)
        theirs = jax_pt_to_variables(jax_load_pt(str(path)), template=ours0)
        a, b = ({jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
                for t in (ours, theirs))
        assert a.keys() == b.keys()
        for k in a:
            flip = "['upsample']['kernel']" in k
            np.testing.assert_array_equal(a[k], b[k][::-1, ::-1] if flip else b[k], err_msg=k)


# ----------------------------------------------------- the port's trainings
def test_train_multimodal_and_visual_prompt_on_the_cpu(yamls, png_world_dataset, tmp_path):
    """``train_multimodal`` (M = min(nc, 80) = 3 sampled texts a sample)
    and ``train_visual_prompt`` (all but ``savpe`` frozen, bit-equal after)
    run one epoch of two steps with finite losses; the visual-prompt one
    then predicts with the text of the dataset's names."""
    w = YOLOWorldTrainable(yamls["world"], device="cpu")
    res = w.train_multimodal(png_world_dataset, epochs=1, batch=4, imgsz=64, workers=1, val=False, plots=False,
                             project=str(tmp_path), name="mm", verbose=False, optimizer="SGD", lr0=0.01,
                             warmup_epochs=0, nbs=4)
    assert res["epochs_run"] == 1 and np.isfinite(res["results"][0]["train/cls_loss"])
    assert w.names == {0: "circle", 1: "square", 2: "tri"} and w.model.txt_feats.shape == (1, 3, 512)

    e = YOLOE(yamls["yoloe"], device="cpu")
    before = {k: t.clone() for k, t in e.model.named_parameters()}
    res = e.train_visual_prompt(png_world_dataset, epochs=1, batch=4, imgsz=64, workers=1, val=False, plots=False,
                                project=str(tmp_path), name="vp", verbose=False, optimizer="SGD", lr0=0.01,
                                warmup_epochs=0, nbs=4)
    assert res["epochs_run"] == 1 and np.isfinite(res["results"][0]["train/box_loss"])
    moved = {k for k, t in e.model.named_parameters() if not torch.equal(t, before[k])}
    assert moved and all(".savpe." in k for k in moved), sorted(moved)[:5]
    assert len(e.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64)) == 1
