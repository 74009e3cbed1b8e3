"""RT-DETR's parts in the port against the JAX package: the HGNetV2 blocks
and RepC3, the transformer modules (``nn/transformer.py``), the decoder's
layer, the DWConv activation the port takes from the YAML (ROADMAP queue
3, item 33), the five packaged RT-DETR YAMLs' parameter shapes at full
width, and the DETR loss's pieces (``train/detr_loss.py``).

Tolerances: every float output within 1e-5 * max|jax| (both sides float32,
sums in another order; ``test_torch_modules.py``); the denoising arrays and
the Hungarian pairs exactly equal; the loss terms within 1e-5 relative.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import modules as JM
from fce_yolo_tpu.nn import transformer as JT
from fce_yolo_tpu.nn.model import make_layer as jax_make_layer
from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu.train import detr_loss as JD
from fce_yolo_tpu.train.loss import LossState as JaxLossState
from fce_yolo_tpu_torch.cfg.models import MODELS_DIR, packaged_models
from fce_yolo_tpu_torch.nn import modules as PM
from fce_yolo_tpu_torch.nn import transformer as PT
from fce_yolo_tpu_torch.nn.model import DetectionModel, make_layer
from fce_yolo_tpu_torch.nn.parser import load_model_yaml
from fce_yolo_tpu_torch.nn.weights import key_to_flax, variables_to_state_dict
from fce_yolo_tpu_torch.train import detr_loss as PD
from fce_yolo_tpu_torch.train.loss import LossState
from test_torch_modules import _close, _nchw_to_nhwc, _pair, _randomize, _x

torch.set_num_threads(1)
RTDETR_YAMLS = ("rtdetr-l", "rtdetr-x", "rtdetr-resnet50", "rtdetr-resnet101", "yolov8-rtdetr")

BLOCKS = {
    "lightconv": (lambda: JM.LightConv(16, 24, 5), lambda: PM.LightConv(16, 24, 5), (1, 9, 8, 16)),
    "hgstem": (lambda: JM.HGStem(3, 16, 24), lambda: PM.HGStem(3, 16, 24), (2, 33, 30, 3)),
    "hgblock": (lambda: JM.HGBlock(16, 8, 32, 3, 3), lambda: PM.HGBlock(16, 8, 32, 3, 3), (1, 9, 10, 16)),
    "hgblock_light_shortcut": (lambda: JM.HGBlock(32, 8, 32, 5, 2, True, True),
                               lambda: PM.HGBlock(32, 8, 32, 5, 2, True, True), (1, 8, 9, 32)),
    "repc3": (lambda: JM.RepC3(16, 24, 2), lambda: PM.RepC3(16, 24, 2), (1, 7, 9, 16)),
    "repc3_cv3": (lambda: JM.RepC3(16, 24, 1, 0.5), lambda: PM.RepC3(16, 24, 1, 0.5), (1, 7, 9, 16)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_flax(case):
    jf, pf, shape = BLOCKS[case]
    ref, out = _pair(jf(), pf(), [_x(shape, 1)])
    _close(ref, _nchw_to_nhwc(out))


def _module_pair(jmod, pmod, args, seed=0, nchw=False):
    """Randomize the flax module's variables, bridge them into the port's
    module, run both on ``args`` (numpy; arrays go to each side, other
    values as they are; ``nchw``: the port takes the first one NCHW)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    if nchw:
        args = [np.ascontiguousarray(args[0].transpose(0, 3, 1, 2)), *args[1:]]
    v = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
    v = _randomize(dict(v), np.random.RandomState(seed))
    ref = jmod.apply(v, *jargs)
    sd = variables_to_state_dict({c: {"layers_0": t} for c, t in v.items()})
    pmod.load_state_dict({k.removeprefix("model.0."): t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        out = pmod.eval()(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    return ref, out


SHAPES = [(8, 8), (4, 5), (2, 3)]
LV = sum(h * w for h, w in SHAPES)


def _refs(n, rng, width):
    r = rng.uniform(0.1, 0.9, (2, 7, *n, width)).astype(np.float32)
    if width == 4:
        r[..., 2:] = rng.uniform(0.05, 0.4, r[..., 2:].shape)
    return r


def _dn_mask(nq):
    m = np.zeros((nq, nq), bool)
    m[3:, :3] = True  # the last queries do not see the first three
    return m


def _transformer_cases():
    rng = np.random.RandomState(4)
    q, value = _x((2, 7, 32), 2), _x((2, LV, 32), 3)
    return {
        "msdeform_points": (lambda: JT.MSDeformAttn(32, 3, 4, 2), lambda: PT.MSDeformAttn(32, 3, 4, 2),
                            [q, _refs((3,), rng, 2), value, SHAPES]),
        "msdeform_boxes": (lambda: JT.MSDeformAttn(32, 3, 4, 3), lambda: PT.MSDeformAttn(32, 3, 4, 3),
                           [q, _refs((3,), rng, 4), value, SHAPES]),
        "aifi": (lambda: JT.AIFI(32, 48, 4), lambda: PT.AIFI(32, 48, 4), [_x((2, 5, 6, 32), 5)]),
        "encoder_layer_pos": (lambda: JT.TransformerEncoderLayer(32, 48, 4),
                              lambda: PT.TransformerEncoderLayer(32, 48, 4), [q, _x((2, 7, 32), 8)]),
        "decoder_layer": (lambda: JT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                          lambda: PT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                          [q, _refs((), rng, 4), value, SHAPES, None, _x((2, 7, 32), 6)]),
        "decoder_layer_masked": (lambda: JT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                                 lambda: PT.DeformableTransformerDecoderLayer(32, 4, 64, 3, 2),
                                 [q, _refs((), rng, 4), value, SHAPES, _dn_mask(7), None]),
        "mlp": (lambda: JT.MLP(24, 4, 3), lambda: PT.MLP(32, 24, 4, 3), [q]),
    }


@pytest.mark.parametrize("case", sorted(_transformer_cases()))
def test_transformer_module_matches_flax(case):
    jf, pf, args = _transformer_cases()[case]
    ref, out = _module_pair(jf(), pf(), args, nchw=case == "aifi")
    _close(ref, _nchw_to_nhwc(out) if case == "aifi" else out)


def test_tables_match_jax():
    """AIFI's sin-cos table (its w-major order), MSDeformAttn's offset bias
    and ``inverse_sigmoid`` against the JAX functions."""
    np.testing.assert_array_equal(PT.build_2d_sincos_pos_embed(5, 3, 16).numpy(),
                                  np.asarray(JT.build_2d_sincos_pos_embed(5, 3, 16)))
    np.testing.assert_array_equal(PT.sampling_offsets_bias(8, 3, 4).numpy(),
                                  np.asarray(JT._sampling_offsets_bias_init(8, 3, 4)(None, (8 * 3 * 4 * 2,))))
    x = np.linspace(-0.5, 1.5, 41, dtype=np.float32)
    np.testing.assert_allclose(PT.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(JT.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_layernorm2d_matches_flax():
    ref, out = _module_pair(JT.LayerNorm2d(), PT.LayerNorm2d(16), [_x((2, 4, 5, 16), 7)], nchw=True)
    _close(ref, _nchw_to_nhwc(out))


@pytest.mark.parametrize("yaml_name", ["rtdetr-l", "rtdetr-x"])
def test_dwconv_act_from_yaml_differs_from_jax(yaml_name):
    """Queue 3, item 33: rtdetr-l and -x write ``DWConv, [c2, 3, 2, 1,
    False]``, Ultralytics' (c2, k, s, d, act): no activation. The port
    honours ``d`` and ``act``; the JAX ``make_layer`` passes only k and s,
    so its layer is SiLU of the port's on the same weights."""
    spec, jspec = load_model_yaml(f"{yaml_name}.yaml"), jax_load_model_yaml(f"{yaml_name}.yaml")
    idx = [ls.i for ls in spec.layers if ls.name == "DWConv"]
    assert len(idx) == 3
    ls = spec.layers[idx[0]]
    assert ls.args[2:] == [3, 2, 1, False]
    layer = make_layer(ls, None)
    assert layer.act is False and layer.conv.groups == ls.args[0] == ls.args[1]
    jl = jax_make_layer(jspec.layers[idx[0]], None)
    ref, out = _pair(jl, layer, [_x((1, 10, 9, ls.args[0]), 3)])
    _close(ref, _nchw_to_nhwc(torch.nn.functional.silu(out)))
    assert float((out < 0).sum()) > 0  # without the activation the layer keeps negative values


def test_dwconv_act_appears_only_in_the_rtdetr_yamls():
    """No other packaged YAML passes ``d``/``act`` to DWConv, so no earlier
    result moves with item 33."""
    seen = set()
    for p in sorted(MODELS_DIR.glob("*.yaml")):
        for line in p.read_text().splitlines():
            m = re.search(r"DWConv,\s*\[([^\]]*)\]", line.split("#")[0])
            if m and len(m.group(1).split(",")) > 3:
                seen.add(p.stem)
    assert seen == {"rtdetr-l", "rtdetr-x"}


@pytest.mark.parametrize("yaml_name", RTDETR_YAMLS)
def test_full_width_yaml_shapes_match_jax(yaml_name):
    """Each packaged RT-DETR YAML builds in the port (on the meta device:
    shapes only) with every parameter of the JAX init, at its bridged path
    and shape (structure only, no forward at full width)."""
    assert yaml_name in packaged_models()
    name = f"{yaml_name.replace('yolov8', 'yolov8l')}.yaml"
    from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel

    jspec = jax_load_model_yaml(name)
    jm = JaxDetectionModel(spec=jspec, strides=(8, 16, 32))
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    spec = load_model_yaml(name)
    assert spec.task == jspec.task == "rtdetr"
    with torch.device("meta"):
        model = DetectionModel(spec, (8, 16, 32))
    got = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = key_to_flax(model, key)
        shape = tuple(t.shape)
        if path[-1] == "kernel":
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
        got[jax.tree_util.keystr((jax.tree_util.DictKey(coll),
                                  *(jax.tree_util.DictKey(p) for p in path)))] = shape
    assert got == ref


def test_cdn_group_equals_jax():
    rng = np.random.RandomState(0)
    for b, m, nc, nq, seed in ((2, 3, 5, 7, 0), (3, 6, 80, 300, 5), (1, 1, 2, 10, 11)):
        cls = rng.randint(0, nc, (b, m)).astype(np.float32)
        box = np.clip(rng.rand(b, m, 4) * 0.5 + 0.25, 0, 1).astype(np.float32)
        mask = rng.rand(b, m) > 0.3
        out, ref = (f(cls, box, mask, nc=nc, nq=nq, rng=seed) for f in (PD.make_cdn_group, JD.make_cdn_group))
        assert out["num_group"] == ref["num_group"]
        for k in ("dn_cls", "dn_bbox", "dn_attn_mask"):
            assert out[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(out[k], ref[k])


def _detr_inputs(seed=0, layers=3, b=3, nq=40, m=6, nc=5, nd=0):
    rng = np.random.RandomState(seed)
    bboxes = np.concatenate([rng.uniform(0.2, 0.8, (layers, b, nd + nq, 2)),
                             rng.uniform(0.05, 0.5, (layers, b, nd + nq, 2))], -1).astype(np.float32)
    scores = rng.normal(0, 1.5, (layers, b, nd + nq, nc)).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.05, 0.5, (b, m, 2))], -1)
    mask = np.zeros((b, m), bool)
    for i, k in enumerate(rng.randint(0, m + 1, b)):
        mask[i, :k] = True
    mask[0, :2] = True
    gt = np.where(mask[..., None], gt, 0).astype(np.float32)
    cls = np.where(mask, rng.randint(0, nc, (b, m)), 0).astype(np.float32)
    return bboxes, scores, gt, cls, mask


def test_hungarian_match_pairs_equal_jax():
    cfg_p = PD.DETRLossCfg(nc=5)
    match = jax.jit(lambda *a: JD.hungarian_match(*a, JD.DETRLossCfg(nc=5)))  # one compile, kept on disk
    for seed in range(3):
        bboxes, scores, gt, cls, mask = _detr_inputs(seed)
        ref = np.asarray(match(jnp.asarray(bboxes[0]), jnp.asarray(scores[0]), jnp.asarray(gt),
                               jnp.asarray(cls).astype(jnp.int32), jnp.asarray(mask)))
        out = PD.hungarian_match(torch.from_numpy(bboxes[0]), torch.from_numpy(scores[0]), torch.from_numpy(gt),
                                 torch.from_numpy(cls).long(), torch.from_numpy(mask), cfg_p).numpy()
        np.testing.assert_array_equal(out[mask], ref[mask])
        for row in out:  # every slot, padded ones too, holds a query of its own
            assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("with_dn", [False, True])
def test_detr_loss_terms_match_jax(with_dn):
    nd = 2 * (100 // 6) * 6 if with_dn else 0  # G = 100 // M groups of 2M slots
    bboxes, scores, gt, cls, mask = _detr_inputs(1, layers=4, nd=nd)
    out = {"dec_bboxes": bboxes[1:], "dec_scores": scores[1:], "enc_bboxes": bboxes[0, :, nd:],
           "enc_scores": scores[0, :, nd:]}
    batch = {"cls": cls, "bboxes": gt, "mask": mask}
    if with_dn:
        g = PD.make_cdn_group(cls, gt, mask, nc=5, nq=40, rng=3)
        assert g["dn_cls"].shape[1] == nd
        batch["dn_cls"] = g["dn_cls"]
    jt, jp, _ = jax.jit(lambda o, b: JD.detr_loss(o, b, JD.DETRLossCfg(nc=5), JaxLossState.init()))(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in batch.items()})
    pt, pp, _ = PD.detr_loss({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()},
                             {k: torch.from_numpy(v) for k, v in batch.items()}, PD.DETRLossCfg(nc=5),
                             LossState.init("cpu"))
    for k in ("cls", "box", "giou", "aux", "dn", "fg_count"):
        r = float(jp[k])
        assert abs(float(pp[k]) - r) <= 1e-5 * abs(r), (k, float(pp[k]), r)
    assert (float(jp["dn"]) > 0) == with_dn
    assert abs(float(pt) - float(jt)) <= 1e-5 * abs(float(jt))
    assert pp["match_host_s"] >= 0.0


def test_detr_loss_gradients_match_jax():
    """d loss / d (boxes, scores) of every layer against ``jax.grad`` (the
    matches fixed by the forward, as both sides stop their gradient)."""
    bboxes, scores, gt, cls, mask = _detr_inputs(2, layers=3)
    batch_j = {"cls": jnp.asarray(cls), "bboxes": jnp.asarray(gt), "mask": jnp.asarray(mask)}

    def jloss(bx, sc):
        out = {"dec_bboxes": bx[1:], "dec_scores": sc[1:], "enc_bboxes": bx[0], "enc_scores": sc[0]}
        return JD.detr_loss(out, batch_j, JD.DETRLossCfg(nc=5), JaxLossState.init())[0]

    gb, gs = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(bboxes), jnp.asarray(scores))
    bx, sc = torch.from_numpy(bboxes).requires_grad_(), torch.from_numpy(scores).requires_grad_()
    out = {"dec_bboxes": bx[1:], "dec_scores": sc[1:], "enc_bboxes": bx[0], "enc_scores": sc[0]}
    PD.detr_loss(out, {k: torch.from_numpy(v) for k, v in zip(("cls", "bboxes", "mask"), (cls, gt, mask))},
                 PD.DETRLossCfg(nc=5), LossState.init("cpu"))[0].backward()
    _close(gb, bx.grad)
    _close(gs, sc.grad)
