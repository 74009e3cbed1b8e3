"""YOLOv10 in the port against the JAX package: the v10 blocks and
``V10Detect`` against their flax twins, yolov10n's whole forward and its
Conv+BN fold, ``preds6`` and its ties, the NMS-free predict through the
facade's call (ROADMAP queue 3, item 25) and the end-to-end val (item 26).

Tolerance: max|port - jax| <= 1e-5 * max|jax| on every float output, as
``test_torch_modules.py`` (both sides float32, sums in another order);
``preds6``'s classes and order equal; predict's detections: counts and
classes equal, boxes within 1e-3 px, scores within 1e-5; val's P, R, mAP50
and mAP50-95 within 1e-4 and the confusion matrix equal.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fce_yolo_tpu
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from fce_yolo_tpu.nn import heads as JH
from fce_yolo_tpu.nn import modules as JM
from fce_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold_conv_bn
from fce_yolo_tpu.nn.parser import parse_model_yaml as jax_parse_model_yaml
from fce_yolo_tpu.utils.metrics import ConfusionMatrix as JaxConfusionMatrix
from fce_yolo_tpu.utils.metrics import DetMetrics as JaxDetMetrics
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg.models import load_model_dict, packaged_models
from fce_yolo_tpu_torch.nn import heads as PH
from fce_yolo_tpu_torch.nn import modules as PM
from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables, variables_to_state_dict
from test_torch_data import png_copy
from test_torch_modules import _close, _nchw_to_nhwc, _pair, _x, jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)
JAX_V10N = str(Path(fce_yolo_tpu.__file__).parent / "cfg" / "models" / "yolov10n.yaml")  # the JAX facade takes a path
V10 = ("yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x")

CASES = {
    "repvggdw": (lambda: JM.RepVGGDW(16), lambda: PM.RepVGGDW(16), (1, 9, 7, 16)),
    "cib_add": (lambda: JM.CIB(16, 16), lambda: PM.CIB(16, 16), (1, 7, 8, 16)),
    "cib_lk": (lambda: JM.CIB(16, 32, True, 0.5, True), lambda: PM.CIB(16, 32, True, 0.5, True), (1, 9, 7, 16)),
    "c2fcib_lk": (lambda: JM.C2fCIB(32, 32, 2, True, True), lambda: PM.C2fCIB(32, 32, 2, True, True),
                  (1, 8, 9, 32)),
    "c2fcib": (lambda: JM.C2fCIB(16, 32, 1), lambda: PM.C2fCIB(16, 32, 1), (2, 6, 5, 16)),
    "psa": (lambda: JM.PSA(256, 256), lambda: PM.PSA(256, 256), (1, 4, 5, 256)),
    "scdown": (lambda: JM.SCDown(16, 32, 3, 2), lambda: PM.SCDown(16, 32, 3, 2), (1, 9, 10, 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    jf, pf, shape = CASES[case]
    ref, out = _pair(jf(), pf(), [_x(shape, 1)])
    _close(ref, _nchw_to_nhwc(out))


def _head_pair(zero_cls: bool = False):
    """V10Detect (nc 5, two levels) and its flax twin on random weights;
    ``zero_cls`` zeroes the one-to-one class convs, so every score is 0.5."""
    jm = JH.V10Detect(nc=5, ch=(16, 32), strides=(8, 16))
    pm = PH.V10Detect(nc=5, ch=(16, 32), strides=(8, 16))
    xs = [_x((2, 8, 6, 16), 2), _x((2, 4, 3, 32), 3)]
    ref, out = _pair(jm, pm, xs)
    if zero_cls:
        with torch.no_grad():
            for branch in pm.one2one_cv3:
                branch[-1].weight.zero_()
                branch[-1].bias.zero_()
            out = pm([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
        ref = jax.jit(lambda v, xs: jm.apply(v, xs, train=False))(state_dict_to_variables(pm),
                                                                   [jnp.asarray(x) for x in xs])
    return ref, out, xs, pm


def _check_preds6(ref6, out6, strict: bool = False):
    """Scores equal position by position within 1e-5 * max; rows (class and
    box) equal in the same order. Unless ``strict``, two rows may trade
    places inside a run of scores within 2e-6 of each other (a near-tie that
    float32's other summation order can flip); such a run is compared as a
    set of rows."""
    ref6, out6 = np.asarray(ref6), out6.numpy()
    assert ref6.shape == out6.shape
    _close(ref6[..., 4], torch.from_numpy(out6[..., 4]))
    tol = 1e-5 * float(np.abs(ref6[..., :4]).max())
    for r, o in zip(ref6, out6):
        cut = np.flatnonzero(np.diff(r[:, 4]) < -2e-6) + 1 if not strict else np.arange(1, len(r))
        for rr, oo in zip(np.split(r, cut), np.split(o, cut)):
            left = list(range(len(rr)))  # each port row takes an equal JAX row of its run
            for row in oo:
                j = next((j for j in left if rr[j, 5] == row[5] and np.abs(rr[j, :4] - row[:4]).max() <= tol), None)
                assert j is not None, (row, rr)
                left.remove(j)


def test_v10detect_matches_flax():
    """Eval: ``preds6`` (k = min(300, 80 anchors) rows, xyxy), both levels'
    one-to-many and one-to-one maps. Training mode gives the two map sets;
    the one-to-one maps carry no gradient back to the inputs (they run on
    them detached, as JAX's ``stop_gradient``), the one-to-many maps do."""
    ref, out, xs, pm = _head_pair()
    assert set(out) == set(ref) == {"preds6", "feats", "one2one_feats"}
    assert out["preds6"].shape == (2, 8 * 6 + 4 * 3, 6)
    _check_preds6(ref["preds6"], out["preds6"])
    for key in ("feats", "one2one_feats"):
        for r, o in zip(ref[key], out[key]):
            _close(r, _nchw_to_nhwc(o))
    pm.train()
    inputs = [torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_() for x in xs]
    train = pm(inputs)
    assert set(train) == {"feats", "one2one_feats"}
    assert [tuple(f.shape) for f in train["one2one_feats"]] == [tuple(f.shape) for f in out["one2one_feats"]]
    sum(f.sum() for f in train["one2one_feats"]).backward()
    assert all(x.grad is None for x in inputs)
    sum(f.sum() for f in train["feats"]).backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in inputs)


def test_preds6_ties_go_to_the_lower_index_as_jax():
    """Every one-to-one score 0.5 exactly: both top-k steps tie everywhere,
    and ``jax.lax.top_k`` takes the lower index first; the port's
    ``stable_topk`` does the same, so anchors come in index order, each with
    classes 0..4, and the boxes follow them. ``torch.topk`` promises no
    order on ties."""
    ref, out, *_ = _head_pair(zero_cls=True)
    p6 = out["preds6"].numpy()
    assert (p6[..., 4] == 0.5).all()
    np.testing.assert_array_equal(p6[0, :10, 5], np.tile(np.arange(5), 2))
    _check_preds6(ref["preds6"], out["preds6"], strict=True)
    values, idx = PH.stable_topk(torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.125]]), 4)
    assert idx.tolist() == [[1, 3, 0, 2]] and values.tolist() == [[0.75, 0.75, 0.5, 0.5]]


def _bridged(cfg: str = "yolov10n.yaml", nc: int | None = None, seed: int = 0):
    """(JAX model, flax variables, port model) of ``cfg`` on the same weights
    (the port's seeded init, random BatchNorm statistics), through the
    bridge both ways."""
    d, scale = load_model_dict(cfg)
    if nc is not None:
        d["nc"] = nc
    model, spec, strides = build_model(copy.deepcopy(d), scale=scale, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
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
    assert all(torch.equal(t, sd[k]) for k, t in back.items())
    jmodel = JaxDetectionModel(spec=jax_parse_model_yaml(d, scale=scale), strides=strides)
    return jmodel, v, model


@pytest.fixture(scope="module")
def v10n():
    """yolov10n (3 classes) on bridged weights, the one2one box branch's DFL
    bin 1 raised by 8 so boxes are about two strides wide (val's mAP above zero),
    and one jitted JAX forward shared by the tests of this module."""
    jmodel, _, model = _bridged(nc=3)
    with torch.no_grad():
        for branch in model.detect.one2one_cv2:
            branch[-1].bias[1::16] += 8.0
    v = state_dict_to_variables(model)
    return jmodel, v, model, jax.jit(lambda v, x: jmodel.apply(v, x, train=False))


def _x160(seed: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).rand(3, 160, 160, 3).astype(np.float32)


def _assert_forward(ref: dict, out: dict) -> None:
    assert set(out) == set(ref)
    _check_preds6(ref["preds6"], out["preds6"])
    for key in ("feats", "one2one_feats"):
        assert len(out[key]) == len(ref[key]) == 3
        for r, o in zip(ref[key], out[key]):
            _close(r, _nchw_to_nhwc(o))


def test_yolov10n_forward_matches_jax(v10n):
    jmodel, v, model, fwd = v10n
    x = _x160()
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    _assert_forward(fwd(v, jnp.asarray(x)), out)


def test_yolov10n_fold_matches_the_jax_fold(v10n):
    """Every ConvBNAct folds, RepVGGDW's two act-less branches each on its
    own, in the conv's dtype; the folded model gives the JAX fold's outputs."""
    jmodel, v, model, _ = v10n
    folded = fold_conv_bn(copy.deepcopy(model)).eval()
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    rep = next(m for m in folded.modules() if isinstance(m, PM.RepVGGDW))
    assert rep.conv.folded and rep.conv1.folded and rep.conv.conv.bias is not None
    x = _x160(4)[:2]
    with torch.no_grad():
        out = folded(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_forward(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jax_fold_conv_bn(v), jnp.asarray(x)), out)
    bf16 = fold_conv_bn(copy.deepcopy(model).to(torch.bfloat16))
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())


@pytest.mark.parametrize("name", V10)
def test_v10_yamls_are_packaged_and_match_the_jax_parse(name):
    """Each v10 YAML is a byte-equal copy of the JAX package's, is listed,
    and parses to the JAX layer list; the meta build's parameter count
    equals the flax one (``jax.eval_shape`` of the init at 64 px)."""
    import fce_yolo_tpu_torch
    from fce_yolo_tpu_torch.nn.parser import load_model_yaml

    src = Path(fce_yolo_tpu.__file__).parent / "cfg" / "models" / f"{name}.yaml"
    dst = Path(fce_yolo_tpu_torch.__file__).parent / "cfg" / "models" / f"{name}.yaml"
    assert dst.read_bytes() == src.read_bytes() and name in packaged_models()
    spec = load_model_yaml(f"{name}.yaml")
    from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml

    jspec = jax_load_model_yaml(src)
    assert [(ls.name, ls.f, ls.args, ls.c2) for ls in spec.layers] == \
           [(ls.name, ls.f, ls.args, ls.c2) for ls in jspec.layers]
    assert spec.save == jspec.save and spec.legacy == jspec.legacy is False
    if name == "yolov10n":
        model, _, strides = build_model(f"{name}.yaml", device="meta")
        jm = JaxDetectionModel(spec=jspec, strides=strides)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        assert sum(p.numel() for p in model.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]


def test_call_is_predict_and_matches_the_jax_facade(v10n):
    """Queue 3, item 25: ``YOLO(m)(source)`` is ``YOLO(m).predict(source)``
    (the JAX facade's ``__call__``), here on yolov10n's NMS-free path:
    equal to the JAX facade's call on the same weights (no NMS; scores
    above ``conf``), ``classes`` filtering as on every path."""
    _, v, model, _ = v10n
    port = YOLO("yolov10n.yaml", device="cpu", nc=3)
    port.model.load_state_dict(model.state_dict())
    jy = JaxYOLO(JAX_V10N, nc=3)
    jy.variables = v
    imgs = _images()
    ref = jy(imgs, imgsz=128, batch=2, conf=0.5)
    out = port(imgs, imgsz=128, batch=2, conf=0.5)
    again = port.predict(imgs, imgsz=128, batch=2, conf=0.5)
    assert len(out) == len(ref) == len(again) == len(imgs)
    for r, o, a in zip(ref, out, again):
        np.testing.assert_array_equal(o.boxes.data, a.boxes.data)
        assert o.orig_shape == r.orig_shape and 0 < len(o) == len(r) < 300
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
    only = port(imgs, imgsz=128, batch=2, conf=0.5, classes=[1])
    assert all(len(f) == int((o.boxes.cls == 1).sum()) and (f.boxes.cls == 1).all() for f, o in zip(only, out))


@pytest.fixture(scope="module")
def png_v10_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_v10"))


def test_val_is_end_to_end_where_the_jax_validator_raises(v10n, png_v10_dataset):
    """Queue 3, item 26: the JAX ``YOLO.val`` of a v10 model raises
    ``KeyError: 'preds'`` (its validator reads ``preds``, which V10Detect
    does not give). The port validates ``preds6`` end to end with no NMS;
    its P, R, mAP and confusion matrix equal the JAX package's own metric
    code (``DetectionValidator._update_metrics``, ``DetMetrics``) fed the JAX
    model's ``preds6`` on the same images, as the JAX predictor takes them
    (valid where the score is above ``conf``)."""
    jmodel, v, model, fwd = v10n
    jy = JaxYOLO(JAX_V10N, nc=3)
    jy.variables = v
    with pytest.raises(KeyError, match="preds"):
        jy.val(data=png_v10_dataset, imgsz=160, batch=3, verbose=False)

    port = YOLO("yolov10n.yaml", device="cpu", nc=3)
    port.model.load_state_dict(model.state_dict())
    res = port.val(data=png_v10_dataset, imgsz=160, batch=3, workers=1, verbose=False)

    names = {0: "circle", 1: "square", 2: "tri"}
    jval = JaxDetectionValidator(jmodel, names, imgsz=160, batch_size=3, workers=1)
    metrics, cm, n = JaxDetMetrics(names=names), JaxConfusionMatrix(names=names), 0
    for batch in jval.get_dataloader(png_v10_dataset):
        p6 = np.asarray(fwd(v, jnp.asarray(batch["img"], jnp.float32) / 255.0)["preds6"])
        out = {"boxes": p6[..., :4], "scores": p6[..., 4], "classes": p6[..., 5].astype(np.int32),
               "valid": p6[..., 4] > jval.conf}
        jval._update_metrics(out, batch, metrics, cm, None, n)
        n += batch["n_valid"]
    metrics.process(nc=3)
    assert n == 4 and metrics.mean_results()[2] > 0
    np.testing.assert_allclose(res["metrics"].mean_results(), metrics.mean_results(), rtol=0, atol=1e-4)
    for out, ref in zip(res["metrics"].stats["pred_cls"], metrics.stats["pred_cls"]):
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(res["confusion_matrix"].matrix, cm.matrix)


def test_stem_gate_passes_v10_by():
    """Layer 2 of every v10 form is a C2f, so the fused stem's gate refuses
    them at every scale, as the JAX gate does: v10 predict launches no stem."""
    from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
    from fce_yolo_tpu.ops import pallas_stem as PS
    from fce_yolo_tpu_torch.nn.parser import load_model_yaml
    from fce_yolo_tpu_torch.ops import stem as S

    for name in V10:
        spec = load_model_yaml(f"{name}.yaml")
        assert spec.layers[2].name == "C2f"
        assert S.stem_spec_from_model(spec, (640, 640)) is None
        assert PS.stem_spec_from_model(jax_load_model_yaml(f"{name}.yaml"), (640, 640)) is None
