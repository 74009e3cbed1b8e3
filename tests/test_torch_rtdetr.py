"""RT-DETR in the port against the JAX package, model by model: the tiny
configuration of ``tests/test_rtdetr.py`` (a Conv trunk and
``RTDETRDecoder, [nc, 64, 40, 2]``) and a tiny one with every new block
(HGStem, HGBlock with and without LightConv, AIFI, RepC3), on the port's
seeded weights bridged to flax: the eval ``preds``, the encoder's top-k,
three train steps, predict and val through both facades, an Ultralytics
``.pt`` read by both readers, and the ``RTDETR`` facade, the CLI and
``YOLO.info`` on ``rtdetr-l.yaml``.

Tolerances: ``preds`` within 1e-4 absolute (sigmoid boxes and scores in
[0, 1]; both sides float32); the top-k indices equal, also at 448 px
where the invalid border anchors all share one score and fill the top nq,
so the order is the tie rule; per-step train losses within 1e-4 relative;
predict's classes and order equal, boxes within 1e-3 px, scores within
1e-5; val's P, R, mAP50 and mAP50-95 within 1e-4 and the confusion matrix
equal; weights read from a ``.pt`` equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.nn.import_torch import load_pt_state_dict as jax_load_pt
from fce_yolo_tpu.nn.import_torch import state_dict_to_variables as jax_pt_to_variables
from fce_yolo_tpu.train import detr_loss as JD
from fce_yolo_tpu.train import optim as jopt
from fce_yolo_tpu.train import trainer as jtrainer
from fce_yolo_tpu.train.loss import DetectionLossCfg as JaxDetectionLossCfg
from fce_yolo_tpu_torch import RTDETR, YOLO
from fce_yolo_tpu_torch.engine.validator import RTDETRValidator
from fce_yolo_tpu_torch.nn import heads as PH
from fce_yolo_tpu_torch.nn.import_torch import import_torch_state_dict, load_pt_state_dict
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.train import detr_loss as PD
from fce_yolo_tpu_torch.train import optim as popt
from fce_yolo_tpu_torch.train import trainer as ptrainer
from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
from test_torch_data import png_copy
from test_torch_modules import jax_detection_model

torch.set_num_threads(1)

TINY = """nc: 3
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]] # P3/8
  - [-1, 1, Conv, [48, 3, 2]] # P4/16
  - [-1, 1, Conv, [64, 3, 2]] # P5/32
head:
  - [[2, 3, 4], 1, RTDETRDecoder, [nc, 64, 40, 2]]
"""
HG_TINY = """nc: 3
backbone:
  - [-1, 1, HGStem, [8, 16]] # 0 P2/4
  - [-1, 2, HGBlock, [8, 32, 3]]
  - [-1, 1, DWConv, [32, 3, 2]] # 2 P3/8
  - [-1, 2, HGBlock, [16, 48, 3, True, False]] # 3
  - [-1, 1, DWConv, [48, 3, 2]] # 4 P4/16
  - [-1, 2, HGBlock, [16, 48, 5, True, True]] # 5
  - [-1, 1, DWConv, [64, 3, 2]] # 6 P5/32
head:
  - [-1, 1, Conv, [32, 1, 1, None, 1, 1, False]] # 7
  - [-1, 1, AIFI, [64, 4]] # 8
  - [-1, 1, Conv, [32, 1, 1]] # 9
  - [-1, 1, nn.Upsample, [None, 2, "nearest"]] # 10
  - [5, 1, Conv, [32, 1, 1, None, 1, 1, False]] # 11
  - [[-2, -1], 1, Concat, [1]] # 12
  - [-1, 2, RepC3, [32]] # 13
  - [-1, 1, Conv, [32, 3, 2]] # 14
  - [[-1, 9], 1, Concat, [1]] # 15
  - [-1, 2, RepC3, [32, 0.5]] # 16
  - [[3, 13, 16], 1, RTDETRDecoder, [nc, 32, 30, 2]] # 17
"""


@pytest.fixture(scope="module")
def yamls(tmp_path_factory):
    root = tmp_path_factory.mktemp("rtdetr_yaml")
    (root / "rtdetr-tiny.yaml").write_text(TINY)
    (root / "rtdetr-hg-tiny.yaml").write_text(HG_TINY)
    return {"tiny": str(root / "rtdetr-tiny.yaml"), "hg": str(root / "rtdetr-hg-tiny.yaml")}


def _pair(path, seed=0):
    """The port model (eval, its init from ``seed``), its weights as flax
    numpy variables, and the JAX model (known strides: no probe)."""
    model, spec, strides = build_model(path, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    jm, jspec, _ = jax_detection_model(path)
    assert spec.task == jspec.task == "rtdetr" and strides == (8, 16, 32)
    return model, state_dict_to_variables(model), jm


@pytest.fixture(scope="module")
def tiny(yamls):
    return _pair(yamls["tiny"])


def _images(n, size, seed):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _topk_recorders(monkeypatch):
    """Record the encoder's top-k indices on both sides: the port's
    ``stable_topk`` and ``jax.lax.top_k`` (through a debug callback, so it
    works under ``jax.jit``)."""
    got = {"jax": [], "port": []}
    jtop, ptop = jax.lax.top_k, PH.stable_topk

    def jax_top_k(x, k):
        v, i = jtop(x, k)
        jax.debug.callback(lambda a: got["jax"].append(np.asarray(a)), i)
        return v, i

    def port_top_k(x, k):
        v, i = ptop(x, k)
        got["port"].append(i.numpy())
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
    monkeypatch.setattr(PH, "stable_topk", port_top_k)
    return got


def _eval_both(model, variables, jm, x):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False)["preds"])(jv, jnp.asarray(x))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))["preds"]
    return np.asarray(ref), out.numpy()


def test_tiny_eval_preds_and_topk_match_jax(tiny, monkeypatch):
    model, variables, jm = tiny
    got = _topk_recorders(monkeypatch)
    ref, out = _eval_both(model, variables, jm, _images(2, 128, 0))
    assert out.shape == ref.shape == (2, 40, 4 + 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    jax.effects_barrier()
    np.testing.assert_array_equal(got["port"][-1], got["jax"][-1])


def test_topk_ties_among_invalid_anchors_at_448(yamls, monkeypatch):
    """At 448 px P3 is 56 cells wide, so its border anchors are invalid
    (within 1e-2 of the edge) and their tokens zero: all of them have one
    encoder score. Weights that make that score the highest fill the top
    nq with invalid anchors, whose order is then the tie rule alone (lower
    index first, as ``jax.lax.top_k``)."""
    model, _, jm = _pair(yamls["tiny"], seed=3)
    u = torch.from_numpy(np.random.default_rng(1).normal(0, 1, 64).astype(np.float32))
    u -= u.mean()
    with torch.no_grad():
        head = model.model[-1]
        head.enc_output[0].bias.copy_(10 * u)
        head.enc_score_head.weight.zero_()
        head.enc_score_head.weight[0].copy_(u)
        head.enc_score_head.bias.zero_()
    got = _topk_recorders(monkeypatch)
    ref, out = _eval_both(model, state_dict_to_variables(model), jm, _images(1, 448, 2))
    jax.effects_barrier()
    idx = got["port"][-1][0]
    np.testing.assert_array_equal(got["port"][-1], got["jax"][-1])
    _, valid = PH.RTDETRDecoder.generate_anchors([(56, 56), (28, 28), (14, 14)])
    assert (valid[0, idx, 0] == 0).all() and (np.diff(idx) > 0).all() and len(idx) == 40
    assert int((valid[0, :, 0] == 0).sum()) > 40  # more tied candidates than places
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_every_block_in_one_graph_matches_jax(yamls):
    """The HGNetV2/AIFI/RepC3 tiny graph's eval preds (its DWConvs keep
    their activation, so item 33 does not enter)."""
    model, variables, jm = _pair(yamls["hg"], seed=1)
    ref, out = _eval_both(model, variables, jm, _images(2, 128, 4))
    assert out.shape == (2, 30, 7)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_trains_after_an_inference_mode_forward(yamls):
    """The anchors and AIFI's position table are cached per shape; made under
    ``torch.inference_mode`` (predict, val) they would be inference tensors,
    which a later training forward cannot save for the backward."""
    model = _pair(yamls["hg"], seed=4)[0]
    x = torch.from_numpy(_images(2, 64, 5)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        model.eval()(x)
    out = model.train()(x)
    sum(t.sum() for t in out.values()).backward()
    assert all(p.grad is not None for p in model.model[-1].enc_output.parameters())
    assert all(p.grad is not None for p in model.model[8].parameters())  # AIFI


def _train_batch():
    img = np.full((2, 128, 128, 3), 40, np.uint8)
    img[0, 30:70, 20:80] = 200
    img[1, 60:110, 50:100] = 180
    img[1, 10:40, 10:30] = 90
    return {"img": img, "cls": np.array([[0, 2], [1, 0]], np.float32),
            "bboxes": np.array([[[0.39, 0.39, 0.47, 0.31], [0, 0, 0, 0]],
                                [[0.58, 0.66, 0.39, 0.39], [0.16, 0.2, 0.16, 0.23]]], np.float32),
            "mask": np.array([[True, False], [True, True]])}


def test_three_train_steps_match_jax(tiny):
    """``make_train_step`` with ``detr_loss`` and the denoising queries
    against the JAX ``make_train_step`` (training BatchNorm, AdamW, float32),
    from the same weights, three steps on one batch with the cdn seeds
    1, 2, 3 as ``YOLO.train`` draws them."""
    model, variables, jm = tiny
    b0 = _train_batch()
    batches = []
    for seed in (1, 2, 3):
        b = dict(b0)
        b.update(PD.make_cdn_group(b["cls"], b["bboxes"], b["mask"], nc=3, nq=40, rng=seed))
        b.pop("num_group")
        batches.append(b)
    opt = dict(optimizer="AdamW", lr0=1e-3, warmup_epochs=0, batch_size=2, nbs=2, epochs=1, steps_per_epoch=3, nc=3)

    cfg = jopt.OptimCfg(**opt)
    tx = jopt.build_optimizer(cfg, variables["params"])
    state = jtrainer.create_train_state(jm, jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jloss = lambda out, batch, c, s: JD.detr_loss(out, batch, JD.DETRLossCfg(nc=3), s)  # noqa: E731
    step = jax.jit(jtrainer.make_train_step(jm, tx, JaxDetectionLossCfg(nc=3), task_loss=jloss))
    ref = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append(float(m["loss"]))

    pmodel = build_model(dict(jm.spec.yaml_dict), device="cpu")[0]
    pmodel.load_state_dict(model.state_dict())
    popt_ = popt.Optimizer(popt.OptimCfg(**opt), pmodel)
    pstate = ptrainer.create_train_state(pmodel, popt_)
    ploss = lambda out, batch, c, s: PD.detr_loss(out, batch, PD.DETRLossCfg(nc=3), s)  # noqa: E731
    dn_kw = lambda batch: {"dn": {k: batch[k] for k in ("dn_cls", "dn_bbox", "dn_attn_mask")}}  # noqa: E731
    pstep = ptrainer.make_train_step(pmodel, popt_, DetectionLossCfg(nc=3), task_loss=ploss, model_kwargs=dn_kw)
    out = []
    for b in batches:
        pstate, m = pstep(pstate, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append(float(m["loss"]))
        assert m["match_host_s"] >= 0
    assert np.isfinite(ref).all() and ref[0] != ref[2]
    for a, r in zip(out, ref):
        assert abs(a - r) <= 1e-4 * abs(r), (out, ref)


def test_rtdetr_validator_refuses_an_artifact():
    """No RT-DETR artifact exists (``YOLO.export`` refuses one), so the
    validator takes no ``infer_fn``."""
    with pytest.raises(NotImplementedError, match="item 12.1"):
        RTDETRValidator(None, {0: "a"}, infer_fn=lambda x: x)


@pytest.fixture(scope="module")
def facades(yamls, tiny):
    """The JAX facade and the port's on the tiny model's weights."""
    model, variables, _ = tiny
    jy = JaxYOLO(yamls["tiny"], nc=3)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    port = YOLO(yamls["tiny"], device="cpu", nc=3)
    port.model.load_state_dict(model.state_dict())
    return jy, port


def test_predict_matches_jax_facade(facades):
    """No NMS: each query's best class, in descending score (stable), valid
    above ``conf``; ``classes`` filters after, as for the other heads."""
    jy, port = facades
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]
    conf = float(np.median(np.concatenate([r.boxes.conf for r in port.predict(imgs, imgsz=128, conf=0.0)])))
    ref = jy.predict(imgs, imgsz=128, batch=2, conf=conf)
    out = port.predict(imgs, imgsz=128, batch=2, conf=conf)
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        assert o.orig_shape == r.orig_shape and 0 < len(o) == len(r) < 40
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
        assert (np.diff(o.boxes.conf) <= 0).all()
    few = port.predict(imgs, imgsz=128, batch=2, conf=conf, max_det=3, classes=[1])
    for f, o in zip(few, out):
        np.testing.assert_array_equal(f.boxes.data, o.boxes.data[:3][o.boxes.cls[:3] == 1])


@pytest.fixture(scope="module")
def png_rtdetr_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_rtdetr"))


def test_val_matches_jax_rtdetr_validator(facades, png_rtdetr_dataset):
    jy, port = facades
    ref = jy.val(data=png_rtdetr_dataset, imgsz=128, batch=2, verbose=False)
    res = port.val(data=png_rtdetr_dataset, imgsz=128, batch=2, workers=1, verbose=False)
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"):
        assert abs(res[k] - ref[k]) <= 1e-4, (k, res[k], ref[k])
    assert len(res["metrics"].stats["conf"]) == len(ref["metrics"].stats["conf"]) > 0
    for a, b in zip(res["metrics"].stats["pred_cls"], ref["metrics"].stats["pred_cls"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res["confusion_matrix"].matrix, ref["confusion_matrix"].matrix)


def test_pt_in_ultralytics_layout_reads_the_same_in_both(yamls, tmp_path):
    """A ``.pt`` with Ultralytics' keys (``decoder.layers.N``,
    ``ma.out_proj``, ``input_proj.0.1``, ``denoising_class_embed.weight``, the
    MLPs' ``layers.N``; BatchNorm's ``num_batches_tracked`` too), written
    here: the port's strict reader and the JAX reader give the same weights."""
    model, _, jm = _pair(yamls["hg"], seed=2)
    sd = model.state_dict()
    for k in ("model.8.ma.in_proj_weight", "model.8.ma.out_proj.weight", "model.17.decoder.layers.1.cross_attn."
              "sampling_offsets.weight", "model.17.input_proj.0.1.num_batches_tracked",
              "model.17.denoising_class_embed.weight", "model.17.dec_bbox_head.1.layers.2.bias",
              "model.17.enc_output.1.weight", "model.0.stem2a.conv.weight", "model.5.m.1.conv2.bn.running_var"):
        assert k in sd, k
    path = tmp_path / "rtdetr-hg-tiny.pt"
    torch.save({"model": {k: v.clone() for k, v in sd.items()}}, path)
    port = build_model(yamls["hg"], device="cpu")[0]
    import_torch_state_dict(load_pt_state_dict(str(path)), port)
    ours = state_dict_to_variables(port)
    theirs = jax_pt_to_variables(jax_load_pt(str(path)))
    a, b = ({jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
            for t in (ours, theirs))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_rtdetr_facade_info_and_cli_on_rtdetr_l(monkeypatch, tmp_path):
    """``RTDETR()`` builds rtdetr-l (32,970,476 parameters: the count of the
    JAX init's shapes, which ``test_torch_transformer.py`` holds leaf by
    leaf) and refuses a non-RT-DETR YAML; the CLI builds
    ``model=rtdetr-l.yaml`` and hands predict, val and train to the facade
    (recorded, not run, and the weights not drawn: no full-width work
    here); export, track and embed are refused (not ported yet)."""
    import fce_yolo_tpu_torch
    from fce_yolo_tpu_torch.cfg import entrypoint

    m = RTDETR(device="cpu")
    assert isinstance(m, YOLO) and fce_yolo_tpu_torch.RTDETR is RTDETR and m.task == "rtdetr"
    info = m.info()
    assert info["params"] == 32970476 and info["strides"] == (8, 16, 32) and info["yaml"] == "rtdetr-l.yaml"
    with pytest.raises(ValueError, match="not an RT-DETR"):
        RTDETR("yolo11n.yaml", device="cpu")
    for call in (m.export, lambda: m.track(np.zeros((64, 64, 3), np.uint8)), lambda: m.embed([])):
        with pytest.raises(NotImplementedError, match="12.1"):
            call()

    calls = []
    monkeypatch.setattr(YOLO, "reset_weights", lambda self, seed=0: self)
    for mode in ("predict", "val", "train"):
        monkeypatch.setattr(YOLO, mode, lambda self, *a, _m=mode, **kw: calls.append(
            (_m, self.task, self.info()["params"], str(self.device))) or {})
    src = tmp_path / "a.png"
    src.write_bytes(b"")
    entrypoint(["predict", "model=rtdetr-l.yaml", f"source={src}", "device=cpu", f"project={tmp_path}"])
    entrypoint(["val", "model=rtdetr-l.yaml", "data=coco8.yaml", "device=cpu"])
    entrypoint(["train", "model=rtdetr-l.yaml", "data=coco8.yaml", "epochs=1", "device=cpu",
                f"project={tmp_path}"])
    assert calls == [(k, "rtdetr", 32970476, "cpu") for k in ("predict", "val", "train")]


def test_cli_predicts_and_trains_a_tiny_rtdetr(yamls, png_rtdetr_dataset, tmp_path):
    """The CLI end to end on the tiny RT-DETR (64 px): predict gives rows of
    six, train runs an epoch with the denoising groups and records the
    matching's host time."""
    from fce_yolo_tpu_torch.cfg import entrypoint

    images = Path(png_rtdetr_dataset).parent / "images" / "val"
    res = entrypoint(["predict", f"model={yamls['tiny']}", f"source={images}", "imgsz=64", "conf=0.0",
                      "device=cpu", "verbose=False", f"project={tmp_path}"])
    assert len(res) == 4 and all(r.boxes.data.shape == (40, 6) for r in res)
    out = entrypoint(["train", f"model={yamls['tiny']}", f"data={png_rtdetr_dataset}", "epochs=1", "batch=4",
                      "imgsz=64", "workers=1", "device=cpu", "plots=False", f"project={tmp_path}", "verbose=False"])
    assert out["epochs_run"] == 1 and np.isfinite(out["results"][0]["train/cls_loss"])
    assert out["speed"][0]["match_host_ms"] > 0
