"""The task heads (Segment, Pose, OBB and the mask prototypes) and their
ops against the JAX package in float32 on the same bridged weights and
inputs.

Tolerances: head outputs within 1e-5 * max|jax| (f32 on both sides,
summation order only, as ``test_torch_modules.py``); ``dist2rbox`` and
``probiou`` within 1e-6 absolute; rotated NMS keep-set, order and classes
exact, boxes and angles bit-equal (the same candidates are gathered);
``process_mask`` bit-equal except pixels whose JAX sigmoid lies within 1e-5
of 0.5 (the coefficient x prototype sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import heads as JH
from fce_yolo_tpu.ops import anchors as janchors
from fce_yolo_tpu.ops import iou as jiou
from fce_yolo_tpu.ops import masks as jmasks
from fce_yolo_tpu.ops import nms as jnms
from fce_yolo_tpu_torch.nn import heads as PH
from fce_yolo_tpu_torch.nn.weights import variables_to_state_dict
from fce_yolo_tpu_torch.ops import anchors as panchors
from fce_yolo_tpu_torch.ops import iou as piou
from fce_yolo_tpu_torch.ops import masks as pmasks
from fce_yolo_tpu_torch.ops import nms as pnms
from test_torch_modules import _close, _nchw_to_nhwc, _pair, _x

torch.set_num_threads(1)

CH, STRIDES = (16, 32, 64), (8, 16, 32)
LEVELS = [(2, 8, 6, 16), (2, 4, 3, 32), (2, 2, 2, 64)]


def _levels():
    return [_x(s, i + 1) for i, s in enumerate(LEVELS)]


@pytest.mark.parametrize("nm,npr", [(8, 16), (32, 24)])
def test_segment_matches_flax(nm, npr):
    """preds (B, A, 4 + nc + nm) and the prototypes (NCHW here, NHWC in JAX)."""
    jmod = JH.Segment(nc=3, ch=CH, nm=nm, npr=npr, strides=STRIDES)
    pmod = PH.Segment(nc=3, nm=nm, npr=npr, ch=CH, strides=STRIDES)
    ref, out = _pair(jmod, pmod, _levels())
    assert out["preds"].dtype == torch.float32 and out["preds"].shape == (2, 8 * 6 + 4 * 3 + 4, 4 + 3 + nm)
    _close(ref["preds"], out["preds"])
    _close(ref["proto"], _nchw_to_nhwc(out["proto"]))
    for rf, of in zip(ref["feats"], out["feats"]):
        _close(rf, _nchw_to_nhwc(of))


@pytest.mark.parametrize("kpt_shape", [(17, 3), (4, 2)])
def test_pose_matches_flax(kpt_shape):
    """Decoded keypoints ((raw * 2 + anchor - 0.5) * stride, visibility sigmoid)."""
    jmod = JH.Pose(nc=2, ch=CH, kpt_shape=kpt_shape, strides=STRIDES)
    pmod = PH.Pose(nc=2, kpt_shape=kpt_shape, ch=CH, strides=STRIDES)
    ref, out = _pair(jmod, pmod, _levels())
    _close(ref["preds"], out["preds"])
    _close(ref["kpts"], out["kpts"])


def test_obb_matches_flax():
    """Rotated (cx, cy, w, h) from dist2rbox, class scores and the angle."""
    jmod = JH.OBB(nc=4, ch=CH, ne=1, strides=STRIDES)
    pmod = PH.OBB(nc=4, ne=1, ch=CH, strides=STRIDES)
    ref, out = _pair(jmod, pmod, _levels())
    _close(ref["preds"], out["preds"])
    _close(ref["angle"], out["angle"])
    assert float(out["angle"].min()) >= -np.pi / 4 and float(out["angle"].max()) <= 3 * np.pi / 4


def test_heads_train_mode_keys():
    """Training mode returns the JAX package's keys, for the training slice to attach to."""
    xs = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in _levels()]
    for head, keys in ((PH.Segment(3, 8, 16, CH, STRIDES), {"feats", "mask_coefs", "proto"}),
                       (PH.Pose(3, (17, 3), CH, STRIDES), {"feats", "kpts"}),
                       (PH.OBB(3, 1, CH, STRIDES), {"feats", "angle"})):
        out = head.train()(xs)
        assert set(out) == keys


def test_proto_upsample_needs_the_spatial_flip():
    """flax's ConvTranspose (transpose_kernel=False) applies its kernel
    unflipped to the dilated input, torch's ConvTranspose2d flipped: the
    bridge flips both spatial axes. Without the flip the shapes still agree
    (c_ in, c_ out) and the values do not."""
    jmod = JH.Proto(c_=8, c2=4)
    pmod = PH.Proto(6, 8, 4)
    x = _x((2, 5, 7, 6), 3)
    ref, out = _pair(jmod, pmod, [x])
    _close(ref, _nchw_to_nhwc(out))
    w = pmod.upsample.weight
    with torch.no_grad():
        w.copy_(w.flip(2, 3))  # what a bridge without the flip would load
        unflipped = pmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    err = float(np.abs(np.asarray(ref) - _nchw_to_nhwc(unflipped).numpy()).max())
    assert err > 0.1 * float(np.abs(np.asarray(ref)).max())


def test_convtranspose_bridge_on_one_kernel():
    """The 2x2 stride-2 case worked by hand: kernel [[1, 10], [100, 1000]]
    on [[1, 2], [3, 4]] gives flax's 2x2 cells rotated by 180 degrees from
    torch's on the same numbers; through the bridge both agree."""
    k = np.array([[1, 10], [100, 1000]], np.float32).reshape(2, 2, 1, 1)
    v = {"params": {"layers_0": {"proto": {"upsample": {"kernel": k, "bias": np.zeros(1, np.float32)}}}}}
    sd = variables_to_state_dict(v)
    conv = torch.nn.ConvTranspose2d(1, 1, 2, 2)
    conv.load_state_dict({"weight": sd["model.0.proto.upsample.weight"], "bias": sd["model.0.proto.upsample.bias"]})
    x = np.array([[1, 2], [3, 4]], np.float32)
    ref = jax.lax.conv_transpose(jnp.asarray(x)[None, :, :, None], jnp.asarray(k), (2, 2), "VALID",
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))[0, :, :, 0]
    np.testing.assert_array_equal(np.asarray(ref)[:2, :2], [[1000, 100], [10, 1]])
    with torch.no_grad():
        out = conv(torch.from_numpy(x)[None, None])[0, 0].numpy()
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_dist2rbox_matches_jax():
    rng = np.random.RandomState(0)
    dist = rng.uniform(0, 8, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-0.8, 2.4, (2, 50, 1)).astype(np.float32)
    anchors = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    ref = np.asarray(janchors.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anchors)[None]))
    out = panchors.dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang), torch.from_numpy(anchors)[None])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def _rboxes(rng, n, lo=0.0, hi=100.0):
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(2, 40, (n, 2)),
                           rng.uniform(-0.8, 2.4, (n, 1))], 1).astype(np.float32)


def test_probiou_matches_jax():
    rng = np.random.RandomState(1)
    a, b = _rboxes(rng, 40), _rboxes(rng, 30)
    b[:5] = a[:5]  # identical pairs
    b[5:8, 2:4] = b[5:8, 3:1:-1]  # swapped sides
    ref = np.asarray(jiou.probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
    out = piou.probiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (np.diag(out[:5, :5]) > 0.99).all()


@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("max_det", [300, 2000])
def test_rotated_batched_nms_matches_jax(multi_label, max_det):
    """Dense overlapping boxes (so probiou suppresses), 3 classes, the angle
    and one more extra channel carried; max_det 2000 > K pads with empty rows."""
    rng = np.random.RandomState(2)
    b, n, nc = 2, 300, 3
    pred = np.concatenate([_rboxes(rng, b * n, 0, 60).reshape(b, n, 5)[..., :4], rng.uniform(0, 1, (b, n, nc)),
                           rng.uniform(-0.8, 2.4, (b, n, 1)), rng.normal(0, 1, (b, n, 1))], -1).astype(np.float32)
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=max_det, nc=nc, multi_label=multi_label)
    ref = jnms.rotated_batched_nms(jnp.asarray(pred), **kw)
    out = pnms.rotated_batched_nms(torch.from_numpy(pred), **kw)
    assert 0 < int(out["valid"].sum()) < int((pred[..., 4:4 + nc].max(-1) > 0.25).sum()) * (nc if multi_label else 1)
    for k in ("valid", "classes", "boxes", "scores", "extra"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("upsample", [True, False])
def test_process_mask_matches_jax(upsample):
    """Prototype combination, crop and (bilinear, align_corners=False) upsample."""
    rng = np.random.RandomState(3)
    coefs = rng.normal(0, 1, (12, 32)).astype(np.float32)
    proto = rng.normal(0, 1, (16, 24, 32)).astype(np.float32)
    xy = rng.uniform(0, 60, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 50, (12, 2))], 1).astype(np.float32)
    ref = np.asarray(jmasks.process_mask(jnp.asarray(coefs), jnp.asarray(proto), jnp.asarray(boxes), (64, 96),
                                         upsample=upsample))
    out = pmasks.process_mask(torch.from_numpy(coefs), torch.from_numpy(proto).permute(2, 0, 1),
                              torch.from_numpy(boxes), (64, 96), upsample=upsample).numpy()
    assert out.shape == ref.shape and out.dtype == bool and 0 < ref.sum() < ref.size
    # the JAX side's mask probability before the threshold: where it sits at 0.5 within rounding
    m = jax.nn.sigmoid(jnp.einsum("nk,hwk->nhw", coefs, proto))
    scale = jnp.asarray([24 / 96, 16 / 64, 24 / 96, 16 / 64], jnp.float32)
    m = jmasks.crop_mask(m, jnp.asarray(boxes) * scale)
    if upsample:
        m = jax.image.resize(m, (12, 64, 96), method="bilinear")
    near = np.abs(np.asarray(m) - 0.5) <= 1e-5
    assert ((out != ref) <= near).all()


def test_interpolate_is_jax_resize_for_an_upsample():
    """F.interpolate(bilinear, align_corners=False) against jax.image.resize
    on the upsample ``process_mask`` does (x4, and a non-integer factor)."""
    x = np.random.RandomState(4).uniform(0, 1, (3, 10, 14)).astype(np.float32)
    for size in ((40, 56), (23, 31)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, *size), method="bilinear"))
        out = torch.nn.functional.interpolate(torch.from_numpy(x)[:, None], size=size, mode="bilinear",
                                              align_corners=False)[:, 0].numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_scale_masks_matches_jax():
    """Padding stripped, then cv2's INTER_LINEAR in numpy (the JAX side calls cv2.resize)."""
    rng = np.random.RandomState(5)
    masks = rng.uniform(0, 1, (4, 64, 96)) > 0.6
    for orig, ratio, pad in (((100, 140), 96 / 140, (0.0, 9.0)), ((64, 90), 1.0, (3.0, 0.0)),
                             ((61, 96), 1.0, (0.0, 1.5))):
        ref = jmasks.scale_masks_np(masks, orig, ratio, pad)
        np.testing.assert_array_equal(pmasks.scale_masks_np(masks, orig, ratio, pad), ref)


@pytest.mark.parametrize("name", ["yolo11-seg", "yolo11-pose", "yolo11-obb"])
def test_task_models_build_probe_and_init_like_jax(name):
    """The stem kernel's gate takes the model at s; the meta-device stride
    probe and ``estimate_flops`` pass through the heads (the ConvTranspose,
    the dict outputs); the Detect bias prior lands
    on the head's trunk only, as ``init_variables`` puts it; ``fold_conv_bn``
    leaves the ConvTranspose and the bare 1x1 convs as they are."""
    from test_torch_modules import jax_detection_model
    from fce_yolo_tpu.nn.model import init_variables
    from fce_yolo_tpu_torch.nn.model import build_model, estimate_flops, fold_conv_bn, init_weights

    from fce_yolo_tpu_torch.cfg.models import MODELS
    from fce_yolo_tpu_torch.nn.parser import parse_model_yaml
    from fce_yolo_tpu_torch.ops.stem import stem_spec_from_model

    # layers 0-2 are yolo11's: at s the stem kernel takes them as it takes yolo11's
    stem = stem_spec_from_model(parse_model_yaml(MODELS[name], scale="s"), (640, 640))
    assert stem is not None and stem == stem_spec_from_model(parse_model_yaml(MODELS["yolo11"], scale="s"), (640, 640))
    model, spec, strides = build_model(f"{name}.yaml", scale="n", device="cpu")
    detect, _, _ = build_model("yolo11.yaml", scale="n", device="meta")
    assert strides == (8, 16, 32) and spec.task == model.task == name.split("-")[1].replace("seg", "segment")
    assert estimate_flops(model, imgsz=128) > estimate_flops(detect, imgsz=128)
    init_weights(model, torch.Generator().manual_seed(0))
    jm, _, _ = jax_detection_model(f"fce_yolo_tpu/cfg/models/{name}.yaml", scale="n")
    v = jax.jit(lambda k: init_variables(jm, k, imgsz=64))(jax.random.PRNGKey(0))["params"]["layers_23"]
    head = model.detect
    for i in range(3):
        np.testing.assert_allclose(head.cv2[i][-1].bias.detach().numpy(), v["detect"][f"cv2_{i}_2"]["conv2d"]["bias"])
        np.testing.assert_allclose(head.cv3[i][-1].bias.detach().numpy(), v["detect"][f"cv3_{i}_2"]["conv2d"]["bias"],
                                   rtol=1e-6)
        assert not head.cv4[i][-1].bias.any() and not np.asarray(v[f"cv4_{i}_2"]["conv2d"]["bias"]).any()
    before = {k: t.clone() for k, t in model.state_dict().items() if ".cv4." in k and k.endswith(".2.weight")}
    if name == "yolo11-seg":
        before["model.23.proto.upsample.weight"] = head.proto.upsample.weight.detach().clone()
    fold_conv_bn(model)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], t) for k, t in before.items())
