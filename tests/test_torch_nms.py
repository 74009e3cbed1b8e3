"""Port NMS (ops/nms.py) vs the JAX package. Integer outputs must match
exactly: keep-set, emit order and the ok mask of the plain greedy NMS
against both the JAX scan (_pick_suppress) and the Pallas kernel in
interpret mode; batched_nms outputs against JAX batched_nms(impl="scan")."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.ops.nms import _pick_suppress
from fce_yolo_tpu.ops.nms import batched_nms as jax_batched_nms
from fce_yolo_tpu.ops.pallas_nms import pallas_pick_suppress
from fce_yolo_tpu_torch.ops.nms import _topk, batched_nms, pick_suppress, pick_suppress_reference

torch.set_num_threads(1)


def _candidates(rng, b=2, k=256):
    """tests/test_pallas_nms.py's generator."""
    centers = rng.uniform(50, 500, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, scores, scores > 0.3


def _ties(rng, b=2, k=256):
    """Duplicate boxes with equal scores, and unsorted scores full of ties."""
    boxes, scores, _ = _candidates(rng, b, k)
    boxes[:, 1::2] = boxes[:, 0:k - 1:2]  # each odd slot copies its even neighbour
    scores = np.round(rng.rand(b, k) * 8).astype(np.float32) / 8
    return boxes, scores, scores > 0.2


def _no_valid(rng, b=1, k=128):
    return np.zeros((b, k, 4), np.float32), np.zeros((b, k), np.float32), np.zeros((b, k), bool)


CASES = {"random": _candidates, "ties": _ties, "no_valid": _no_valid}


@pytest.mark.parametrize("iou", [0.45, 0.7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pick_suppress_matches_jax(case, iou):
    boxes, scores, valid = CASES[case](np.random.RandomState(0))
    max_det = 64
    idx, ok = pick_suppress(*(torch.from_numpy(a) for a in (boxes, scores, valid)), iou_thres=iou, max_det=max_det)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool and idx.shape == (boxes.shape[0], max_det)
    jb, js, jv = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)
    idx_s, ok_s = jax.vmap(partial(_pick_suppress, iou_thres=iou, max_det=max_det))(jb, js, jv)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_s))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_s))
    idx_p, ok_p = pallas_pick_suppress(jb, js, jv, iou_thres=iou, max_det=max_det, interpret=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_p))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_p))


def test_exhausted_rows_give_zero_idx():
    """After a row runs out of live candidates idx = 0 and ok = False, also
    while other rows of the batch go on."""
    boxes, scores, valid = _candidates(np.random.RandomState(1), b=2, k=64)
    valid[0, 3:] = False
    idx, ok = pick_suppress_reference(*(torch.from_numpy(a) for a in (boxes, scores, valid)), 0.45, 40)
    assert ok[0, :3].all() and not ok[0, 3:].any() and (idx[0, 3:] == 0).all()
    assert ok[1].sum() > 3


def test_topk_tie_order_matches_lax():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5], [1, 1, 1, 1, 1, 1]], np.float32)
    vals, idx = _topk(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _preds(rng, b=2, n=400, nc=3, extra=0):
    p = rng.rand(b, n, 4 + nc + extra).astype(np.float32)
    p[..., :2] = p[..., :2] * 400 + 100  # cx, cy
    p[..., 2:4] = p[..., 2:4] * 60 + 20  # w, h
    return p


@pytest.mark.parametrize("multi_label,agnostic", [(True, False), (False, False), (True, True), (False, True)])
def test_batched_nms_matches_jax(multi_label, agnostic):
    p = _preds(np.random.RandomState(1))
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=48, pre_nms_topk=256,
              multi_label=multi_label, agnostic=agnostic)
    ref = jax_batched_nms(jnp.asarray(p), impl="scan", **kw)
    out = batched_nms(torch.from_numpy(p), **kw)
    assert out["valid"].any()
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    for key in ("boxes", "scores"):  # the same gathered f32 values
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


def test_batched_nms_extra_gather_matches_jax():
    """Per-anchor extras (mask coefficients, keypoints) follow each kept box."""
    p = _preds(np.random.RandomState(2), nc=4, extra=5)
    kw = dict(conf_thres=0.3, iou_thres=0.45, max_det=32, multi_label=False, nc=4)
    ref = jax_batched_nms(jnp.asarray(p), impl="scan", **kw)
    out = batched_nms(torch.from_numpy(p), **kw)
    np.testing.assert_array_equal(out["extra"].numpy(), np.asarray(ref["extra"]))
    np.testing.assert_array_equal(out["classes"].numpy(), np.asarray(ref["classes"]))


def test_pick_suppress_rejects_bad_inputs():
    boxes, scores, valid = (torch.from_numpy(a) for a in _candidates(np.random.RandomState(0), k=16))
    with pytest.raises(TypeError):
        pick_suppress(boxes.double(), scores, valid)
    with pytest.raises(TypeError):
        pick_suppress(boxes, scores, valid.float())
    with pytest.raises(ValueError):
        pick_suppress(boxes[..., :3], scores, valid)
    with pytest.raises(ValueError):
        pick_suppress(boxes, scores[:, :8], valid)
