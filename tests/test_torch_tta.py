"""Test-time augmentation and ensembles in the port (``nn/tta.py``) against
the JAX package's (``fce_yolo_tpu/nn/tta.py:24-104``): ``scale_img`` against
``jax.image.resize``'s antialiased bilinear, ``predict_augment`` (three
scales, the flip, the de-scaling and the tails clipped) and
``ensemble_predict`` on the same weights, the merged candidates through
``batched_nms``, and the 15,049 rows of a 640 px image.

Tolerance: resized pixels within 1e-5 absolute (values in [0, 1]; the two
resizers sum the same taps in another order, up to 5e-6 apart at 640 px);
predictions within 1e-5 * max|jax| (``test_torch_modules.py``); NMS: counts
and classes equal, boxes within 1e-3 px, scores within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fce_yolo_tpu.nn import tta as jtta
from fce_yolo_tpu.ops.nms import batched_nms as jax_batched_nms
from fce_yolo_tpu_torch.nn import tta as ptta
from fce_yolo_tpu_torch.nn.model import build_model
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.ops.nms import batched_nms
from test_torch_families_models import bridged
from test_torch_modules import _close

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape,ratio", [((2, 64, 64, 3), 0.83), ((2, 64, 64, 3), 0.67), ((1, 160, 128, 3), 0.83),
                                         ((1, 97, 131, 3), 0.67), ((1, 640, 640, 3), 0.67), ((1, 64, 96, 3), 1.0)])
def test_scale_img_matches_jax(shape, ratio):
    """Sizes int(H * ratio), padded to multiples of 32 with 0.447, pixels
    equal to the JAX resize's. Ultralytics' ``scale_img`` resizes without
    antialiasing, which misses them by over 0.1 (ROADMAP queue 3, item 27);
    the port follows JAX."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ref = np.asarray(jtta.scale_img(jnp.asarray(x), ratio))
    out = ptta.scale_img(_nchw(x), ratio).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape and out.shape[1] % 32 == 0 and out.shape[2] % 32 == 0
    assert np.abs(out - ref).max() <= 1e-5
    if ratio != 1.0:
        nh, nw = int(shape[1] * ratio), int(shape[2] * ratio)
        assert (out[:, nh:] == np.float32(0.447)).all() and (out[:, :, nw:] == np.float32(0.447)).all()
        plain = F.interpolate(_nchw(x), size=(nh, nw), mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref[:, :nh, :nw]).max() > 0.1


@pytest.fixture(scope="module")
def v8n():
    """yolov8n on bridged weights (JAX model, flax variables, port model)."""
    return bridged("yolov8n")


def test_predict_augment_matches_jax(v8n):
    """Three passes at 64 x 96 px (the second flipped): the merged
    (B, N, 4 + nc) candidates equal JAX's, and so does ``batched_nms`` of
    them (predict's single-label settings)."""
    jmodel, v, model = v8n
    x = np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jtta.predict_augment(jmodel, v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        out = ptta.predict_augment(model.eval(), _nchw(x))
    full = (64 // 8) * (96 // 8) + (64 // 16) * (96 // 16) + (64 // 32) * (96 // 32)
    assert out.shape == ref.shape and out.shape[1] < 3 * full
    _close(ref, out)
    conf = float(np.quantile(np.asarray(ref)[..., 4:].max(-1), 0.9))  # the top tenth of the candidates
    kw = dict(conf_thres=conf, iou_thres=0.7, max_det=300, multi_label=False)
    jn = jax.device_get(jax_batched_nms(ref, **kw))
    pn = {k: t.numpy() for k, t in batched_nms(out, **kw).items()}
    assert pn["valid"].sum() > 0
    np.testing.assert_array_equal(pn["valid"], jn["valid"])
    np.testing.assert_array_equal(pn["classes"][pn["valid"]], jn["classes"][jn["valid"]])
    np.testing.assert_allclose(pn["boxes"][pn["valid"]], jn["boxes"][jn["valid"]], rtol=0, atol=1e-3)
    np.testing.assert_allclose(pn["scores"][pn["valid"]], jn["scores"][jn["valid"]], rtol=0, atol=1e-5)


def test_ensemble_predict_matches_jax(v8n):
    """Two yolov8n members (the second's weights scaled by 1.01) concatenated
    on the anchor axis, equal to JAX's; members of other widths raise."""
    jmodel, v, model = v8n
    model2 = copy.deepcopy(model)
    with torch.no_grad():
        for p in model2.parameters():
            p.mul_(1.01)
    v2 = state_dict_to_variables(model2)
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, v2, x: jtta.ensemble_predict([(jmodel, v), (jmodel, v2)], x))(v, v2, jnp.asarray(x))
    with torch.no_grad():
        out = ptta.ensemble_predict([model.eval(), model2.eval()], _nchw(x))
    assert out.shape == (1, 2 * (64 + 16 + 4), 84)
    _close(ref, out)
    seg, _, _ = build_model("yolov8n-seg.yaml", device="cpu")
    with pytest.raises(ValueError, match="width"):
        ptta.ensemble_predict([model.eval(), seg.eval()], _nchw(x))


def test_predict_augment_rows_at_640():
    """At 640 px the merged tensor has 8000 + 6069 + 980 = 15049 rows:
    8400 anchors less the P5 400 at full scale, 544 px's 68^2 + 34^2 + 17^2,
    448 px's 4116 less its P3 3136."""
    model, _, _ = build_model("yolov8n.yaml", device="cpu")
    with torch.no_grad():
        out = ptta.predict_augment(model.eval(), torch.rand(1, 3, 640, 640))
    assert out.shape == (1, 8000 + 6069 + 980, 84) == (1, 15049, 84)
