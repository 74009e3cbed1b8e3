"""``YOLO.export(format="torch_export")`` (``engine/exporter.py``) and the
port's ``AutoBackend`` (``nn/autobackend.py``) on the CPU, against the JAX
package on the same weights (the port's seeded weights carried to flax by
``nn/weights.py::state_dict_to_variables``):

- a ``.pt2`` reads back through ``AutoBackend`` (static batch: chunked,
  padded and trimmed), its preds within 1e-4 of max|ref| of the JAX eager
  forward, on uint8 and on [0, 1] input alike;
- with NMS inside it (the custom op), its dict against the JAX
  ``batched_nms`` of the JAX preds: classes and ``valid`` equal, boxes and
  scores within 1e-4 (a noise image: no exact ties);
- the sidecar carries the JAX exporter's keys; the JAX-only formats, int8
  and a v10 head raise;
- ``YOLO(artifact).predict`` and ``.val`` equal those of the model that
  was exported: the same classes, the rows within 1e-5 (``.pt2``: the same
  ATen ops, another memory layout) or 1e-3 (``.fyir``: the C++
  interpreter), the metrics within 1e-6;
- fault 31 (ROADMAP queue 3): the JAX ``AutoBackend`` writes a uint8 batch's
  0-255 values to the ``.fyir`` graph, which takes [0, 1]; the port divides
  by 255. On the same artifact and image the port's backend is within 2e-3
  of the eager preds and the JAX one more than 1 away;
- the command line's ``export`` mode and ``ProfileModels`` on artifacts.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fce_yolo_tpu.nn.autobackend as jax_autobackend
import fce_yolo_tpu.nn.model as jax_model
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.ops import batched_nms as jax_batched_nms
from fce_yolo_tpu_torch.api import YOLO
from fce_yolo_tpu_torch.cfg import entrypoint
from fce_yolo_tpu_torch.nn.autobackend import AutoBackend, fy_infer_binary
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.utils.benchmarks import ProfileModels
from test_torch_data import png_copy

IMGSZ = 64
JAX_META_KEYS = ["model", "imgsz", "batch", "nc", "names", "strides", "nms", "layout", "input", "params"]


def noise(n: int, seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, IMGSZ, IMGSZ, 3), np.uint8)


def spread_head(yolo, img_rgb: np.ndarray, scale: float = 0.5) -> None:
    """Class convs whose logits spread on ``img_rgb``: each class a whitened
    random projection of its conv's input over the image's anchors. With
    seed-0 weights every anchor scores within ~1e-5 of the others, and two
    float paths then keep different boxes."""
    head = yolo.model.detect
    feats = []
    hooks = [b[-1].register_forward_hook(lambda m, i, o: feats.append(i[0].detach())) for b in head.cv3]
    with torch.no_grad():
        yolo.model.eval()(torch.from_numpy(img_rgb).permute(2, 0, 1)[None].float() / 255.0)
        for h in hooks:
            h.remove()
        gen = torch.Generator().manual_seed(0)
        for branch, f in zip(head.cv3, feats):
            conv, c = branch[-1], f.shape[1]
            mu, sd = f.mean((0, 2, 3)), f.std((0, 2, 3)) + 1e-12
            w = torch.randn(conv.out_channels, c, generator=gen) * scale / c ** 0.5 / sd
            conv.weight.copy_(w[:, :, None, None])
            conv.bias.copy_(-(w * mu).sum(1))


@pytest.fixture(scope="module")
def pair():
    """(port facade, JAX facade) of yolo11n with 3 classes on the same
    weights: seed 0, the class convs spread on a noise image."""
    yolo = YOLO("yolo11n.yaml", device="cpu", nc=3)
    spread_head(yolo, noise(1)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "resolve_strides", lambda spec: (8, 16, 32))  # no stride probe
        jy = JaxYOLO("yolo11n.yaml", nc=3)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(yolo.model))
    return yolo, jy


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    """The ``.pt2`` of ``pair``'s model at B=2, without and with NMS, and its ``.fyir``."""
    yolo, _ = pair
    root = tmp_path_factory.mktemp("exported")
    return {"raw": yolo.export(format="torch_export", imgsz=IMGSZ, batch=2, out_dir=root / "raw"),
            "nms": yolo.export(format="torch_export", imgsz=IMGSZ, batch=2, nms=True, conf=0.25, iou=0.7,
                               max_det=50, out_dir=root / "nms"),
            "fyir": yolo.export(format="native", imgsz=IMGSZ, out_dir=root / "native")}


def jax_preds(jy, x_u8: np.ndarray) -> np.ndarray:
    f = jax.jit(lambda v, x: jy.model.apply(v, x / 255.0, train=False)["preds"])
    return np.asarray(f(jy.variables, jnp.asarray(x_u8, jnp.float32)))


def test_torch_export_reads_back_and_matches_jax(pair, exported):
    yolo, jy = pair
    meta = json.loads(Path(exported["raw"]).with_suffix(".json").read_text())
    assert list(meta) == JAX_META_KEYS
    assert meta["imgsz"] == IMGSZ and meta["batch"] == 2 and meta["nc"] == 3 and meta["nms"] is False
    assert meta["strides"] == [8, 16, 32] and meta["params"] == yolo.info()["params"]
    b = AutoBackend(exported["raw"], device="cpu")
    assert (b.fmt, b.imgsz, b.batch, b.nc, b.names, b.nms_baked) == ("torch_export", IMGSZ, 2, 3, yolo.names, False)
    x = noise(3)  # one batch and a padded one
    got = b(x)
    ref = jax_preds(jy, x)
    assert isinstance(got, torch.Tensor) and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(b(x.astype(np.float32) / 255.0).numpy(), got.numpy())  # [0, 1] input too


def test_nms_inside_the_program_matches_jax_batched_nms(pair, exported):
    _, jy = pair
    b = AutoBackend(exported["nms"], device="cpu")
    assert b.nms_baked and b.batch == 2
    x = noise(2, seed=11)
    got = b(x)
    ref = {k: np.asarray(v) for k, v in jax_batched_nms(jnp.asarray(jax_preds(jy, x)), conf_thres=0.25,
                                                         iou_thres=0.7, max_det=50).items()}
    assert set(got) == {"boxes", "scores", "classes", "valid"} and got["boxes"].shape == (2, 50, 4)
    assert 0 < int(ref["valid"].sum()) < 100  # some kept, not every slot
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["classes"].numpy(), ref["classes"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"], rtol=0, atol=1e-4)


def test_jax_only_formats_raise(pair, tmp_path):
    yolo, _ = pair
    for fmt, needs in (("stablehlo", "JAX"), ("saved_model", "TensorFlow"), ("tflite", "TensorFlow")):
        with pytest.raises(NotImplementedError, match=f"'{fmt}' needs {needs}.*format='torch_export'"):
            yolo.export(format=fmt, imgsz=IMGSZ, out_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="int8"):
        yolo.export(format="torch_export", imgsz=IMGSZ, int8=True, out_dir=tmp_path)
    with pytest.raises(ValueError, match="unknown export format 'onnx'"):
        yolo.export(format="onnx", imgsz=IMGSZ, out_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="v10 head"):  # the JAX exporters read preds, which it lacks
        YOLO("yolov10n.yaml", device="cpu").export(format="native", imgsz=IMGSZ, out_dir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_artifact_facade_predicts_and_validates_as_the_model(pair, exported, tiny_dataset, tmp_path):
    yolo, _ = pair
    img = np.ascontiguousarray(noise(1, seed=3)[0][:, :, ::-1])
    ref = yolo.predict(img, imgsz=IMGSZ)[0].boxes.data
    assert len(ref) > 0
    pt2, fyir = YOLO(exported["raw"], device="cpu"), YOLO(exported["fyir"], device="cpu")
    assert pt2.task == fyir.task == "detect" and pt2.names == fyir.names == yolo.names and fyir.backend.imgsz == IMGSZ
    for facade, tol in ((pt2, 1e-5), (fyir, 1e-3)):
        got = facade.predict(img)[0].boxes.data
        assert got.shape == ref.shape and np.array_equal(got[:, 5], ref[:, 5])
        np.testing.assert_allclose(got[:, :5], ref[:, :5], rtol=0, atol=tol)
    data = png_copy(tiny_dataset, tmp_path / "png")
    want = yolo.val(data=data, imgsz=IMGSZ, batch=2, workers=1, verbose=False)
    res = pt2.val(data=data, batch=2, workers=1, verbose=False)
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"):
        assert abs(res[k] - want[k]) <= 1e-6, k
    with pytest.raises(NotImplementedError, match="no model to export"):
        pt2.export(format="torch_export")


def test_fyir_backend_scales_uint8_where_the_jax_backend_does_not(pair, exported, monkeypatch, tmp_path):
    """ROADMAP queue 3, item 31, on one artifact and one image: the JAX
    backend (``fce_yolo_tpu/nn/autobackend.py:139-160, 189-190``) runs
    ``fy_infer --raw`` on 0-255 values."""
    yolo, _ = pair
    x = noise(1, seed=5)
    with torch.no_grad():
        eager = yolo._inference_model()(torch.from_numpy(x).permute(0, 3, 1, 2).float() / 255.0)["preds"].numpy()
    ours = AutoBackend(exported["fyir"], device="cpu")(x).numpy()
    # the JAX backend looks for native/infer/fy_infer two levels above its module: point that at a copy
    (tmp_path / "native" / "infer").mkdir(parents=True)
    (tmp_path / "native" / "infer" / "fy_infer").symlink_to(fy_infer_binary())
    monkeypatch.setattr(jax_autobackend, "__file__", str(tmp_path / "fce_yolo_tpu" / "nn" / "autobackend.py"))
    theirs = jax_autobackend.AutoBackend(exported["fyir"])(x)
    np.testing.assert_allclose(ours, eager, rtol=1e-3, atol=2e-3)
    assert np.abs(theirs - eager).max() > 1.0


def test_cli_export_and_profile_models(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    pt2 = entrypoint(["detect", "export", "model=yolo11n.yaml", f"imgsz={IMGSZ}", "format=torch_export", "device=cpu"])
    fyir = entrypoint(["detect", "export", "model=yolo11n.yaml", f"imgsz={IMGSZ}", "format=native", "device=cpu"])
    assert Path(pt2).name == "yolo11n_64.pt2" and Path(fyir).name == "yolo11n_64.fyir"
    assert (tmp_path / "yolo11n_64.json").exists() and (tmp_path / "yolo11n_64.fybin").exists()
    rows = ProfileModels([str(tmp_path)], num_timed_runs=2, num_warmup_runs=1, min_time=0.0, imgsz=IMGSZ,
                         device="cpu").run()
    assert [(r["name"], r["runtime"], r["imgsz"]) for r in rows] == [("yolo11n_64", "torch_export", IMGSZ),
                                                                     ("yolo11n_64", "fyir", IMGSZ)]
    assert all(r["ms/img"] > 0 and r["params(M)"] > 0 for r in rows)
    assert "| yolo11n_64" in capsys.readouterr().out
