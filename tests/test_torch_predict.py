"""The port's YOLO.predict vs the JAX facade on the same bridged f32
weights and images, the JAX-free import path, the letterbox, and the
folded copy predict runs (the facade's own model keeps its BatchNorm).

Tolerance: counts and classes exact; boxes within 1e-3 px and scores within
1e-5 (f32 forward in both, summation order only). Images are non-square and
no larger than imgsz, so the letterbox (scaleup=False) pads without
resizing and both sides see identical pixels.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.data.augment import letterbox as jax_letterbox
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu_torch import YOLO, api
from fce_yolo_tpu_torch.data.augment import letterbox
from fce_yolo_tpu_torch.engine.results import Results
from test_torch_modules import jax_facade

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (120, 128, 3))]


@pytest.mark.parametrize("name", ["yolo11n-fce.yaml", "yolo11s.yaml"])
def test_predict_matches_jax_facade(name):
    # bias_prior=False: scores sit near 0.5, so NMS works through every candidate
    jy, port = jax_facade(name, 1, bias_prior=False)
    imgs = _images()
    ref = jy.predict(imgs, imgsz=128, batch=2)
    out = port.predict(imgs, imgsz=128, batch=2)
    assert len(out) == len(ref) == len(imgs)
    for r, o in zip(ref, out):
        assert o.orig_shape == r.orig_shape
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


def test_import_and_predict_without_jax_cv2_pil(tmp_path):
    """Every port module imports, a model YAML file is read, and a CPU
    predict, a CPU segment predict and a CPU val (on a PNG dataset written
    with zlib) run, with jax, flax, cv2, PIL, yaml and the JAX package blocked."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "fce_yolo_tpu"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(1)  # one thread, as in the test workers
        import importlib, pkgutil, struct, zlib
        from pathlib import Path
        import numpy as np
        import fce_yolo_tpu_torch
        for info in pkgutil.walk_packages(fce_yolo_tpu_torch.__path__, "fce_yolo_tpu_torch."):
            importlib.import_module(info.name)
        from fce_yolo_tpu_torch import YOLO
        from fce_yolo_tpu_torch.cfg.models import MODELS, load_model_dict
        assert load_model_dict("fce_yolo_tpu/cfg/models/yolo11-fce.yaml") == (MODELS["yolo11-fce"], None)
        img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
        res = YOLO("yolo11n-fce.yaml", device="cpu").predict([img, img], imgsz=64, batch=2)
        assert len(res) == 2 and res[0].boxes.data.shape[1] == 6
        seg = YOLO("yolo11n-seg.yaml", device="cpu").predict(img, imgsz=64, conf=0.0)[0]
        assert len(seg) > 0 and seg.masks.data.shape == (len(seg), 48, 64)

        root = Path(sys.argv[1])
        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
        for i, (h, w) in enumerate([(40, 56), (64, 48), (52, 52)]):
            rgb = np.full((h, w, 3), 60, np.uint8)
            rgb[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = (255, 80, 80)
            raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1).tobytes()
            (root / "images" / "val").mkdir(parents=True, exist_ok=True)
            (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
            (root / "images" / "val" / f"{i}.png").write_bytes(
                b"\\x89PNG\\r\\n\\x1a\\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
            (root / "labels" / "val" / f"{i}.txt").write_text("1 0.5 0.5 0.5 0.5\\n")
        (root / "data.yaml").write_text(f"path: {root}\\nval: images/val\\nnames:\\n  0: a\\n  1: b\\n")
        out = YOLO("yolo11n-fce.yaml", device="cpu").val(data=str(root / "data.yaml"), imgsz=64, batch=2,
                                                         verbose=False)
        assert 0 <= out["metrics/mAP50-95(B)"] <= 1 and len(out["metrics"].stats["conf"]) == 3
        print("ok", len(res[0]))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_import_and_track_without_jax_cv2_pil(tmp_path):
    """The trackers import, and a BoT-SORT update with the GMC and a CPU
    ``YOLO.track`` with ReID run, with jax, cv2, PIL and the JAX package
    blocked."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "fce_yolo_tpu"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(1)  # one thread, as in the test workers
        import numpy as np
        from fce_yolo_tpu_torch import YOLO
        from fce_yolo_tpu_torch.trackers import BOTSORT, TrackerArgs
        rng = np.random.default_rng(0)
        base = rng.integers(0, 256, (130, 170, 3), dtype=np.uint8)
        tk = BOTSORT(TrackerArgs(tracker_type="botsort"))
        for t in range(3):
            out = tk.update(np.array([[40.0 + 2 * t, 40, 80 + 2 * t, 80]]), np.array([0.9]), np.array([0]),
                            img=base[:, 2 * t: 2 * t + 160].copy())
        assert out.shape == (1, 7) and out[0, 4] == 1
        root = sys.argv[1]
        open(root + "/reid.yaml", "w").write("tracker_type: botsort\\nwith_reid: True\\ngmc_method: sparseOptFlow\\n")
        res = YOLO("yolo11n-fce.yaml", device="cpu").track([base, base], tracker=root + "/reid.yaml", imgsz=64)
        assert len(res) == 2 and res[1][1].shape[1] == 7
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("shape,imgsz,scaleup", [
    ((96, 128, 3), 128, False),  # pad only
    ((128, 80, 3), 128, False),
    ((200, 150, 3), 128, False),  # shrink
    ((60, 100, 3), 128, True),  # grow
])
def test_letterbox_matches_jax(shape, imgsz, scaleup):
    """Same ratio, padding and output size, and the same pixels: the port's
    resize computes cv2's fixed-point INTER_LINEAR (``data/augment.py``)."""
    img = np.random.RandomState(3).randint(0, 256, shape, np.uint8)
    ref, r_ref, pad_ref = jax_letterbox(img, imgsz, scaleup=scaleup)
    out, r, pad = letterbox(img, imgsz, scaleup=scaleup)
    assert (r, pad) == (r_ref, pad_ref) and out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_results_api():
    data = np.array([[10, 20, 50, 60, 0.9, 1], [0, 0, 8, 8, 0.5, 1], [5, 5, 9, 9, 0.4, 0]], np.float32)
    r = Results(np.zeros((100, 200, 3), np.uint8), "x", {0: "cat", 1: "dog"}, boxes=data)
    assert len(r) == 3 and r.orig_shape == (100, 200)
    np.testing.assert_allclose(r.boxes.xywh[0], [30, 40, 40, 40])
    np.testing.assert_allclose(r.boxes.xyxyn[0], [0.05, 0.2, 0.25, 0.6])
    assert r.verbose() == "1 cat, 2 dogs, "
    assert r.summary()[0]["name"] == "dog" and len(r[1:]) == 2
    assert '"confidence": 0.9' in r.to_json()


def _boxes(results) -> list[np.ndarray]:
    return [r.boxes.data for r in results]


def test_predict_leaves_the_model_unfolded_and_saveable(tmp_path):
    """``predict`` runs a folded copy: the facade's model keeps every BN, its
    checkpoint loads into a fresh ``YOLO`` and predicts the same."""
    y = YOLO("yolo11n-fce.yaml", device="cpu")
    keys = set(y.model.state_dict())
    imgs = _images()
    before = y.predict(imgs, imgsz=128, batch=2)
    assert set(y.model.state_dict()) == keys and any(".bn." in k for k in keys) and not y.folded
    again = YOLO(y.save(tmp_path / "ckpt"), device="cpu")
    assert not again.folded and set(again.model.state_dict()) == keys
    for a, b in zip(_boxes(again.predict(imgs, imgsz=128, batch=2)), _boxes(before)):
        np.testing.assert_array_equal(a, b)


def test_repeated_predict_folds_once(monkeypatch):
    """Two predicts on unchanged weights fold once; new weights, an in-place
    edit or a dtype move fold again."""
    calls = []
    real = api.fold_conv_bn
    monkeypatch.setattr(api, "fold_conv_bn", lambda m: calls.append(1) or real(m))
    y = YOLO("yolo11n.yaml", device="cpu")
    img = _images()[0]
    y.predict(img, imgsz=64)
    y.predict(img, imgsz=64)
    assert len(calls) == 1
    y.reset_weights(1)
    y.predict(img, imgsz=64)
    with torch.no_grad():
        y.model.model[-1].cv3[0][2].bias.add_(1.0)
    y.predict(img, imgsz=64)
    y.to(torch.float64)
    y.predict(img, imgsz=64)
    assert len(calls) == 4
    assert not y.folded
    with torch.inference_mode():  # inference tensors keep no version counter: every predict folds
        z = YOLO("yolo11n.yaml", device="cpu")
    z.predict(img, imgsz=64)
    z.predict(img, imgsz=64)
    assert len(calls) == 6


def test_fused_facade_saves_and_loads_folded(tmp_path):
    """``fuse`` folds in place; ``save`` records it, a load builds the model
    folded and predicts the same; ``load`` follows the checkpoint's form
    either way."""
    y = YOLO("yolo11n-fce.yaml", device="cpu")
    imgs = _images()
    ref = y.predict(imgs, imgsz=128, batch=2)
    unfolded = y.save(tmp_path / "unfolded")
    path = y.fuse().save(tmp_path / "folded")
    assert y.folded and json.loads((Path(path) / "meta.json").read_text())["folded"] is True
    again = YOLO(path, device="cpu")
    assert again.folded and not any(".bn." in k for k in again.model.state_dict())
    for a, b in zip(_boxes(again.predict(imgs, imgsz=128, batch=2)), _boxes(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert not again.load(unfolded).folded and YOLO("yolo11n-fce.yaml", device="cpu").load(path).folded


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """Three JPEG files (4:2:0 q95, a 4:2:2 q80 with restart markers, and a
    gray one) in a tree, no larger than imgsz 128, and a PNG beside them."""
    import cv2

    root = tmp_path_factory.mktemp("predict_jpeg")
    (root / "sub").mkdir()
    imgs = _images(4)
    cv2.imwrite(str(root / "b.jpg"), imgs[0], [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(str(root / "sub" / "a.jpeg"), imgs[1], [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])
    cv2.imwrite(str(root / "c.jpg"), imgs[2][..., 0])
    cv2.imwrite(str(root / "d.png"), imgs[2])
    (root / "notes.txt").write_text("not an image")
    return root


@pytest.fixture(scope="module")
def predict_pair():
    return jax_facade("yolo11n-fce.yaml", 2, bias_prior=False)


@pytest.mark.parametrize("form", ["file", "directory", "list", "tuple-of-file-and-directory"])
def test_predict_on_image_files_matches_jax_facade(jpeg_dir, predict_pair, form):
    """``YOLO.predict`` on a JPEG file, a directory (rglob by extension,
    sorted), a list and a tuple: the same paths in the same order as the
    JAX facade's, and detections within this file's tolerance (the port's
    JPEG decode is bit-equal to cv2's, so both models see the same pixels)."""
    jy, port = predict_pair
    source = {"file": str(jpeg_dir / "b.jpg"), "directory": str(jpeg_dir),
              "list": [str(jpeg_dir / "sub" / "a.jpeg"), str(jpeg_dir / "c.jpg")],
              "tuple-of-file-and-directory": (str(jpeg_dir / "d.png"), str(jpeg_dir / "sub"))}[form]
    ref = jy.predict(source, imgsz=128, batch=2)
    out = port.predict(source, imgsz=128, batch=2)
    assert [r.path for r in out] == [r.path for r in ref]
    assert len(out) == {"file": 1, "directory": 4, "list": 2, "tuple-of-file-and-directory": 2}[form]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.orig_img, r.orig_img)
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


def test_predict_on_every_still_format_matches_jax_facade(predict_pair, tmp_path):
    """``YOLO.predict`` over a directory holding one file of each format the
    port reads (BMP, a DNG's preview, progressive JPEG, MPO, 16-bit Adam7
    PNG, PFM, LZW TIFF and PackBits-tiled TIFF): the JAX facade's paths, in
    its order, and detections within this file's tolerance."""
    from PIL import Image

    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    jy, port = predict_pair
    rng = np.random.RandomState(14)
    rgb = [rng.randint(0, 256, (int(rng.randint(64, 128)), int(rng.randint(64, 128)), 3)).astype(np.uint8)
           for _ in range(8)]
    files = {"a.bmp": C.bmp_bytes(rgb[0]), "c.jpg": C.jpeg_bytes(rgb[2], 90, "420", 2, progressive=True),
             "e.png": C.png_bytes(rgb[4], 16, True), "g.tif": C.tiff_bytes(rgb[6], 5, 2),
             "h.tiff": C.tiff_bytes(rgb[7], 32773, tile=(32, 32)),
             "b.dng": C.tiff_bytes(rgb[1], tags={50706: ("B", [1, 4, 0, 0]), 254: ("I", [1])}),
             "f.pfm": b"PF\n%d %d\n-1.0\n" % (rgb[5].shape[1], rgb[5].shape[0])
             + rgb[5][::-1].astype("<f4").tobytes()}
    for name, buf in files.items():
        (tmp_path / name).write_bytes(buf)
    frames = [Image.fromarray(rgb[3]), Image.fromarray(rgb[0])]
    frames[0].save(tmp_path / "d.mpo", save_all=True, append_images=frames[1:])
    ref = jy.predict(str(tmp_path), imgsz=128, batch=3)
    out = port.predict(str(tmp_path), imgsz=128, batch=3)
    assert [Path(r.path).name for r in out] == [Path(r.path).name for r in ref] == sorted(files)[:3] + ["d.mpo"] + \
        sorted(files)[3:]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.orig_img, r.orig_img)
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)


def test_predict_sources_the_port_refuses(jpeg_dir, tmp_path):
    """A file the port cannot read raises, where the JAX facade skips it in
    a directory (a progressive JPEG whose scans leave coefficients
    unfinished, which cv2 reads with block smoothing and the port does not;
    a corrupt one, which neither reads; a complete progressive JPEG reads as
    cv2 reads it); network streams, webcams,
    screenshots and video containers other than AVI raise
    NotImplementedError, a missing ``.streams`` file FileNotFoundError; a
    PIL image is read as the reference reads it."""
    import cv2
    from PIL import Image

    from fce_yolo_tpu.engine.predictor import load_source as jax_load_source
    from fce_yolo_tpu_torch.engine.predictor import load_source

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    assert list(jax_load_source(str(bad))) == []  # the reference skips what cv2 cannot read
    with pytest.raises(ValueError, match="broken.jpg"):
        list(load_source(str(bad), "cpu"))
    cv2.imwrite(str(tmp_path / "p.jpg"), _images()[0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])  # reads, as cv2 reads it
    (img, _), = list(load_source(str(tmp_path / "p.jpg"), "cpu"))
    np.testing.assert_array_equal(img, cv2.imread(str(tmp_path / "p.jpg")))
    buf = (tmp_path / "p.jpg").read_bytes()  # cut after its second scan: unfinished, which libjpeg smooths
    (tmp_path / "u.jpg").write_bytes(buf[: [i for i in range(len(buf)) if buf.startswith(b"\xff\xda", i)][2]]
                                     + b"\xff\xd9")
    with pytest.raises(ValueError, match="u.jpg: a progressive JPEG whose scans leave coefficients unfinished"):
        list(load_source(str(tmp_path / "u.jpg"), "cpu"))
    for src, what in (("rtsp://localhost:8554/cam", "network streams"), ("0", "webcam 0"),
                      ("screen 0", "screen capture"), (str(tmp_path / "clip.mp4"), "the mp4 video container")):
        with pytest.raises(NotImplementedError, match=what):
            list(load_source(src, "cpu"))
    with pytest.raises(FileNotFoundError, match="a.streams"):
        list(load_source("a.streams", "cpu"))
    with pytest.raises(FileNotFoundError):
        list(load_source(str(tmp_path / "missing.jpg"), "cpu"))
    rgb = _images(5)[0][..., ::-1].copy()
    (ref, ref_id), = list(jax_load_source(Image.fromarray(rgb)))
    (out, out_id), = list(load_source(Image.fromarray(rgb), "cpu"))
    assert out_id == ref_id == "pil"
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------ task heads
TASK_MODELS = {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml", "obb": "yolo11n-obb.yaml"}


@pytest.fixture(scope="module")
def task_predicts():
    """Each task head's JAX and port facades on the same seed-1 weights
    without the class prior (scores near 0.5, so NMS works through every
    candidate): the port's init (``jax_facade``), the JAX init for segment;
    and both predicts on ``_images()`` at imgsz 128, batch 2, run once."""
    done = {}

    def run(task: str):
        if task not in done:
            jy, port = jax_facade(TASK_MODELS[task], 1, bias_prior=False)
            if task == "segment":  # the JAX init's weights, on which the mask test's 1e-5 band was set
                jy.variables = jax.tree_util.tree_map(np.array, jax.jit(
                    lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(1)))
                for name, branch in jy.variables["params"]["layers_23"].items():  # mask coefficients up a
                    if name.startswith("cv4_") and name.endswith("_2"):  # little: masks of about half their boxes
                        branch["conv2d"]["bias"] += 0.3
                port.load_jax_variables(jy.variables)
            done[task] = (jy, port, jy.predict(_images(), imgsz=128, batch=2), port.predict(_images(), imgsz=128, batch=2))
        return done[task]

    return run


def _jax_mask_probabilities(jy, imgs: list[np.ndarray]) -> list[np.ndarray]:
    """The JAX predictor's mask probabilities before the 0.5 threshold for
    images no larger than 128 px (the predictor's folded model, NMS and
    ``process_mask`` steps with the threshold left out), in letterbox pixels;
    one jitted forward for all of them."""
    import jax.numpy as jnp

    from fce_yolo_tpu.nn.model import fold_conv_bn as jax_fold
    from fce_yolo_tpu.nn.modules import fused_bn_scope
    from fce_yolo_tpu.ops.masks import crop_mask
    from fce_yolo_tpu.ops.nms import batched_nms as jax_nms

    fwd, folded = jax.jit(lambda v, x: jy.model.apply(v, x, train=False)), jax_fold(jy.variables)
    probs = []
    for img in imgs:
        lb = jax_letterbox(img, 128, scaleup=False)[0][..., ::-1]
        with fused_bn_scope():
            out = fwd(folded, jnp.asarray(lb, jnp.float32)[None] / 255.0)
        nms = jax_nms(out["preds"], conf_thres=0.25, iou_thres=0.7, max_det=300, multi_label=False, nc=80)
        keep = np.asarray(nms["valid"][0])
        m = jax.nn.sigmoid(jnp.einsum("nk,hwk->nhw", nms["extra"][0][keep], out["proto"][0]))
        m = crop_mask(m, nms["boxes"][0][keep] * jnp.asarray([0.25, 0.25, 0.25, 0.25], jnp.float32))
        probs.append(np.asarray(jax.image.resize(m, (m.shape[0], 128, 128), method="bilinear")))
    return probs


@pytest.mark.parametrize("task", sorted(TASK_MODELS))
def test_task_predict_matches_jax_facade(task_predicts, task):
    """Classes and keep order equal; boxes, keypoints and xywhr within 1e-3
    px; mask pixels equal except where the JAX side's probability lies
    within 1e-5 of 0.5 (the images are no larger than imgsz, so the masks
    leave the letterbox by a crop alone)."""
    jy, port, ref, out = task_predicts(task)
    assert len(out) == len(ref) == 3
    probs = _jax_mask_probabilities(jy, _images()) if task == "segment" else None
    for i, (r, o) in enumerate(zip(ref, out)):
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
        if task == "pose":
            assert o.keypoints.data.shape == (len(o), 17, 3)
            np.testing.assert_allclose(o.keypoints.data, r.keypoints.data, rtol=0, atol=1e-3)
        if task == "obb":
            np.testing.assert_allclose(o.obb.data, r.obb.data, rtol=0, atol=1e-3)
            np.testing.assert_allclose(o.obb.xyxyxyxy, r.obb.xyxyxyxy, rtol=0, atol=2e-3)
        if task == "segment":
            h, w = o.orig_shape
            top, left = (128 - h) // 2, (128 - w) // 2
            p = probs[i][:, top: top + h, left: left + w]
            assert o.masks.data.shape == r.masks.data.shape == (len(o), h, w) and r.masks.data.any()
            differ = o.masks.data != r.masks.data
            assert (differ <= (np.abs(p - 0.5) <= 1e-5)).all()


@pytest.mark.parametrize("task", sorted(TASK_MODELS))
def test_predict_classes_stream_verbose_match_jax(task_predicts, task, capsys):
    """``classes`` keeps the same detections as the JAX facade's, with their
    masks, keypoints or oriented boxes in step; ``stream`` gives a generator;
    ``verbose`` prints the JAX facade's line (its time aside)."""
    import logging

    from fce_yolo_tpu.utils import LOGGER

    jy, port, _, full = task_predicts(task)
    records: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    LOGGER.addHandler(handler)
    try:
        ref = jy.predict(_images(), imgsz=128, batch=2, classes=[0, 2, 5], verbose=True)
    finally:
        LOGGER.removeHandler(handler)
    capsys.readouterr()
    gen = port.predict(_images(), imgsz=128, batch=2, classes=[0, 2, 5], verbose=True, stream=True)
    assert not isinstance(gen, list)
    out = list(gen)
    lines = capsys.readouterr().out.strip().splitlines()
    def bare(line: str) -> tuple[str, str]:  # the image number and the counts (the port numbers array ids)
        head, counts = line.split(": ", 1)
        return head.split()[1], counts.rsplit(" ", 1)[0]

    assert len(lines) == len(records) == 3 and [bare(ln) for ln in lines] == [bare(ln) for ln in records]
    for r, o, f in zip(ref, out, full):
        keep = np.isin(f.boxes.cls.astype(int), [0, 2, 5])
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_array_equal(o.boxes.data, f.boxes.data[keep])
        if task == "segment":
            np.testing.assert_array_equal(o.masks.data, f.masks.data[keep])
        if task == "pose":
            np.testing.assert_array_equal(o.keypoints.data, f.keypoints.data[keep])
        if task == "obb":
            np.testing.assert_array_equal(o.obb.data, f.obb.data[keep])


def test_task_results_api():
    """OBB results give their hulls as boxes and index in step; mask
    outlines and the summary of masks (with their segments) equal the JAX
    package's, which traces them with cv2.findContours."""
    from fce_yolo_tpu.engine.results import Results as JaxResults
    from fce_yolo_tpu_torch.engine.results import OBB

    obb = np.array([[50, 40, 20, 10, 0.3, 0.9, 1], [10, 10, 4, 8, 0.0, 0.5, 0]], np.float32)
    r = Results(np.zeros((100, 200, 3), np.uint8), "x", {0: "a", 1: "b"}, obb=obb)
    assert len(r) == 2 and isinstance(r.obb, OBB) and r.verbose() == "1 a, 1 b, "
    np.testing.assert_allclose(r.boxes.xyxy[1], [8, 6, 12, 14], atol=1e-5)
    assert r[1:].obb.data.tolist() == obb[1:].tolist() and len(r[[True, False]]) == 1
    masks = np.zeros((2, 100, 200), bool)
    masks[0, 10:30, 20:60] = True
    masks[1, 50:70, 100:150] = masks[1, 80:95, 10:20] = True  # two parts: the larger is the outline
    img = np.zeros((100, 200, 3), np.uint8)
    rm = Results(img, "x", {0: "a"}, boxes=obb[:, [0, 1, 2, 3, 5, 6]], masks=masks, device="cpu")
    ref = JaxResults(img, "x", {0: "a"}, boxes=obb[:, [0, 1, 2, 3, 5, 6]], masks=masks)
    assert rm[[1]].masks.data.shape == (1, 100, 200) and rm[[1]].masks.device == "cpu"
    xy = rm.masks.xy
    assert len(xy) == 2 and xy[1].tolist() == [[100, 50], [100, 69], [149, 69], [149, 50]]
    for a, b in zip(xy, ref.masks.xy):
        np.testing.assert_array_equal(a, b)
    assert rm.summary() == ref.summary() and rm.summary(normalize=True) == ref.summary(normalize=True)
    assert len(rm.summary()[1]["segments"]["x"]) == 4 + 4 + 2  # both parts, spliced into one outline
    kp = np.ones((2, 4, 3), np.float32)
    rk = Results(np.zeros((100, 200, 3), np.uint8), "x", {0: "a"}, boxes=obb[:, [0, 1, 2, 3, 5, 6]], keypoints=kp)
    assert rk.summary()[0]["keypoints"]["visible"] == [1.0] * 4
