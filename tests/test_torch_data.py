"""The port's data layer against cv2, pyyaml and the JAX package: the PNG
reader, the YAML reader (data and model files), ``check_det_dataset``, the
val dataset and ``collate``, and the numpy metrics.

Tolerances: images bit-equal to ``cv2.imread``; the YAML reader equal to
``yaml.safe_load`` on the keys it reads; datasets equal to the JAX
package's, pixels and geometry, with and without a resize (imgsz 160 and
64 over 96-160 px images: the port's resize computes cv2's fixed-point
one); metrics within 1e-12 (the same numpy code on the same inputs).
"""

import shutil
import sys
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from fce_yolo_tpu.data.dataset import YOLODataset as JaxDataset
from fce_yolo_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from fce_yolo_tpu.data.dataset import collate as jax_collate
from fce_yolo_tpu.utils import metrics as jm
from fce_yolo_tpu_torch.cfg.models import MODELS, load_model_dict
from fce_yolo_tpu_torch.data.dataset import DATA_KEYS, YOLODataset, check_det_dataset, collate, read_data_yaml
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.data.loader import DataLoader
from fce_yolo_tpu_torch.utils import metrics as pm
from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

REPO = Path(__file__).resolve().parent.parent
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def png_filter(px: np.ndarray, filters, bpp: int) -> bytes:
    """Filter each row of (H, stride) uint8 ``px`` with the PNG filter given
    for it (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); the filter byte leads."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    rows = [np.concatenate([[f], (x[r] - preds[f][r]) & 255]) for r, f in enumerate(filters)]
    return np.stack(rows).astype(np.uint8).tobytes()


def write_png(path, arr: np.ndarray, color: int, filters, palette=None, depth=8, interlace=0) -> None:
    """A PNG of samples ``arr`` (H, W, channels) with the given row filters."""
    h, w = arr.shape[:2]
    bpp = CHANNELS[color]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(png_filter(arr.reshape(h, w * bpp), filters, bpp)))
    Path(path).write_bytes(data + chunk(b"IEND", b""))


def png_copy(yaml_path: str, dest: Path) -> str:
    """Copy a YOLO dataset with its images re-encoded as PNG (the pixels
    ``cv2.imread`` gave for the originals); returns the new data YAML."""
    src = Path(yaml_path).parent
    for f in src.rglob("*"):
        rel = f.relative_to(src)
        if f.suffix == ".jpg":
            (dest / rel).parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str((dest / rel).with_suffix(".png")), cv2.imread(str(f)))
        elif f.suffix == ".txt":
            (dest / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dest / rel)
    text = Path(yaml_path).read_text().replace(str(src), str(dest))
    (dest / "data.yaml").write_text(text)
    return str(dest / "data.yaml")


@pytest.fixture(scope="session")
def png_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png"))


# ------------------------------------------------------------------- imread
@pytest.mark.parametrize("mode", ["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color", [0, 2, 3, 4, 6], ids=["gray", "rgb", "palette", "gray-alpha", "rgba"])
def test_imread_png_filters_match_cv2(tmp_path, color, mode):
    rng = np.random.RandomState(color * 10 + len(mode))
    palette = rng.randint(0, 256, (23, 3)).astype(np.uint8) if color == 3 else None
    for i, (h, w) in enumerate([(1, 1), (1, 9), (7, 1), (13, 17), (40, 33)]):
        arr = rng.randint(0, 23 if color == 3 else 256, (h, w, CHANNELS[color])).astype(np.uint8)
        arr[h // 2:, : w // 2] = arr[0, 0]  # a flat patch beside the noise
        k = ["none", "sub", "up", "average", "paeth"].index(mode) if mode != "mixed" else None
        filters = [k] * h if k is not None else list(rng.randint(0, 5, h))
        path = tmp_path / f"{i}.png"
        write_png(path, arr, color, filters, palette)
        ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        out = imread(path)
        assert out.dtype == np.uint8 and out.shape == ref.shape == (h, w, 3)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_imread_matches_cv2_on_cv2_written_png(tmp_path, channels):
    rng = np.random.RandomState(channels)
    for i, (h, w) in enumerate([(1, 1), (1, 31), (29, 1), (97, 131)]):
        img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        img[: h // 2, : w // 3] = 60  # flat area: libpng's filter choice varies by row
        path = tmp_path / f"{i}.png"
        assert cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
        np.testing.assert_array_equal(imread(path), cv2.imread(str(path), cv2.IMREAD_COLOR))


def test_imread_npy_and_unsupported(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (12, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "a.npy", img)
    np.testing.assert_array_equal(imread(tmp_path / "a.npy"), img)
    cv2.imwrite(str(tmp_path / "a.jpg"), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cv2.imwrite(str(tmp_path / "deep.png"), img.astype(np.uint16) * 257)  # 16-bit PNG
    sys.path.insert(0, str(REPO))
    import chip_smoke

    (tmp_path / "laced.png").write_bytes(chip_smoke.png_bytes(img[..., ::-1].copy(), interlace=True))  # Adam7
    np.save(tmp_path / "f.npy", img.astype(np.float32))
    for name in ("a.jpg", "deep.png", "laced.png"):  # progressive JPEG, 16-bit and Adam7 PNG: read as cv2 reads them
        np.testing.assert_array_equal(imread(tmp_path / name, device="cpu"), cv2.imread(str(tmp_path / name)))
    with pytest.raises(ValueError, match="only.*baseline|baseline.*only"):
        imread(tmp_path / "f.npy", device="cpu")
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "missing.png")


# ---------------------------------------------------------------- data YAML
@pytest.mark.parametrize("path", sorted((REPO / "fce_yolo_tpu" / "cfg" / "datasets").glob("*.yaml")),
                         ids=lambda p: p.stem)
def test_data_yaml_reader_matches_pyyaml(path):
    text = path.read_text()
    ref = yaml.safe_load(text)
    assert read_data_yaml(text) == {k: ref[k] for k in DATA_KEYS if k in ref}


@pytest.mark.parametrize("path", sorted((REPO / "fce_yolo_tpu" / "cfg" / "models").glob("*.yaml")),
                         ids=lambda p: p.stem)
def test_model_yaml_reader_matches_pyyaml(path):
    """Every packaged model YAML read whole (floats in ``scales``, flow rows
    under ``backbone:``/``head:``); the port's own dicts equal the files."""
    ref = yaml.safe_load(path.read_text())
    assert read_yaml(path.read_text()) == ref
    assert load_model_dict(path)[0] == ref
    if path.stem in MODELS:
        assert MODELS[path.stem] == ref


@pytest.mark.parametrize("text", [
    "path: ../d  # root\ntrain:\n  - images/a\n  - 'images/b c'\nval: \"images/v\"\ntest:\nnc: 3\n"
    "names:\n  0: person\n  1: \"traffic light\"\n  2: 'it''s'\ndownload: |\n  names = [1]\n  x: 2\n",
    "path: /a\ntrain: t\nval: v\nnames:\n- a\n- b\n",
    "# header\npath: /a\ntrain: [t1, t2]\nval: v\nnames: [a, 'b, c', \"d\", jack-o'-lantern]\nnc: 4\n",
    "path: /a\nval: v\nnames: {0: x,\n  1: two\n    words, 2: 'q'}\nchannels: 3\nkpt_shape: [17, 3]\n",
    "path: /a\nval: v\nnc: 2\nnames: [1.5, .5, -.5, 1e3, 2.0e+3, .inf, -.Inf, 0., 1_0.5, a.b, ~, null, 'yes', yes]\n",
    'path: /a\nval: v\nnames:\n  0: "traffic\\\n    \\ light"\n  1: "a \\\\\n    b\\\n  c"\n',
], ids=["block-map", "block-list", "inline-list", "flow-map", "scalars", "escaped-break"])
def test_data_yaml_reader_forms(text):
    ref = yaml.safe_load(text)
    assert read_data_yaml(text) == {k: ref[k] for k in DATA_KEYS if k in ref}


def test_check_det_dataset_matches_jax(png_dataset):
    ref = jax_check_det_dataset(png_dataset)
    assert check_det_dataset(png_dataset) == ref
    assert check_det_dataset(dict(yaml.safe_load(Path(png_dataset).read_text()))) == ref
    with pytest.raises(FileNotFoundError, match="not in the packaged registry"):
        check_det_dataset("no-such-dataset.yaml")


# ------------------------------------------------------ dataset and collate
@pytest.mark.parametrize("imgsz", [160, 64])
def test_val_dataset_and_collate_match_jax(png_dataset, imgsz):
    d = check_det_dataset(png_dataset)
    ref_ds = JaxDataset(d["val"], imgsz=imgsz, mode="val", nc=d["nc"], cache_labels=False)
    ds = YOLODataset(d["val"], imgsz=imgsz, mode="val", nc=d["nc"])
    assert ds.im_files == ref_ds.im_files and len(ds) == 4
    samples, ref_samples = [ds[i] for i in range(len(ds))], [ref_ds[i] for i in range(len(ds))]
    for s, r in zip(samples, ref_samples):
        assert (s["ratio"], s["pad"], s["orig_shape"]) == (r["ratio"], r["pad"], r["orig_shape"])
        np.testing.assert_array_equal(s["cls"], r["cls"])
        np.testing.assert_array_equal(s["bboxes"], r["bboxes"])
        diff = np.abs(s["img"].astype(int) - r["img"].astype(int))
        assert s["img"].shape == r["img"].shape and diff.max() == 0
    out, ref = collate(samples), jax_collate(samples)
    assert out.keys() == {"img", "cls", "bboxes", "mask", "ratio", "pad", "orig_shape"}
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_val_loader_pads_the_tail_batch(png_dataset):
    d = check_det_dataset(png_dataset)
    ds = YOLODataset(d["val"], imgsz=160, mode="val", nc=d["nc"])
    batches = list(DataLoader(ds, batch_size=3, workers=2))
    assert [b["n_valid"] for b in batches] == [3, 1]
    assert all(b["img"].shape == (3, 160, 160, 3) for b in batches)
    ref = collate([ds[i] for i in range(3)])
    for k in ref:
        np.testing.assert_array_equal(batches[0][k], ref[k])
    np.testing.assert_array_equal(batches[1]["img"][2], ds[3]["img"])  # padded with the last image
    with pytest.raises(ValueError, match="'train' or 'val'"):  # train mode exists since the training slice
        YOLODataset(d["val"], mode="test")


# ------------------------------------------------------------------ metrics
def _stats(seed, n_img=6, high_recall=False):
    """Per-image predictions and labels: random boxes, or predictions jittered around the labels."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_img):
        g = rng.randint(0, 6)
        gb = np.concatenate([rng.uniform(0, 80, (g, 2)), rng.uniform(0, 80, (g, 2)) + 20], 1)
        gb[:, 2:] += gb[:, :2] - 20
        gc = rng.randint(0, 3, g).astype(float)
        if high_recall:
            pb = np.concatenate([gb + rng.normal(0, 2, gb.shape), _rand_boxes(rng, 3)])
            pc = np.concatenate([gc, rng.randint(0, 3, 3)]).astype(float)
        else:
            k = rng.randint(0, 12)
            pb, pc = _rand_boxes(rng, k), rng.randint(0, 3, k).astype(float)
        out.append((pb, rng.rand(len(pb)), pc, gb, gc))
    return out


def _rand_boxes(rng, k):
    xy = rng.uniform(0, 90, (k, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 40, (k, 2))], 1)


def _accumulate(lib, stats):
    metrics, cm = lib.DetMetrics(names={0: "a", 1: "b", 2: "c"}), lib.ConfusionMatrix(names={0: "a", 1: "b", 2: "c"})
    for pb, pconf, pc, gb, gc in stats:
        tp = lib.match_predictions(pc, gc, lib.box_iou_np(gb, pb)) if len(pc) and len(gc) else np.zeros((len(pc), 10), bool)
        metrics.update_stats(dict(tp=tp, conf=pconf, pred_cls=pc, target_cls=gc, target_img=np.unique(gc)))
        cm.process_batch(dict(bboxes=pb, conf=pconf, cls=pc), dict(bboxes=gb, cls=gc))
    metrics.process(nc=3)
    return metrics, cm


@pytest.mark.parametrize("case", ["random", "high-recall", "no-predictions", "no-labels"])
def test_metrics_match_jax(case):
    stats = _stats(7, high_recall=case == "high-recall")
    if case == "no-predictions":
        stats = [(np.zeros((0, 4)), np.zeros(0), np.zeros(0), gb, gc) for _, _, _, gb, gc in stats]
    if case == "no-labels":
        stats = [(pb, pconf, pc, np.zeros((0, 4)), np.zeros(0)) for pb, pconf, pc, _, _ in stats]
    out_m, out_cm = _accumulate(pm, stats)
    ref_m, ref_cm = _accumulate(jm, stats)
    np.testing.assert_array_equal(out_cm.matrix, ref_cm.matrix)
    for k, v in ref_m.results_dict.items():
        assert abs(out_m.results_dict[k] - v) <= 1e-12, k
    np.testing.assert_allclose(out_m.all_ap, ref_m.all_ap, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out_m.maps, ref_m.maps, rtol=0, atol=1e-12)
    if case == "high-recall":
        assert out_m.map50 > 0.5
    if stats and any(len(s[0]) for s in stats) and any(len(s[3]) for s in stats):
        cat = {k: np.concatenate(v) for k, v in out_m.stats.items()}
        ref = jm.ap_per_class(cat["tp"], cat["conf"], cat["pred_cls"], cat["target_cls"])
        out = pm.ap_per_class(cat["tp"], cat["conf"], cat["pred_cls"], cat["target_cls"])
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
