"""The port's open-vocabulary data (``data/multimodal.py``) against the JAX
package's: ``random_load_text``'s draws, the items of
``YOLOMultiModalDataset`` (train and val), ``GroundingDataset`` (a
grounding JSON written here), ``YOLOVisualPromptDataset`` and
``YOLOConcatDataset``, and ``collate`` with ``txt_feats`` and
``visual_prompts``; then the port's loader on them.

Tolerances: classes, texts, text embeddings, prompt masks and generator
states equal; images within one level on at most the augment tests' share
of pixels and boxes within 1e-3 px (``test_torch_augment.py``: the warps'
float rounding).
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest

from fce_yolo_tpu.data import dataset as JD
from fce_yolo_tpu.data import multimodal as JM
from fce_yolo_tpu_torch.data import dataset as PD
from fce_yolo_tpu_torch.data import multimodal as PM
from fce_yolo_tpu_torch.data.loader import DataLoader
from test_torch_augment import assert_samples_match
from test_torch_data import png_copy

NAMES = {0: "circle/ring/disc", 1: "square", 2: "tri/triangle"}


@pytest.fixture(scope="module")
def png_mm_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_mm"))


def _sample(rng, n, nc, extra=False):
    s = {"cls": rng.integers(0, nc, n).astype(np.float32), "bboxes": rng.random((n, 4)).astype(np.float32)}
    if extra:
        s["segments"] = [rng.random((int(rng.integers(3, 7)), 2)).astype(np.float32) for _ in range(n)]
        s["keypoints"] = rng.random((n, 5, 3)).astype(np.float32)
    return s


@pytest.mark.parametrize("seed", range(6))
def test_random_load_text_draws_as_jax(seed):
    """The same positives, negatives, synonyms and padding from the same
    Generator (its state after equal too), with more positives than
    ``max_samples`` on some seeds, polygons (a list) and keypoints (an array)."""
    rng = np.random.default_rng(100 + seed)
    nc = int(rng.integers(3, 30))
    class_texts = [[f"c{i}"] + [f"c{i}_syn{j}" for j in range(int(rng.integers(0, 3)))] for i in range(nc)]
    kw = dict(max_samples=int(rng.integers(2, 12)), neg_samples=(int(rng.integers(0, 4)), 8),
              padding_pool=["pad_a", "pad_b", "pad_c"], prompt_format="a photo of {}")
    s = _sample(rng, int(rng.integers(0, 15)), nc, extra=seed % 2 == 0)
    a = {k: list(v) if isinstance(v, list) else v.copy() for k, v in s.items()}
    b = {k: list(v) if isinstance(v, list) else v.copy() for k, v in s.items()}
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    out = PM.random_load_text(a, class_texts, g1, **kw)
    ref = JM.random_load_text(b, class_texts, g2, **kw)
    assert out["texts"] == ref["texts"] and len(out["texts"]) == kw["max_samples"]
    for k in ("cls", "bboxes", "keypoints"):
        if k in ref:
            np.testing.assert_array_equal(out[k], ref[k])
    if "segments" in ref:
        assert len(out["segments"]) == len(ref["segments"])
        for x, y in zip(out["segments"], ref["segments"]):
            np.testing.assert_array_equal(x, y)
    assert g1.bit_generator.state == g2.bit_generator.state


def _assert_text_samples_match(out, ref):
    assert_samples_match(out, ref)
    assert out["texts"] == ref["texts"]
    np.testing.assert_array_equal(out["txt_feats"], ref["txt_feats"])


@pytest.mark.parametrize("mode", ["train", "val"])
def test_multimodal_dataset_items_match_jax(png_mm_dataset, mode):
    """Items from the dataset's own generator (augment, then the texts) as
    the JAX dataset's, over two epochs' reseeds; the vocab statistics and
    the negative pool; val pads the first synonyms with empty texts."""
    d = PD.check_det_dataset(png_mm_dataset)
    kw = dict(imgsz=96, mode=mode, seed=3, names=NAMES, max_samples=5, neg_samples=(1, 2))
    ds = PM.YOLOMultiModalDataset(d[mode], device="cpu", **kw)
    jds = JM.YOLOMultiModalDataset(d[mode], cache_labels=False, **kw)
    assert ds.category_names == jds.category_names and ds.category_freq == jds.category_freq
    assert ds._neg_pool == jds._neg_pool and ds.max_samples == jds.max_samples == 5
    for epoch in (0, 2):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in (0, 3, 1):
            out, ref = ds[i], jds[i]
            _assert_text_samples_match(out, ref)
            assert out["txt_feats"].shape == (5, 512)
        assert ds._rng.bit_generator.state == jds._rng.bit_generator.state
    if mode == "val":
        assert ds[0]["texts"] == ["circle", "square", "tri", "", ""]


def _grounding_json(root: Path, d: dict) -> Path:
    """A COCO-style grounding JSON over the val images: each box's class
    spans one or two caption phrases (``tokens_positive``), one crowd box
    and one empty box to skip, and an image without a file."""
    caption = "a red circle next to a green square and a blue triangle"
    at = {w: [caption.find(w), caption.find(w) + len(w)] for w in ("red circle", "green square", "blue", "triangle")}
    spans = {0: [at["red circle"]], 1: [at["green square"]], 2: [at["blue"], at["triangle"]]}
    images, anns = [], []
    for i, f in enumerate(sorted(Path(d["val"]).glob("*.png"))):
        lab = PD._read_labels(PD.img2label_path(str(f)))
        w, h = struct.unpack(">II", f.read_bytes()[16:24])  # the PNG's IHDR
        images.append({"id": i, "file_name": f.name, "width": w, "height": h, "caption": caption})
        for c, (cx, cy, bw, bh) in zip(lab["cls"].astype(int), lab["xywhn"]):
            box = [float(v) for v in ((cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h)]
            anns.append({"id": len(anns), "image_id": i, "bbox": box, "tokens_positive": spans[c], "iscrowd": 0})
        anns.append({"id": len(anns), "image_id": i, "bbox": [1, 1, 5, 5], "tokens_positive": spans[0], "iscrowd": 1})
        anns.append({"id": len(anns), "image_id": i, "bbox": [1, 1, 0, 5], "tokens_positive": spans[1]})
    images.append({"id": 99, "file_name": "missing.png", "width": 10, "height": 10, "caption": caption})
    anns.append({"id": len(anns), "image_id": 99, "bbox": [1, 1, 5, 5], "tokens_positive": spans[1]})
    path = root / "grounding.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return path


@pytest.mark.parametrize("mode", ["train", "val"])
def test_grounding_dataset_matches_jax(png_mm_dataset, tmp_path, mode):
    """Caption phrases become each image's classes; crowd and empty boxes
    and a missing file are skipped; mosaic and mixing are off; items and
    generator states as the JAX dataset's."""
    d = PD.check_det_dataset(png_mm_dataset)
    js = _grounding_json(tmp_path, d)
    kw = dict(imgsz=96, mode=mode, seed=1, max_samples=4, neg_samples=(1, 1))
    ds = PM.GroundingDataset(d["val"], str(js), device="cpu", **kw)
    jds = JM.GroundingDataset(d["val"], str(js), **kw)
    assert ds.im_files == jds.im_files and len(ds) == 4
    assert ds._image_texts == jds._image_texts and any(["blue triangle"] in t for t in ds._image_texts)
    for a, b in zip(ds.labels, jds.labels):
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["xywhn"], b["xywhn"])
    assert not ds.mosaic_enabled and ds.hyp.mosaic == ds.hyp.mixup == 0.0
    assert ds.category_freq == jds.category_freq and ds._neg_pool == jds._neg_pool
    assert PM.texts_flat(ds._image_texts) == JM.texts_flat(jds._image_texts) and PM.texts_flat([]) == [[""]]
    for i in (2, 0):
        _assert_text_samples_match(ds[i], jds[i])
    assert ds._rng.bit_generator.state == jds._rng.bit_generator.state


def test_visual_prompt_dataset_matches_jax(png_mm_dataset):
    d = PD.check_det_dataset(png_mm_dataset)
    ds = PM.YOLOVisualPromptDataset(d["train"], imgsz=64, mode="train", nc=3, seed=0, device="cpu")
    jds = JM.YOLOVisualPromptDataset(d["train"], imgsz=64, mode="train", nc=3, seed=0, cache_labels=False)
    for i in (0, 1, 5):
        out, ref = ds[i], jds[i]
        assert_samples_match(out, ref)
        assert out["visual_prompts"].shape == (3, 8, 8)
        np.testing.assert_array_equal(out["visual_prompts"], ref["visual_prompts"])


def test_concat_dataset_matches_jax(png_mm_dataset):
    d = PD.check_det_dataset(png_mm_dataset)
    parts = [PM.YOLOVisualPromptDataset(d[s], imgsz=64, mode="val", nc=3, device="cpu") for s in ("train", "val")]
    jparts = [JM.YOLOVisualPromptDataset(d[s], imgsz=64, mode="val", nc=3, cache_labels=False)
              for s in ("train", "val")]
    cat, jcat = PM.YOLOConcatDataset(parts), JM.YOLOConcatDataset(jparts)
    assert len(cat) == len(jcat) == 12 and cat.mode == "val" and cat.task == "detect"
    assert [len(x["cls"]) for x in cat.labels] == [len(x["cls"]) for x in jcat.labels]
    for i in (0, 7, 8, 11, -1):
        np.testing.assert_array_equal(cat[i]["visual_prompts"], jcat[i]["visual_prompts"])
        np.testing.assert_array_equal(cat[i]["img"], jcat[i]["img"])
    with pytest.raises(IndexError):
        cat[12]
    with pytest.raises(ValueError, match="mixed modes"):
        PM.YOLOConcatDataset([parts[0], PM.YOLOVisualPromptDataset(d["val"], imgsz=64, mode="train", nc=3,
                                                                    device="cpu")])


def test_collate_carries_text_and_prompts_as_jax(png_mm_dataset):
    d = PD.check_det_dataset(png_mm_dataset)
    ds = PM.YOLOMultiModalDataset(d["val"], imgsz=64, mode="val", names=NAMES, device="cpu")
    vds = PM.YOLOVisualPromptDataset(d["val"], imgsz=64, mode="val", nc=3, device="cpu")
    samples = [{**ds[i], "visual_prompts": vds[i]["visual_prompts"]} for i in range(3)]
    out, ref = PD.collate(samples, max_labels=8), JD.collate(samples, max_labels=8)
    assert out.keys() == ref.keys() and out["txt_feats"].shape == (3, 3, 512)
    assert out["visual_prompts"].shape == (3, 3, 8, 8)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def test_loader_batches_carry_the_sampled_texts(png_mm_dataset):
    """The port's loader hands item j of the epoch its own generator: the
    texts are drawn from it after the augment, so the batches do not depend
    on the thread count; every sample's labels index its own texts."""
    d = PD.check_det_dataset(png_mm_dataset)
    runs = []
    for workers in (1, 3):
        ds = PM.YOLOMultiModalDataset(d["train"], imgsz=64, mode="train", names=NAMES, max_samples=3, device="cpu")
        loader = DataLoader(ds, batch_size=3, workers=workers, max_labels=8, seed=2)
        loader.set_epoch(1)
        runs.append(list(loader))
    for b1, b3 in zip(*runs):
        for k in ("img", "cls", "txt_feats"):
            np.testing.assert_array_equal(b1[k], b3[k])
        assert b1["txt_feats"].shape == (3, 3, 512)
        assert (b1["cls"][b1["mask"]] < 3).all()
    enc = ds._encoder
    for j in range(3):
        # each row of txt_feats is the hash embedding of a name or a synonym of it, or of a padding text
        embs = {t: enc.encode_text([t])[0].tobytes() for t in ("circle", "ring", "disc", "square", "tri", "triangle")}
        rows = {r.tobytes() for r in runs[0][0]["txt_feats"][j]}
        assert rows <= set(embs.values()) | {enc.encode_text([t])[0].tobytes() for t in ds._neg_pool}
