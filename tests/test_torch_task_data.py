"""The task heads' data path against the JAX package and cv2: the polygon
fill against ``cv2.fillPoly``, the convex hull and the minimum-area
rectangle against ``cv2.convexHull`` and ``cv2.minAreaRect`` (all bit for
bit), and the label reader, the val and train items and ``collate`` against
the JAX dataset on the tiny segment, pose and OBB datasets (every array
equal; the train items' labels within 1e-5 px)."""

import cv2
import numpy as np
import pytest

from fce_yolo_tpu.data.dataset import YOLODataset as JaxDataset
from fce_yolo_tpu.data.dataset import check_det_dataset as jax_check
from fce_yolo_tpu.data.dataset import collate as jax_collate
from fce_yolo_tpu.data.augment import AugmentCfg as JaxAugmentCfg
from fce_yolo_tpu_torch.data.augment import AugmentCfg
from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset, collate
from fce_yolo_tpu_torch.ops.geometry import convex_hull, fill_poly, min_area_rect, regularize_rboxes, xywhr2xyxyxyxy
from fce_yolo_tpu.ops import geometry as jgeometry


def _polygons(seed: int, n: int):
    """(h, w, int32 vertices) of every kind the collate meets and more."""
    rng = np.random.RandomState(seed)
    for t in range(n):
        h, w = (int(v) for v in rng.randint(4, 48, 2))
        k = int(rng.randint(3, 12))
        kind = t % 6
        if kind == 0:  # inside the plane
            pts = np.stack([rng.randint(0, w, k), rng.randint(0, h, k)], 1)
        elif kind == 1:  # on the border: a label at 1.0 scales to w or h
            pts = np.stack([rng.randint(0, w + 1, k), rng.randint(0, h + 1, k)], 1)
        elif kind == 2:  # leaving the plane a little
            pts = np.stack([rng.randint(-3, w + 4, k), rng.randint(-3, h + 4, k)], 1)
        elif kind == 3:  # far outside
            pts = rng.randint(-3 * max(h, w), 3 * max(h, w), (k, 2))
        elif kind == 4:  # concave star
            a = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = np.where(np.arange(k) % 2, 0.2, 0.5) * min(h, w)
            pts = np.round(np.stack([w / 2 + r * np.cos(a), h / 2 + r * np.sin(a)], 1))
        else:  # self-touching: a bow tie through one vertex, and repeated points
            x0, y0 = rng.randint(0, w), rng.randint(0, h)
            pts = np.array([[x0, y0], [0, 0], [w - 1, 0], [x0, y0], [w - 1, h - 1], [0, h - 1], [0, h - 1]])
        yield h, w, pts.astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_matches_cv2(seed):
    for h, w, pts in _polygons(seed, 300):
        ref = np.zeros((h, w), np.float32)
        cv2.fillPoly(ref, [pts], 1.0)
        out = fill_poly(np.zeros((h, w), np.float32), [pts], 1.0)
        np.testing.assert_array_equal(out, ref, err_msg=f"{h}x{w} {pts.tolist()}")


def test_convex_hull_matches_cv2():
    rng = np.random.RandomState(0)
    for _ in range(300):
        p = rng.uniform(0, 100, (int(rng.randint(3, 12)), 2)).astype(np.float32)
        assert convex_hull(p).tolist() == cv2.convexHull(p, returnPoints=False).ravel().tolist()
    square = np.array([[0, 0], [5, 0], [5, 5], [0, 5]], np.float32)
    for r in range(4):  # a polygon's own order is kept, from its lowest index
        p = np.roll(square, r, 0)
        assert convex_hull(p).tolist() == cv2.convexHull(p, returnPoints=False).ravel().tolist()


def _rotated_quad(rng):
    cx, cy, w, h, a = rng.uniform(20, 80), rng.uniform(20, 80), rng.uniform(2, 40), rng.uniform(2, 40), \
        rng.uniform(-3.2, 3.2)
    c, s = np.cos(a), np.sin(a)
    p = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]) @ np.array([[c, -s], [s, c]]).T
    return np.roll(p + [cx, cy], rng.randint(4), 0)


def test_min_area_rect_matches_cv2():
    """Bit-equal to OpenCV 5 (angle in [-90, 0), w and h by its side
    vectors) on rotated rectangles, DOTA-style corners rounded to 4 decimals,
    random point sets, and axis-aligned rectangles and squares in every
    vertex order, where two conventions put the angle a quarter turn apart."""
    rng = np.random.RandomState(1)
    cases = [_rotated_quad(rng) for _ in range(300)] + [rng.uniform(0, 100, (int(rng.randint(3, 10)), 2))
                                                          for _ in range(300)]
    cases += [np.round(_rotated_quad(rng) / 100, 4) * 96 for _ in range(300)]
    for x, y, w, h in ((0, 0, 10, 5), (3, 4, 5, 10), (7, 1, 6, 6), (0, 0, 1, 1), (2, 9, 30, 30)):
        quad = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
        cases += [quad, quad[::-1], np.roll(quad, 1, 0), np.roll(quad[::-1], 2, 0)]
    for p in cases:
        p = np.ascontiguousarray(p, np.float32)
        assert min_area_rect(p) == cv2.minAreaRect(p), p.tolist()
    assert min_area_rect(np.array([[7, 1], [13, 1], [13, 7], [7, 7]], np.float32))[2] == -90.0


def test_rbox_helpers_match_jax():
    rng = np.random.RandomState(2)
    r = np.concatenate([rng.uniform(0, 100, (20, 2)), rng.uniform(1, 30, (20, 2)), rng.uniform(-3, 3, (20, 1))], 1)
    np.testing.assert_array_equal(xywhr2xyxyxyxy(r), jgeometry.xywhr2xyxyxyxy(r))
    np.testing.assert_array_equal(regularize_rboxes(r), jgeometry.regularize_rboxes(r))


TASKS = {"segment": ("tiny_seg_dataset", (17, 3)), "pose": ("tiny_pose_dataset", (4, 3)),
         "obb": ("tiny_obb_dataset", (17, 3))}


@pytest.mark.parametrize("task", sorted(TASKS))
@pytest.mark.parametrize("split", ["train", "val"])
def test_labels_and_collate_match_jax(task, split, request):
    """Both splits of each tiny dataset read in val mode at 96 px (a
    letterbox that shrinks the 128 px images), 8 labels a batch."""
    fixture, kpt_shape = TASKS[task]
    data = request.getfixturevalue(fixture)
    jd, pd = jax_check(data), check_det_dataset(data)
    ref_ds = JaxDataset(jd[split], imgsz=96, mode="val", task=task, kpt_shape=kpt_shape, cache_labels=False)
    ds = YOLODataset(pd[split], imgsz=96, mode="val", task=task, kpt_shape=kpt_shape, device="cpu")
    assert len(ds) == len(ref_ds)
    for lab, ref in zip(ds.labels, ref_ds.labels):
        assert set(lab) == set(ref)
        for k in ref:
            for a, b in zip(lab[k] if isinstance(lab[k], list) else [lab[k]],
                            ref[k] if isinstance(ref[k], list) else [ref[k]]):
                np.testing.assert_array_equal(a, b, err_msg=k)
    items = [ds[i] for i in range(len(ds))]
    ref_items = [ref_ds[i] for i in range(len(ref_ds))]
    for it, ref in zip(items, ref_items):
        for k in ("segments", "keypoints"):
            assert (k in it) == (k in ref)
            for a, b in zip(it.get(k, []), ref.get(k, [])):
                np.testing.assert_array_equal(a, b, err_msg=k)
    out = collate(items, max_labels=8, obb=task == "obb")
    ref = jax_collate(ref_items, max_labels=8, obb=task == "obb")
    assert set(out) == set(ref) - {"txt_feats", "visual_prompts"}
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    if task == "segment":
        assert out["masks"].shape[2:] == (24, 24) and out["masks"].sum() > 0


def test_collate_overlap_rule_and_short_polygons():
    """Overlapping polygons: each pixel goes to the smallest instance on it,
    as the JAX collate resolves them; a polygon of two points fills nothing."""
    img = np.zeros((64, 64, 3), np.uint8)
    big = np.array([[4, 4], [60, 4], [60, 60], [4, 60]], np.float32)
    small = np.array([[20, 20], [40, 20], [40, 40], [20, 40]], np.float32)
    same = small + 8  # equal areas: their order decides
    line = np.array([[0, 0], [30, 30]], np.float32)
    segs = [big, small, same, line]
    sample = {"img": img, "cls": np.zeros(4, np.float32),
              "bboxes": np.array([[*s.min(0), *s.max(0)] for s in segs], np.float32), "segments": segs}
    out = collate([sample], max_labels=6)
    ref = jax_collate([sample], max_labels=6)
    np.testing.assert_array_equal(out["masks"], ref["masks"])
    m = out["masks"][0]
    assert m[3].sum() == 0 and m[0].sum() > 0 and (m.sum(0) <= 1).all()


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_mode_items_and_collate_match_jax(task, request):
    """Train mode on each tiny task dataset, the dataset's own generator after
    ``set_epoch`` on both sides: the same items (images bit-equal, polygons,
    corners and keypoints equal), the same generator state, and ``collate``
    giving the same masks, keypoints and rotated boxes. A pose dataset
    without ``flip_idx`` turns both flips off, as the JAX dataset does."""
    fixture, kpt_shape = TASKS[task]
    d = check_det_dataset(request.getfixturevalue(fixture))
    kw = dict(imgsz=96, mode="train", task=task, kpt_shape=kpt_shape, seed=4)
    ds = YOLODataset(d["train"], device="cpu", hyp=AugmentCfg(flipud=0.5, copy_paste=0.5), **kw)
    ref_ds = JaxDataset(d["train"], cache_labels=False, hyp=JaxAugmentCfg(flipud=0.5, copy_paste=0.5), **kw)
    assert (ds.hyp.fliplr, ds.hyp.flipud) == (ref_ds.hyp.fliplr, ref_ds.hyp.flipud)
    assert (ds.hyp.fliplr == 0.0) == (task == "pose")
    for epoch in (0, 2):
        ds.set_epoch(epoch, close_mosaic_at=1, total_epochs=3)
        ref_ds.set_epoch(epoch, close_mosaic_at=1, total_epochs=3)
        items, refs = [ds[i] for i in (0, 5, 3, 6)], [ref_ds[i] for i in (0, 5, 3, 6)]
        for it, ref in zip(items, refs):
            assert set(it) == set(ref)
            for k in it:
                for a, b in zip(it[k] if isinstance(it[k], list) else [it[k]],
                                ref[k] if isinstance(ref[k], list) else [ref[k]]):
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 if k != "img" else 0, err_msg=k)
        assert ds._rng.bit_generator.state == ref_ds._rng.bit_generator.state
        out = collate(items, max_labels=8, obb=task == "obb")
        ref = jax_collate(refs, max_labels=8, obb=task == "obb")
        assert set(out) == set(ref) - {"txt_feats", "visual_prompts"}
        for k in out:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert out["mask"].sum() > 0


def test_pose_flip_idx_from_the_data_reaches_the_augment(tiny_pose_dataset):
    """With ``flip_idx`` the pose dataset keeps its flips and reorders the
    keypoints on a left-right flip; the label reader is the same."""
    d = check_det_dataset(tiny_pose_dataset)
    ds = YOLODataset(d["train"], imgsz=96, mode="train", task="pose", kpt_shape=(4, 3), device="cpu",
                     flip_idx=[1, 0, 3, 2], hyp=AugmentCfg(fliplr=1.0, mosaic=0.0))
    plain = YOLODataset(d["train"], imgsz=96, mode="train", task="pose", kpt_shape=(4, 3), device="cpu",
                        flip_idx=[0, 1, 2, 3], hyp=AugmentCfg(fliplr=1.0, mosaic=0.0))
    assert ds.hyp.fliplr == 1.0 and ds.flip_idx == [1, 0, 3, 2]
    a, b = ds.get(2, np.random.default_rng(0)), plain.get(2, np.random.default_rng(0))
    np.testing.assert_array_equal(a["img"], b["img"])
    for k, r in zip(a["keypoints"], b["keypoints"]):
        np.testing.assert_array_equal(k, r[[1, 0, 3, 2]])
