"""The port's train augment (no cv2) against cv2 and the JAX package's
augment, with the same ``np.random.Generator`` state on both sides.

Tolerances: the cv2 stand-ins (``resize_linear``, ``warp_affine``,
``warp_perspective``, ``bgr_to_hsv``, ``hsv_to_bgr``) are held to cv2 pixel
for pixel, except that at most 1e-4 of the pixels of a warp may differ by
one level (the fused multiply-adds are computed in float64 and rounded
once more than OpenCV's; no such pixel was seen). Augmented samples: the
labels equal, the boxes within 1e-3 px, the images within the same bound,
and both generators left in the same state (the same draws, in the same
order). The loader: its batches do not depend on the thread count; each
item equals the JAX dataset's item drawn from the generator the port gives
that item (the JAX loader's threads share one generator instead, so its
batches equal the port's at no thread count: the test states the choice).
"""

import dataclasses

import cv2
import numpy as np
import pytest

from fce_yolo_tpu.data import augment as J
from fce_yolo_tpu.data.dataset import YOLODataset as JaxDataset
from fce_yolo_tpu.data.dataset import collate as jax_collate
from fce_yolo_tpu.data.loader import DataLoader as JaxLoader
from fce_yolo_tpu_torch.data import augment as A
from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset, collate
from fce_yolo_tpu_torch.data.loader import DataLoader
from test_torch_data import png_copy

WARP_MISMATCH = 1e-4  # largest share of pixels a level off (see the module docstring)


@pytest.fixture(scope="module")
def png_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_aug"))


@pytest.fixture(scope="module")
def raw_samples(png_dataset):
    """The train split's images (BGR) with pixel-xyxy labels, 96-160 px."""
    d = check_det_dataset(png_dataset)
    ds = YOLODataset(d["train"], imgsz=64, mode="val", nc=3)
    return [ds.load_raw(i) for i in range(len(ds))]


def assert_images_close(out: np.ndarray, ref: np.ndarray) -> None:
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= WARP_MISMATCH, (d.max(), (d > 0).mean())


def assert_samples_match(out: dict, ref: dict) -> None:
    assert_images_close(out["img"], ref["img"])
    np.testing.assert_array_equal(out["cls"], ref["cls"])
    assert out["bboxes"].shape == ref["bboxes"].shape
    np.testing.assert_allclose(out["bboxes"], ref["bboxes"], rtol=0, atol=1e-3)


def fresh(samples):
    return [{k: v.copy() for k, v in s.items()} for s in samples]


# ------------------------------------------------------------ cv2 stand-ins
@pytest.mark.parametrize("src,dst", [((600, 800), (480, 640)), ((123, 97), (160, 126)), ((700, 500), (640, 457)),
                                     ((55, 77), (33, 45)), ((160, 120), (640, 480)), ((96, 150), (64, 100)),
                                     ((1, 9), (3, 4)), ((31, 64), (31, 32))])
def test_resize_linear_matches_cv2(src, dst):
    img = np.random.RandomState(src[0]).randint(0, 256, src + (3,), np.uint8)
    img[: src[0] // 2, : src[1] // 3] = (10, 200, 30)  # a flat patch beside the noise
    out = A.resize_linear(img, (dst[1], dst[0]))
    np.testing.assert_array_equal(out, cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR))


def _matrix(rng: np.random.RandomState, size: int, perspective: float) -> np.ndarray:
    """random_perspective's M = T @ S @ R @ P @ C with wide parameter ranges."""
    C = np.eye(3, dtype=np.float32)
    C[0, 2] = C[1, 2] = -size / 2
    P = np.eye(3, dtype=np.float32)
    P[2, :2] = rng.uniform(-perspective, perspective, 2)
    R = np.eye(3, dtype=np.float32)
    R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-30, 30), center=(0, 0), scale=rng.uniform(0.5, 1.5))
    S = np.eye(3, dtype=np.float32)
    S[0, 1], S[1, 0] = np.tan(np.deg2rad(rng.uniform(-10, 10, 2)))
    T = np.eye(3, dtype=np.float32)
    T[:2, 2] = rng.uniform(0.4, 0.6, 2) * size / 2
    return T @ S @ R @ P @ C


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("perspective", [0.0, 5e-4])
def test_warps_match_cv2(seed, perspective):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (320, 320, 3), np.uint8)
    img[40:200, 60:250] = (80, 80, 255)
    M = _matrix(rng, 320, perspective)
    if perspective:
        ref = cv2.warpPerspective(img, M, dsize=(160, 160), borderValue=(114, 114, 114))
        out = A.warp_perspective(img, M, (160, 160))
    else:
        ref = cv2.warpAffine(img, M[:2], dsize=(160, 160), borderValue=(114, 114, 114))
        out = A.warp_affine(img, M[:2], (160, 160))
    assert_images_close(out, ref)
    np.testing.assert_allclose(A.get_rotation_matrix_2d(12.5, (3.0, -4.0), 0.8),
                               cv2.getRotationMatrix2D((3.0, -4.0), 12.5, 0.8), rtol=0, atol=1e-12)


def test_hsv_conversions_match_cv2_on_every_colour():
    """All 2^24 BGR colours forward; all 180 x 256 x 256 HSV values back."""
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    bgr = np.stack([b, g, r], -1).astype(np.uint8).reshape(-1, 256, 3)
    np.testing.assert_array_equal(A.bgr_to_hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = bgr[: 180 * 256]
    np.testing.assert_array_equal(A.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


# ------------------------------------------------------- augments vs the JAX package
CFGS = {
    "default": {},
    "geometry": dict(degrees=10.0, shear=5.0, perspective=4e-4, flipud=0.5, scale=0.6, translate=0.2),
    "mix": dict(mosaic9=0.5, mixup=0.7, cutmix=0.7),
    "no-mosaic": dict(mosaic=0.0, hsv_h=0.1),
}


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("seed", range(3))
def test_train_augment_matches_jax(raw_samples, name, seed):
    kw = CFGS[name]
    cfg, jcfg = A.AugmentCfg(**kw), J.AugmentCfg(**kw)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    n = len(raw_samples)
    for index in range(3):
        out = A.train_augment(lambda i: fresh(raw_samples)[i], index, n, 96, cfg, rng)
        ref = J.train_augment(lambda i: fresh(raw_samples)[i], index, n, 96, jcfg, jrng)
        assert_samples_match(out, ref)
    assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("seed", range(3))
def test_augment_functions_match_jax(raw_samples, seed):
    cfg = A.AugmentCfg(degrees=15.0, shear=3.0, flipud=0.5, fliplr=0.5)
    jcfg = J.AugmentCfg(**dataclasses.asdict(cfg))
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for fn, jfn in ((A.mosaic4, J.mosaic4), (A.mosaic9, J.mosaic9)):
        out, ref = fn(fresh(raw_samples) * 2, 80, rng), jfn(fresh(raw_samples) * 2, 80, jrng)
        assert_samples_match(out, ref)
        assert_samples_match(A.random_perspective(out, rng, cfg, border=(-40, -40)),
                             J.random_perspective(ref, jrng, jcfg, border=(-40, -40)))
    a, b = fresh(raw_samples[:2])
    assert_samples_match(A.random_perspective(a, rng, cfg, pre_letterbox=96),
                         J.random_perspective(fresh([a])[0], jrng, jcfg, pre_letterbox=96))
    lb_a = A.random_perspective(a, rng, A.AugmentCfg(), pre_letterbox=96)
    lb_b = A.random_perspective(b, rng, A.AugmentCfg(), pre_letterbox=96)
    jlb_a = J.random_perspective(fresh([a])[0], jrng, J.AugmentCfg(), pre_letterbox=96)
    jlb_b = J.random_perspective(fresh([b])[0], jrng, J.AugmentCfg(), pre_letterbox=96)
    assert_samples_match(A.mixup(lb_a, lb_b, rng), J.mixup(jlb_a, jlb_b, jrng))
    assert_samples_match(A.cutmix(lb_a, raw_samples[2], rng), J.cutmix(jlb_a, raw_samples[2], jrng))
    np.testing.assert_array_equal(A.random_hsv(lb_a["img"], rng, cfg), J.random_hsv(jlb_a["img"], jrng, jcfg))
    assert_samples_match(A.random_flip(lb_b, rng, cfg), J.random_flip(jlb_b, jrng, jcfg))
    assert rng.bit_generator.state == jrng.bit_generator.state
    before, after = rng.uniform(0, 50, (2, 64, 4)).astype(np.float32)
    before[:, 2:] += 10
    after[:, 2:] = after[:, :2] + rng.uniform(0, 30, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(A.box_candidates(before, after), J.box_candidates(before, after))


# ------------------------------------------------ polygons and keypoints vs the JAX package
TASKS = {"segment": ("tiny_seg_dataset", (17, 3)), "pose": ("tiny_pose_dataset", (4, 3)),
         "obb": ("tiny_obb_dataset", (17, 3))}


@pytest.fixture(scope="module")
def task_samples(request):
    """Each tiny task dataset's train images (BGR, 128 px) with pixel labels:
    polygons (segment), 4 keypoints (pose) or four corners (OBB)."""
    done = {}

    def get(task: str) -> list[dict]:
        if task not in done:
            fixture, kpt_shape = TASKS[task]
            d = check_det_dataset(request.getfixturevalue(fixture))
            ds = YOLODataset(d["train"], imgsz=96, mode="val", task=task, kpt_shape=kpt_shape, device="cpu")
            done[task] = [ds.load_raw(i) for i in range(len(ds))]
        return done[task]

    return get


def fresh_task(samples):
    return [{k: ([x.copy() for x in v] if isinstance(v, list) else v.copy()) for k, v in s.items()} for s in samples]


def assert_task_samples_match(out: dict, ref: dict) -> None:
    """Images bit-equal, classes equal, boxes, polygons and keypoints within 1e-5 px."""
    assert set(out) == set(ref), (set(out), set(ref))
    np.testing.assert_array_equal(out["img"], ref["img"])
    np.testing.assert_array_equal(out["cls"], ref["cls"])
    assert out["bboxes"].shape == ref["bboxes"].shape
    np.testing.assert_allclose(out["bboxes"], ref["bboxes"], rtol=0, atol=1e-5)
    for k in ("segments", "keypoints"):
        assert len(out.get(k, [])) == len(ref.get(k, [])) == (len(out["cls"]) if k in out else 0)
        for a, b in zip(out.get(k, []), ref.get(k, [])):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("task", sorted(TASKS))
@pytest.mark.parametrize("seed", range(2))
def test_task_augment_functions_match_jax(task_samples, task, seed):
    """``random_perspective`` (letterboxed and after a mosaic), ``mosaic4``,
    ``mosaic9``, ``random_flip`` (the identity ``flip_idx`` for the port:
    the JAX package takes none) and ``copy_paste`` on the task's samples,
    one generator state on both sides."""
    samples = task_samples(task)
    cfg = A.AugmentCfg(degrees=15.0, shear=3.0, perspective=2e-4, flipud=0.5, fliplr=0.5)
    jcfg = J.AugmentCfg(**dataclasses.asdict(cfg))
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for fn, jfn in ((A.mosaic4, J.mosaic4), (A.mosaic9, J.mosaic9)):
        out, ref = fn(fresh_task(samples) * 2, 80, rng), jfn(fresh_task(samples) * 2, 80, jrng)
        assert_task_samples_match(out, ref)
        assert_task_samples_match(A.random_perspective(out, rng, cfg, border=(-40, -40)),
                                  J.random_perspective(ref, jrng, jcfg, border=(-40, -40)))
    a, b = fresh_task(samples[:2])
    lb_a = A.random_perspective(a, rng, cfg, pre_letterbox=96)
    jlb_a = J.random_perspective(fresh_task([a])[0], jrng, jcfg, pre_letterbox=96)
    assert_task_samples_match(lb_a, jlb_a)
    lb_b = A.random_perspective(b, rng, A.AugmentCfg(), pre_letterbox=96)
    jlb_b = J.random_perspective(fresh_task([b])[0], jrng, J.AugmentCfg(), pre_letterbox=96)
    nk = TASKS[task][1][0]
    for _ in range(3):
        assert_task_samples_match(A.random_flip(lb_b, rng, cfg, flip_idx=list(range(nk))),
                                  J.random_flip(jlb_b, jrng, jcfg))
    pasted = A.copy_paste(lb_a, lb_b, rng, p=1.0)
    assert_task_samples_match(pasted, J.copy_paste(jlb_a, jlb_b, jrng, p=1.0))
    if task != "pose":  # the donor's polygons were pasted
        assert len(pasted["cls"]) > len(lb_a["cls"])
    assert rng.bit_generator.state == jrng.bit_generator.state


TASK_CFGS = {
    "default": {},
    "copy-paste": dict(copy_paste=0.9, degrees=10.0, flipud=0.5),
    "mosaic9-letterbox": dict(mosaic=0.5, mosaic9=0.6, shear=4.0, perspective=3e-4),
}


@pytest.mark.parametrize("name", list(TASK_CFGS))
@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_train_augment_and_collate_match_jax(task_samples, task, name):
    """The whole ``train_augment`` on each task's samples (copy_paste on
    segment and OBB; on pose it draws nothing, the donor having no
    polygons), then ``collate``: the same masks, keypoints and rotated boxes."""
    samples = task_samples(task)
    kw = TASK_CFGS[name]
    cfg, jcfg = A.AugmentCfg(**kw), J.AugmentCfg(**kw)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    n = len(samples)
    outs, refs = [], []
    for index in range(4):
        outs.append(A.train_augment(lambda i: fresh_task(samples)[i], index, n, 96, cfg, rng))
        refs.append(J.train_augment(lambda i: fresh_task(samples)[i], index, n, 96, jcfg, jrng))
        assert_task_samples_match(outs[-1], refs[-1])
    assert rng.bit_generator.state == jrng.bit_generator.state
    assert sum(len(o["cls"]) for o in outs) > 0
    obb = task == "obb"
    out = collate([dict(o, img=o["img"][..., ::-1]) for o in outs], max_labels=8, obb=obb)
    ref = jax_collate([dict(r, img=r["img"][..., ::-1]) for r in refs], max_labels=8, obb=obb)
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert {"segment": "masks", "pose": "keypoints", "obb": "bboxes"}[task] in out
    if obb:
        assert out["bboxes"].shape[-1] == 5


def test_flip_idx_reorders_keypoints_where_jax_does_not(task_samples):
    """A left-right flip with a non-symmetric ``flip_idx`` reorders each
    keypoint array; the JAX ``random_flip`` (``fce_yolo_tpu/data/augment.py:318-319``)
    mirrors x and keeps the order, so its left keypoints land on the right.
    Up-down flips and ``flip_idx=None`` reorder nothing."""
    sample = A.random_perspective(fresh_task(task_samples("pose")[:1])[0], np.random.default_rng(0), A.AugmentCfg(),
                                  pre_letterbox=96)
    flip_idx = [1, 0, 3, 2]
    lr = A.AugmentCfg(fliplr=1.0)
    out = A.random_flip(sample, np.random.default_rng(0), lr, flip_idx=flip_idx)
    ref = J.random_flip(sample, np.random.default_rng(0), J.AugmentCfg(fliplr=1.0))
    for k, r, s in zip(out["keypoints"], ref["keypoints"], sample["keypoints"]):
        np.testing.assert_array_equal(k, r[flip_idx])
        np.testing.assert_array_equal(k[:, 0], 96 - s[flip_idx, 0])
        assert not np.array_equal(k, r)
    np.testing.assert_array_equal(out["img"], ref["img"])
    ud = A.random_flip(sample, np.random.default_rng(0), A.AugmentCfg(fliplr=0.0, flipud=1.0), flip_idx=flip_idx)
    jud = J.random_flip(sample, np.random.default_rng(0), J.AugmentCfg(fliplr=0.0, flipud=1.0))
    for k, r in zip(ud["keypoints"], jud["keypoints"]):
        np.testing.assert_array_equal(k, r)
    for k, r in zip(A.random_flip(sample, np.random.default_rng(0), lr)["keypoints"], ref["keypoints"]):
        np.testing.assert_array_equal(k, r)


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_mixup_and_cutmix_keep_polygons_and_keypoints_where_jax_drops_them(task_samples, task):
    """``mixup`` joins both samples' polygons or keypoints and ``cutmix``
    keeps the donor's for the instances it keeps, scaled as their boxes; the
    JAX ``mixup``/``cutmix`` (``fce_yolo_tpu/data/augment.py:328-366``) return
    boxes only. Images, classes and boxes equal to JAX's."""
    key = "segments" if task == "segment" else "keypoints"
    samples = fresh_task(task_samples(task)[:3])
    rng0 = np.random.default_rng(1)
    a, b = (A.random_perspective(s, rng0, A.AugmentCfg(), pre_letterbox=96) for s in samples[:2])
    donor = samples[2]  # 128 px: cutmix scales it to 96
    mixed = A.mixup(a, b, np.random.default_rng(2))
    jmixed = J.mixup(a, b, np.random.default_rng(2))
    assert key not in jmixed
    np.testing.assert_array_equal(mixed["img"], jmixed["img"])
    np.testing.assert_array_equal(mixed["bboxes"], jmixed["bboxes"])
    assert len(mixed[key]) == len(mixed["cls"]) == len(a["cls"]) + len(b["cls"])
    for x, y in zip(mixed[key], a[key] + b[key]):
        np.testing.assert_array_equal(x, y)
    for seed in range(40):  # a draw whose window keeps a donor instance
        cut, jcut = A.cutmix(a, donor, np.random.default_rng(seed)), J.cutmix(a, donor, np.random.default_rng(seed))
        if len(cut["cls"]) > len(a["cls"]):
            break
    assert len(cut["cls"]) > len(a["cls"]) and key not in jcut
    np.testing.assert_array_equal(cut["img"], jcut["img"])
    np.testing.assert_allclose(cut["bboxes"], jcut["bboxes"], rtol=0, atol=1e-5)
    assert len(cut[key]) == len(cut["cls"])
    scale = np.array([96 / 128, 96 / 128] + ([1] if key == "keypoints" else []), np.float32)
    for x, y in zip(cut[key][len(a["cls"]):], donor[key]):
        np.testing.assert_allclose(x, y * scale, rtol=0, atol=1e-5)
    batch = collate([cut], max_labels=8)
    assert (batch["masks"].sum((2, 3)) > 0).sum() == len(cut["cls"]) if task == "segment" else \
        (batch["keypoints"][0, : len(cut["cls"]), :, 2] > 0).any(1).all()


# ------------------------------------------------------- dataset and loader
def test_train_dataset_matches_jax(png_dataset):
    """The dataset's own generator after ``set_epoch``: the same items, the
    same reseed, mosaic closing, BGR augment then RGB at the exit."""
    d = check_det_dataset(png_dataset)
    ds = YOLODataset(d["train"], imgsz=96, mode="train", nc=3, seed=5)
    jds = JaxDataset(d["train"], imgsz=96, mode="train", nc=3, seed=5, cache_labels=False)
    for epoch in (0, 3):
        ds.set_epoch(epoch, close_mosaic_at=1, total_epochs=4)
        jds.set_epoch(epoch, close_mosaic_at=1, total_epochs=4)
        assert ds.mosaic_enabled == jds.mosaic_enabled == (epoch < 3)
        for i in (0, 5, 2):
            assert_samples_match(ds[i], jds[i])
        assert ds._rng.bit_generator.state == jds._rng.bit_generator.state


def test_train_loader_batches(png_dataset):
    """Shuffle and drop_last as the JAX loader; the batches are the same for
    1 and 3 threads; item j of the epoch is the JAX dataset's item drawn
    from ``default_rng([epoch_seed, j])``; labels padded to max_labels."""
    d = check_det_dataset(png_dataset)
    jds = JaxDataset(d["train"], imgsz=64, mode="train", nc=3, cache_labels=False)
    jloader = JaxLoader(jds, batch_size=3, workers=1, max_labels=16, seed=7)
    runs = []
    for workers in (1, 3):
        loader = DataLoader(YOLODataset(d["train"], imgsz=64, mode="train", nc=3), batch_size=3, workers=workers,
                            max_labels=16, seed=7)
        loader.set_epoch(2, close_mosaic_at=0, total_epochs=5)
        assert loader.dataset.epoch_seed == hash((2, 8)) & 0x7FFFFFFF
        runs.append(list(loader))
    jloader.set_epoch(2, close_mosaic_at=0, total_epochs=5)
    order = np.concatenate(jloader._batch_indices())
    assert len(runs[0]) == len(jloader) == 2  # 8 images, batch 3: the last 2 dropped
    for b1, b3 in zip(*runs):
        for k in ("img", "cls", "bboxes", "mask"):
            np.testing.assert_array_equal(b1[k], b3[k])
    for bi, batch in enumerate(runs[0]):
        assert batch["img"].shape == (3, 64, 64, 3) and batch["cls"].shape == (3, 16) and batch["n_valid"] == 3
        for k in range(3):
            j = bi * 3 + k
            jds._rng = np.random.default_rng([hash((2, len(jds))) & 0x7FFFFFFF, j])
            ref = jds[int(order[j])]
            assert_images_close(batch["img"][k], ref["img"])
            n = len(ref["cls"])
            np.testing.assert_array_equal(batch["cls"][k, :n], ref["cls"])
            assert batch["mask"][k].sum() == n
