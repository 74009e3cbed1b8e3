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
from fce_yolo_tpu.data.loader import DataLoader as JaxLoader
from fce_yolo_tpu_torch.data import augment as A
from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
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


def test_copy_paste_is_not_ported(raw_samples):
    with pytest.raises(NotImplementedError, match="copy_paste"):
        A.train_augment(lambda i: raw_samples[i], 0, 8, 64, A.AugmentCfg(copy_paste=0.5), np.random.default_rng(0))


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
