"""The port's image writing (``data/jpeg_write.py``, ``utils/patches.py``)
against cv2 5.0, whose ``imencode`` the JAX package's ``imwrite`` calls.

Tolerance: none. The plain JPEG writer's bytes equal ``cv2.imencode(".jpg",
img, [IMWRITE_JPEG_QUALITY, q])`` on every case (sizes 1x1 to 721x1281,
colour and gray, qualities 50, 75 and 95, flat, noise and drawn-edge
images); the port's own decoder reads them byte-equal to ``cv2.imdecode``;
a PNG decodes through ``cv2.imdecode`` to the image exactly (its deflate
bytes depend on the zlib build, so they are not compared); any other format
raises. The card path (``jpeg_fdct_kernel`` + ``fce_jpeg_entropy``) is held
against these plain versions in ``test_torch_jpeg_emulated.py`` (on the
CPU), ``test_torch_cuda.py`` and ``chip_smoke.py`` (on the card).
"""

import cv2
import numpy as np
import pytest
import torch

from fce_yolo_tpu_torch.data import jpeg as J
from fce_yolo_tpu_torch.data import jpeg_write as JW
from fce_yolo_tpu_torch.utils.patches import encode_png, imencode, imwrite

SIZES = [(1, 1), (8, 8), (16, 16), (37, 53), (480, 640), (721, 1281)]


def image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A BGR test image: one flat colour, noise, or lines and a filled shape on a ramp."""
    rng = np.random.RandomState(seed + h * 7 + w)
    if kind == "flat":
        return np.full((h, w, 3), rng.randint(0, 256, 3), np.uint8)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) % 256], 2).astype(np.uint8)
    cv2.rectangle(img, (w // 4, h // 4), (w // 2, h // 2), (20, 200, 90), -1)
    cv2.line(img, (0, h - 1), (w - 1, 0), (255, 255, 255), 3)
    cv2.circle(img, (w // 2, h // 2), max(min(h, w) // 5, 1), (0, 0, 255), 2)
    return img


def cv2_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


@pytest.mark.parametrize("kind", ["flat", "noise", "edges"])
@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_bytes_equal_cv2(h, w, kind):
    img = image(kind, h, w)
    assert JW.encode_jpeg_reference(img) == cv2_jpeg(img)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("h,w", [(37, 53), (17, 9), (120, 160)])
@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_qualities_and_gray(h, w, quality, gray):
    img = image("edges", h, w, seed=quality)
    img = img + np.random.RandomState(quality).randint(0, 9, img.shape).astype(np.uint8)  # some AC everywhere
    if gray:
        img = img[..., 1].copy()
    assert JW.encode_jpeg_reference(img, quality) == cv2_jpeg(img, quality)


def test_jpeg_markers_are_cv2s():
    """cv2's defaults: APP0 JFIF, a DQT a table, SOF0 4:2:0, four DHT, SOS, EOI; gray one component."""
    buf = JW.encode_jpeg_reference(image("noise", 37, 53))
    markers = [buf[i + 1] for i in range(len(buf) - 1) if buf[i] == 0xFF and buf[i + 1] not in (0, 0xFF)]
    assert markers == [0xD8, 0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA, 0xD9]
    sof = buf.index(b"\xff\xc0")
    assert buf[sof + 10: sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    gray = JW.encode_jpeg_reference(image("noise", 37, 53)[..., 0].copy())
    assert gray.count(b"\xff\xdb") == 1 and gray.count(b"\xff\xc4") == 2


@pytest.mark.parametrize("h,w", [(37, 53), (480, 640)])
def test_port_decoder_reads_port_jpegs_as_cv2(h, w):
    for img in (image("edges", h, w), image("noise", h, w)[..., 2].copy()):
        buf = JW.encode_jpeg_reference(img)
        np.testing.assert_array_equal(J.decode_jpeg_reference(buf), cv2.imdecode(np.frombuffer(buf, np.uint8),
                                                                                 cv2.IMREAD_COLOR))


def test_fdct_wrapper_on_cpu_tensors_is_the_plain_version():
    """A CPU tensor takes ``jpeg_fdct_reference`` (the layout the decoder
    reads: every component's MCU-padded grid of natural-order blocks) and
    counts no launch."""
    img = image("noise", 33, 47)
    before = JW.jpeg_fdct.launches
    coef = JW.jpeg_fdct(torch.from_numpy(img))
    assert JW.jpeg_fdct.launches == before
    np.testing.assert_array_equal(coef.numpy(), JW.jpeg_fdct_reference(img))
    assert coef.numel() == sum(bh * bw * 64 for bh, bw in JW.plane_grids(33, 47, False)) == (6 * 6 + 2 * 3 * 3) * 64
    hdr = J.parse_jpeg(JW.encode_jpeg_reference(img))
    planes = J.entropy_decode(hdr)
    np.testing.assert_array_equal(coef.numpy(), np.concatenate([p.ravel() for p in planes]))


def test_quant_tables_are_libjpegs():
    """jpeg_set_quality's scaling of the Annex K tables, as cv2's DQT segments carry them."""
    for q in (1, 10, 50, 75, 95, 100):
        buf = cv2_jpeg(image("noise", 16, 16), q)
        i = buf.index(b"\xff\xdb")
        dqt0 = np.frombuffer(buf[i + 5: i + 69], np.uint8)
        np.testing.assert_array_equal(JW.quant_tables(q)[0][J.ZIGZAG[:64]], dqt0)


@pytest.mark.parametrize("h,w", [(1, 1), (37, 53), (200, 301)])
@pytest.mark.parametrize("gray", [False, True])
def test_png_round_trips_through_cv2(h, w, gray, tmp_path):
    img = image("noise", h, w)
    if gray:
        img = img[..., 0].copy()
    buf = encode_png(img)
    assert buf[:8] == b"\x89PNG\r\n\x1a\n" and buf[12:16] == b"IHDR" and buf[25] == (0 if gray else 2)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED), img)
    assert imwrite(tmp_path / "a.png", img, device="cpu") is True
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED), img)


def test_imwrite_formats(tmp_path):
    img = image("edges", 40, 60)
    for name in ("a.jpg", "b.JPEG", "c"):
        assert imwrite(tmp_path / name, img, device="cpu")
        assert (tmp_path / name).read_bytes() == cv2_jpeg(img)
    assert imwrite(tmp_path / "q.jpg", img, quality=60, device="cpu")
    assert (tmp_path / "q.jpg").read_bytes() == cv2_jpeg(img, 60)
    assert imencode(".png", img) == encode_png(img)
    for bad in ("x.bmp", "x.webp", "x.tif"):
        with pytest.raises(ValueError, match="cannot write"):
            imwrite(tmp_path / bad, img, device="cpu")
        assert not (tmp_path / bad).exists()
    with pytest.raises(ValueError, match="uint8"):
        imwrite(tmp_path / "f.jpg", img.astype(np.float32), device="cpu")
