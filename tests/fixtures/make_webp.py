"""Write the committed WebP fixtures: ``tests/fixtures/webp/*.webp`` (made by
the libwebp that PIL and cv2 carry) and ``tests/fixtures/webp/decodes.json``
(each file's ``cv2.imdecode(..., IMREAD_COLOR)``: its shape and the SHA-256
of its bytes). ``chip_smoke.py`` reads them on the card, whose machine has no
cv2, no PIL and no WebP encoder, and holds the port's decodes to those
hashes; nothing else regenerates them.

The files: lossy at qualities 5-100 and methods 0-6 (one at 480 x 640),
lossless at several methods and qualities (predictor, cross-colour and
subtract-green transforms, the colour cache, meta prefix codes, a 480 x 640
one) and with 3 and 16 colours (colour-indexing with pixel bundling), lossy
with a compressed and filtered ALPH chunk and with a raw one, EXIF
orientation 6, lossy and lossless animations (cv2 reads the first frame),
a cv2-written file, sizes from 37 x 53 up; and ``val_000``-``val_015``: the
first 16 of ``chip_smoke.val_images()`` as lossy WebP, which the card
validates against the same images as arrays.

    python tests/fixtures/make_webp.py   (from the repo root; needs cv2 and PIL)
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402  (the card script's images)

OUT = REPO / "tests" / "fixtures" / "webp"
SEED = 18
VAL = 16  # chip_smoke's val images written as WebP


def _pil(rgb: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "WEBP", **kw)
    return b.getvalue()


def _animation(frames: list[np.ndarray], **kw) -> bytes:
    b = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(b, "WEBP", save_all=True, append_images=ims[1:], duration=80, **kw)
    return b.getvalue()


def fixtures() -> dict[str, bytes]:
    rng = np.random.RandomState(SEED)

    def img(h: int, w: int) -> np.ndarray:
        return C.jpeg_test_image(rng, h, w)

    def rgba(h: int, w: int) -> np.ndarray:
        a = np.concatenate([img(h, w), np.zeros((h, w, 1), np.uint8)], axis=2)
        yy, xx = np.mgrid[:h, :w]
        a[..., 3] = np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (min(h, w) / 2.5) ** 2, 255, (xx * 4) % 256)
        return a

    files = {
        "lossy_q75_m4_480x640": _pil(img(480, 640), quality=75, method=4),
        "lossy_q5_m0_37x53": _pil(img(37, 53), quality=5, method=0),
        "lossy_q50_m2_64x96": _pil(img(64, 96), quality=50, method=2),
        "lossy_q90_m6_97x131": _pil(img(97, 131), quality=90, method=6),
        "lossy_q100_m3_53x37": _pil(img(53, 37), quality=100, method=3),
        "lossless_m0_q0_37x53": _pil(img(37, 53), lossless=True, method=0, quality=0),
        "lossless_m4_q75_96x128": _pil(img(96, 128), lossless=True, method=4, quality=75),
        "lossless_m6_q100_120x160": _pil(img(120, 160), lossless=True, method=6, quality=100),
        "lossless_m2_q50_480x640": _pil(img(480, 640) // 8 * 8, lossless=True, method=2, quality=50),
        "lossless_16colours_61x67": _pil(img(61, 67) // 64 * 85 // 2 * 2, lossless=True),
        "lossless_3colours_45x50": _pil(np.array([[20, 40, 60], [200, 10, 90], [5, 250, 130]], np.uint8)[
            rng.randint(0, 3, (45, 50))], lossless=True),
        "alpha_q70_aq50_65x77": _pil(rgba(65, 77), quality=70, alpha_quality=50),
        "alpha_raw_q60_40x52": _pil(rgba(40, 52), quality=60, alpha_method=0),
        "anim_lossy_48x64": _animation([img(48, 64) for _ in range(3)], quality=80),
        "anim_lossless_40x56": _animation([img(40, 56) for _ in range(2)], lossless=True),
        "cv2_q60_71x93": cv2.imencode(".webp", img(71, 93), [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes(),
    }
    exif = Image.Exif()
    exif[0x0112] = 6
    files["exif6_lossy_40x60"] = _pil(img(40, 60), quality=80, exif=exif)
    files["exif6_lossless_30x44"] = _pil(img(30, 44), lossless=True, exif=exif)
    for i, rgb, _ in C.val_images():
        if i >= VAL:
            break
        files[f"val_{i:03d}"] = _pil(rgb, quality=90, method=4)
    return files


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.glob("*.webp"):
        old.unlink()
    decodes = {}
    for name, buf in fixtures().items():
        path = OUT / f"{name}.webp"
        path.write_bytes(buf)
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        assert ref is not None and ref.dtype == np.uint8, name
        decodes[path.name] = {"shape": list(ref.shape), "sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
                              "bytes": len(buf)}
    (OUT / "decodes.json").write_text(json.dumps(decodes, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(decodes)} files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
