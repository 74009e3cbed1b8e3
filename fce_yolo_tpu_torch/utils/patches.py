"""Image writing without cv2 or PIL (reference ``fce_yolo_tpu/utils/patches.py:30``:
``imwrite`` through ``cv2.imencode``).

- ``.jpg`` / ``.jpeg``: ``data/jpeg_write.py``, byte-equal to
  ``cv2.imencode(".jpg", img)``; the forward DCT runs on ``device``.
- ``.png``: 8 bits a sample, colour type 2 (BGR written as RGB) or 0 (gray),
  the Sub filter on every row and a zlib stream of Python's ``zlib`` (level 1,
  a 8 KiB window), as cv2 5.0 writes them. The deflate bytes depend on the
  zlib build, so the file need not equal cv2's; its pixels do.
- Any other suffix raises ``ValueError`` naming the format (the reference
  wrapper returns False).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.jpeg_write import QUALITY, encode_jpeg

__all__ = ["imencode", "imwrite", "encode_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """BGR (H, W, 3) or gray (H, W) uint8 -> PNG bytes (Sub filter, zlib level 1)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) or 0 in img.shape:
        raise ValueError(f"PNG writing takes a non-empty uint8 (H, W) or (H, W, 3) image, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    rows = img.reshape(h, w) if gray else img[..., ::-1].reshape(h, w * 3)
    bpp = 1 if gray else 3
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]  # uint8 arithmetic wraps mod 256, as the filter does
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], 1).tobytes()
    z = zlib.compressobj(1, zlib.DEFLATED, 13)
    data = z.compress(raw) + z.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data) + _chunk(b"IEND", b"")


def imencode(ext: str, img: np.ndarray, quality: int = QUALITY, device="cuda") -> bytes:
    """``cv2.imencode(ext, img)[1]`` for ``.jpg``/``.jpeg`` (``quality``,
    the DCT on ``device``) and ``.png``; raises for any other format."""
    ext = ext.lower() if ext.startswith(".") else f".{ext.lower()}"
    if ext in (".jpg", ".jpeg"):
        return encode_jpeg(img, quality, device)
    if ext == ".png":
        return encode_png(img)
    raise ValueError(f"cannot write {ext!r} images: the port writes JPEG (.jpg, .jpeg) and PNG (.png)")


def imwrite(filename: str | Path, img: np.ndarray, quality: int = QUALITY, device="cuda") -> bool:
    """Write ``img`` (BGR or gray uint8) to ``filename`` in the format its
    suffix names (no suffix: JPEG). Returns True; raises on failure."""
    buf = imencode(Path(filename).suffix or ".jpg", img, quality, device)
    Path(filename).write_bytes(buf)
    return True
