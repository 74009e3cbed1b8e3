"""Image reading without cv2 or PIL (counterpart of ``fce_yolo_tpu/utils/patches.py:18``
``imread``, which calls ``cv2.imdecode(..., IMREAD_COLOR)``).

``imread`` picks the decoder by the file's leading bytes, never by its
suffix, as ``cv2.imdecode`` does (a PNG named ``.jpg`` reads as PNG), and
returns BGR uint8 (H, W, 3) bit-equal to cv2's:

- JPEG (``FF D8 FF``; MPO files are JPEGs), baseline or progressive:
  ``data/jpeg.py``, on ``device``: the card's kernels for ``"cuda"`` (the
  default), the plain version for ``"cpu"``;
- PNG, every colour type and bit depth, Adam7 too: ``data/png.py``;
- BMP: ``data/bmp.py``;
- TIFF (and DNG, whose first image is read): ``data/tiff.py``, whose LZW and
  PackBits decode as host C++ for ``"cuda"`` and in Python for ``"cpu"``;
- PFM: ``data/pfm.py`` (a gray file gives three equal channels where cv2
  gives a 2-D array);
- WebP (lossless VP8L, lossy VP8 with or without alpha, extended VP8X, an
  animation's first frame): ``data/webp.py``, on ``device``: host C++ and,
  for a lossy frame, the card's colour kernel for ``"cuda"``, the plain
  version for ``"cpu"``;
- ``.npy`` arrays already in that layout (the JAX package's disk cache).

PNG, BMP, PFM and ``.npy`` are read on the host whatever ``device`` says.
Anything else raises, naming what it is: the JPEG and TIFF variants the
readers name, other formats. A file that cannot be read raises too; no
blank image stands in for it.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.bmp import BMP_SIGNATURE, decode_bmp
from fce_yolo_tpu_torch.data.jpeg import JPEG_SIGNATURE, decode_jpeg
from fce_yolo_tpu_torch.data.pfm import PFM_SIGNATURES, decode_pfm
from fce_yolo_tpu_torch.data.png import PNG_SIGNATURE, decode_png
from fce_yolo_tpu_torch.data.tiff import TIFF_SIGNATURES, decode_tiff
from fce_yolo_tpu_torch.data.webp import WEBP_SIGNATURE, decode_webp

__all__ = ["imread", "decode_png", "READ_FORMATS"]

READ_FORMATS = ("JPEG (baseline or progressive, 8-bit, 1 or 3 components; MPO)",
                "PNG (every colour type and bit depth, interlaced or not)",
                "BMP (1/4/8-bit palette, RLE4/RLE8, 16/24/32-bit)",
                "TIFF (no, LZW, Deflate or PackBits compression; gray, RGB(A) and palette; DNG's first image)",
                "PFM", "WebP (lossless, lossy, with alpha, extended; an animation's first frame)",
                ".npy (H, W, 3) uint8 BGR")
_NPY_MAGIC = b"\x93NUMPY"


def _unsupported(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}; this reader takes only {', '.join(READ_FORMATS)}")


def imread(filename: str | Path, device="cuda") -> np.ndarray:
    """Read an image file as BGR uint8 (H, W, 3); raise if it cannot be
    read. A JPEG or a WebP decodes on ``device`` (``data/jpeg.py::decode_jpeg``,
    ``data/webp.py::decode_webp``), a TIFF's LZW or PackBits data as host
    C++ unless ``device`` is the CPU."""
    name = str(filename)
    buf = Path(filename).read_bytes()
    if buf.startswith(JPEG_SIGNATURE):
        return decode_jpeg(buf, name, device)
    if buf.startswith(PNG_SIGNATURE):
        return decode_png(buf, name)
    if buf.startswith(BMP_SIGNATURE):
        return decode_bmp(buf, name)
    if buf[:4] in TIFF_SIGNATURES:
        return decode_tiff(buf, name, device)
    if buf[:3] in PFM_SIGNATURES:
        return decode_pfm(buf, name)
    if buf.startswith(_NPY_MAGIC):
        img = np.load(io.BytesIO(buf), allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise _unsupported(name, f"a {img.dtype} array of shape {img.shape}")
        return img
    if buf[:4] == WEBP_SIGNATURE[0] and buf[8:12] == WEBP_SIGNATURE[1]:
        return decode_webp(buf, name, device)
    raise _unsupported(name, "not a file of any of these formats")
