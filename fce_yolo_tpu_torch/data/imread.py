"""Image reading without cv2 or PIL (counterpart of ``fce_yolo_tpu/utils/patches.py:18``
``imread``, which calls ``cv2.imdecode(..., IMREAD_COLOR)``).

Returns BGR uint8 (H, W, 3) as ``cv2.imread`` does, bit for bit, for:

- baseline JPEG (bytes starting ``FF D8 FF``), decoded by ``data/jpeg.py``
  on ``device``: the card's kernels for ``"cuda"`` (the default), the plain
  version for ``"cpu"``; progressive, arithmetic, 12-bit, lossless,
  hierarchical and CMYK JPEG raise;
- PNG, 8 bits a sample, not interlaced: gray, gray+alpha, RGB, RGBA and
  palette. Alpha is dropped (not blended) and gray is copied into all three
  channels, as libpng does for OpenCV's colour read. Decoded with the stdlib
  ``zlib`` and numpy.
- ``.npy`` arrays already in that layout (the JAX package's disk cache).

Anything else raises, naming what is read: the other formats, interlaced
and 16-bit PNG. PNG and ``.npy`` are read on the host whatever ``device``
says. A file that cannot be read raises too; no blank
image stands in for it.

PNG row filters: None, Sub and Up rows are undone row-vectorised (Sub as a
cumulative sum mod 256 over a row's pixels, runs of Up rows as one over the
rows). Average and Paeth are serial along a row and down the columns, since
each byte needs its left, upper and upper-left neighbours decoded. An image
with such rows is undone on anti-diagonals instead: pixel (r, x) is decoded
at step r + x, all rows at once, so W + H - 1 numpy steps replace a Python
loop over every byte. Those steps are ~25 numpy calls each on a few
thousand bytes, and each call gives up the interpreter lock: several
reader threads doing them at once queue on the lock at every call and run
several times slower together than one alone, so one thread at a time takes
this loop (the rest of a read, zlib and the letterbox, still overlaps).
"""

from __future__ import annotations

import io
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.jpeg import JPEG_SIGNATURE, decode_jpeg

__all__ = ["imread", "decode_png", "READ_FORMATS"]

READ_FORMATS = ("baseline JPEG (8-bit, 1 or 3 components)",
                "PNG (8-bit gray, gray+alpha, RGB, RGBA or palette; not interlaced)", ".npy (H, W, 3) uint8 BGR")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_NPY_MAGIC = b"\x93NUMPY"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_DIAGONAL_LOCK = threading.Lock()  # one anti-diagonal unfilter at a time (see the module docstring)


def _unsupported(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}; this reader takes only {' and '.join(READ_FORMATS)}")


def imread(filename: str | Path, device="cuda") -> np.ndarray:
    """Read an image file as BGR uint8 (H, W, 3); raise if it cannot be
    read. A JPEG decodes on ``device`` (``data/jpeg.py::decode_jpeg``)."""
    name = str(filename)
    buf = Path(filename).read_bytes()
    if buf.startswith(JPEG_SIGNATURE):
        return decode_jpeg(buf, name, device)
    if buf.startswith(_NPY_MAGIC):
        img = np.load(io.BytesIO(buf), allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise _unsupported(name, f"a {img.dtype} array of shape {img.shape}")
        return img
    if not buf.startswith(_PNG_SIGNATURE):
        raise _unsupported(name, "not a JPEG, PNG or .npy file")
    return decode_png(buf, name)


def _chunks(buf: bytes, name: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos: pos + 8])
        body = buf[pos + 8: pos + 8 + length]
        crc = buf[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: PNG chunk {kind!r} is cut short")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG has no IEND chunk")


def decode_png(buf: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3)."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(buf, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise _unsupported(name, f"a PNG of bit depth {depth}, colour type {color}")
    if interlace:
        raise _unsupported(name, "an interlaced PNG")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG has no PLTE chunk")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{name}: PNG data holds {raw.size} bytes, expected {h * (1 + w * ch)}")
    rows = raw.reshape(h, 1 + w * ch)
    px = unfilter(rows[:, 0], rows[:, 1:], ch).reshape(h, w, ch)
    if color == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index beyond the {len(palette)} PLTE entries")
        return palette[px[..., 0]][..., ::-1].copy()
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return px[..., 2::-1].copy()  # RGB(A) -> BGR, alpha dropped


def unfilter(ftype: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG row filters. ``ftype`` (H,) filter byte of each row, ``data``
    (H, stride) filtered bytes, ``bpp`` bytes a pixel. Returns (H, stride) uint8."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} does not exist")
    if (ftype >= 3).any():
        with _DIAGONAL_LOCK:
            return _unfilter_diagonal(ftype, data, bpp)
    h, stride = data.shape
    out = data.copy()
    sub = ftype == 1
    out[sub] = np.cumsum(data[sub].reshape(-1, stride // bpp, bpp), axis=1, dtype=np.uint8).reshape(-1, stride)
    up = np.flatnonzero(ftype == 2)
    if up.size:  # each run of Up rows is a cumulative sum down the run on top of the row above it
        starts = up[np.r_[True, np.diff(up) > 1]]
        ends = up[np.r_[np.diff(up) > 1, True]] + 1
        for s, e in zip(starts, ends):
            run = np.cumsum(data[s:e], axis=0, dtype=np.uint8)
            out[s:e] = run + out[s - 1] if s else run
    return out


def _unfilter_diagonal(ftype: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters, one anti-diagonal (pixels with r + x = t) a step.

    ``s[t + 2, r + 1]`` holds pixel (r, t - r); row 0 is the zero row above
    the image and steps 0 and 1 the zero column left of it, so a pixel's
    left, upper and upper-left neighbours are ``s[t + 1, r + 1]``,
    ``s[t + 1, r]`` and ``s[t, r]``. Values off the image's right edge are
    never read; those left of its left edge are kept at zero."""
    h, stride = data.shape
    w = stride // bpp
    steps = w + h - 1
    filt = np.zeros((steps, h, bpp), np.int16)  # step t holds pixel (r, t - r) of each row r
    _diagonal_view(filt, w)[...] = data.reshape(h, w, bpp)
    s = np.zeros((steps + 2, h + 1, bpp), np.int16)
    # predictor of each row: (a * wa + b * wb) >> shift, plus Paeth's pick where wp:
    # None 0, Sub a, Up b, Average (a + b) >> 1, Paeth the nearest of a, b, c to a + b - c
    def row_weight(mask):
        return np.broadcast_to(mask[:, None], (h, bpp)).astype(np.int16)

    wa, wb = row_weight((ftype == 1) | (ftype == 3)), row_weight((ftype == 2) | (ftype == 3))
    shift, wp = row_weight(ftype == 3), row_weight(ftype == 4)
    only_paeth, has_avg, has_paeth = bool(wp.all()), bool(shift.any()), bool(wp.any())
    pred, term, da, db, pa, pb, pc, ka, kb = (np.empty((h, bpp), np.int16) for _ in range(9))

    def paeth(a, b, c, out):
        np.subtract(a, c, out=da)
        np.subtract(b, c, out=db)
        np.add(da, db, out=pc)
        np.abs(pc, out=pc)  # |p - c|
        np.abs(da, out=pb)  # |p - b|
        np.abs(db, out=pa)  # |p - a|
        np.less_equal(pb, pc, out=kb, casting="unsafe")  # b before c
        np.minimum(pb, pc, out=pc)
        np.less_equal(pa, pc, out=ka, casting="unsafe")  # a before b and c
        np.multiply(db, kb, out=out)
        out += c
        np.subtract(a, out, out=da)
        np.multiply(da, ka, out=da)
        out += da

    for t in range(steps):
        a, b, c = s[t + 1, 1:], s[t + 1, :-1], s[t, :-1]  # left, up, up-left
        if only_paeth:
            paeth(a, b, c, pred)
        else:
            np.multiply(a, wa, out=pred)
            np.multiply(b, wb, out=term)
            pred += term
            if has_avg:
                pred >>= shift
            if has_paeth:
                paeth(a, b, c, term)
                term *= wp
                pred += term
        cur = s[t + 2, 1:]
        np.add(filt[t], pred, out=cur)
        cur &= 255
        if t + 1 < h:
            cur[t + 1:] = 0  # rows whose first pixel comes later
    return _diagonal_view(s[2:, 1:], w).astype(np.uint8).reshape(h, stride)


def _diagonal_view(a: np.ndarray, w: int) -> np.ndarray:
    """(H, w, C) view of a (T, H, C) array ``a`` at [r, x] -> a[r + x, r]."""
    return np.lib.stride_tricks.as_strided(
        a, shape=(a.shape[1], w, a.shape[2]), strides=(a.strides[0] + a.strides[1], a.strides[0], a.strides[2]),
        writeable=True)
