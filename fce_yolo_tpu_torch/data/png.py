"""PNG decoding without cv2 or PIL, bit-equal to ``cv2.imdecode(...,
IMREAD_COLOR)`` (libpng 1.6 with OpenCV's transforms), the JAX package's
``imread``.

What is read: every colour type at every bit depth the standard allows
(gray 1/2/4/8/16, RGB 8/16, palette 1/2/4/8, gray+alpha and RGBA 8/16),
interlaced (Adam7) or not. As libpng does for OpenCV's colour read:

- 16-bit samples keep their high byte (``png_set_strip_16``);
- gray below 8 bits is scaled to 0-255 (x 255, 85 or 17), palette indices
  below 8 bits are unpacked (rows are packed MSB first);
- alpha, and ``tRNS`` transparency, are dropped, not blended; gray is
  copied into all three channels;
- the ``eXIf`` chunk's orientation is applied as for a JPEG
  (``data/jpeg.py::apply_orientation``). libpng keeps the first ``eXIf``
  chunk whose data starts ``MM`` or ``II``, before or after the image data,
  and ignores one that fails its CRC;
- an ancillary chunk (first letter lower case) that fails its CRC is
  skipped; a critical one raises, and so does a critical chunk other than
  IHDR, PLTE, IDAT and IEND (libpng's "unhandled critical chunk");
- a palette index past the ``PLTE`` entries reads as black (libpng keeps
  256 zeroed entries).

Decoded with the stdlib ``zlib`` and numpy, on the host.

Row filters: None, Sub and Up rows are undone row-vectorised (Sub as a
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
A filter works on bytes: a pixel of fewer than 8 bits takes the byte to its
left as its neighbour, one of 16 bits the 2 x channels bytes to its left.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from fce_yolo_tpu_torch.data.jpeg import apply_orientation, exif_orientation

__all__ = ["decode_png", "unfilter", "PNG_SIGNATURE", "ADAM7"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_CRITICAL = {b"IHDR", b"PLTE", b"IDAT", b"IEND"}
_DIAGONAL_LOCK = threading.Lock()  # one anti-diagonal unfilter at a time (see the module docstring)


def _chunks(buf: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos: pos + 8])
        body = buf[pos + 8: pos + 8 + length]
        crc = buf[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: PNG chunk {kind!r} is cut short")
        pos += 12 + length
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            if kind[0] & 0x20:  # ancillary: libpng warns and skips it
                continue
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
    raise ValueError(f"{name}: PNG has no IEND chunk")


def decode_png(buf: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3), oriented by its ``eXIf`` chunk."""
    header, palette, idat, exif = None, None, [], None
    for kind, body in _chunks(buf, name):
        if header is None and kind != b"IHDR":
            raise ValueError(f"{name}: PNG does not start with its IHDR chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            if exif is None and body[:2] in (b"MM", b"II"):  # libpng's check of the byte order
                exif = body
        elif kind not in _CRITICAL and not kind[0] & 0x20:
            raise ValueError(f"{name}: PNG has an unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in CHANNELS or depth not in DEPTHS[color] or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"{name}: not a valid PNG (bit depth {depth}, colour type {color}, interlace {interlace})")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG has no PLTE chunk")
    ch = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for y0, x0, dy, dx in passes]
    strides = [-(-pw * ch * depth // 8) for _, pw in sizes]
    need = sum(ph * (1 + s) for (ph, pw), s in zip(sizes, strides) if ph and pw)
    if raw.size != need:
        raise ValueError(f"{name}: PNG data holds {raw.size} bytes, expected {need}")
    px = np.empty((h, w, ch), np.uint8)
    at = 0
    for (y0, x0, dy, dx), (ph, pw), stride in zip(passes, sizes, strides):
        if not ph or not pw:  # an empty pass has no filter bytes
            continue
        rows = raw[at: at + ph * (1 + stride)].reshape(ph, 1 + stride)
        at += ph * (1 + stride)
        data = unfilter(rows[:, 0], rows[:, 1:], max(1, ch * depth // 8))
        px[y0::dy, x0::dx] = _samples(data, pw, ch, depth, color)
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette[:256]
        img = pal[px[..., 0]][..., ::-1]
    elif color in (0, 4):
        img = np.repeat(px[..., :1], 3, axis=2)
    else:
        img = px[..., 2::-1]  # RGB(A) -> BGR, alpha dropped
    return apply_orientation(img, exif_orientation(exif) if exif is not None else 1)


def _samples(data: np.ndarray, w: int, ch: int, depth: int, color: int) -> np.ndarray:
    """Unfiltered rows (H, stride) -> 8-bit samples (H, w, ch): 16-bit keeps
    the high byte, gray below 8 bits is scaled to 0-255, palette indices
    below 8 bits are unpacked."""
    h = data.shape[0]
    if depth == 16:
        return data.reshape(h, w, ch, 2)[..., 0]
    if depth == 8:
        return data.reshape(h, w, ch)
    bits = np.unpackbits(data, axis=1)[:, : w * depth].reshape(h, w, depth)
    v = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    if color == 0:
        v = v * np.uint8(255 // ((1 << depth) - 1))
    return v[..., None]


def unfilter(ftype: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG row filters. ``ftype`` (H,) filter byte of each row, ``data``
    (H, stride) filtered bytes, ``bpp`` bytes a pixel (1 below 8 bits).
    Returns (H, stride) uint8."""
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
