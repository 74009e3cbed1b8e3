"""BMP decoding without cv2 or PIL, bit-equal to ``cv2.imdecode(...,
IMREAD_COLOR)`` (OpenCV's own ``grfmt_bmp.cpp``, no library), the JAX
package's ``imread``.

What is read, as OpenCV reads it:

- headers: the BITMAPINFOHEADER family (40 bytes and up: v2-v5, OS/2 2.x)
  and the OS/2 12-byte BITMAPCOREHEADER (3-byte palette entries);
- 1, 4 and 8 bits a pixel through the palette (``biClrUsed`` entries, or
  2^bits when 0; entries past them are black), 16 bits as 5-5-5 (BI_RGB,
  or BI_BITFIELDS with the 5-5-5 masks) or 5-6-5 (BI_BITFIELDS), each
  channel's bits shifted to the top of its byte; 24 bits; 32 bits with or
  without bitfields, bytes 0-2 taken as B, G, R whatever the masks say
  (alpha dropped);
- rows bottom-up, or top-down for a negative height, each padded to 4 bytes;
- RLE8 and RLE4: encoded runs, absolute runs (padded to a 16-bit word),
  and the escapes, which fill the pixels they pass over with palette entry
  0. In RLE8, end of line fills to the end of the row, end of bitmap to the
  end of the image, and delta (dx, dy) dx + dy x width pixels on in raster
  order; an end of line right after an encoded run that ended at the end of
  its row ends nothing more (the run already moved to the next row). In
  RLE4, end of line and end of bitmap alike fill to the end of the row (so
  the stream goes on), and delta fills dx pixels (dy is read and dropped).

cv2 returns None, and this reader raises, for a run that passes the end of
its row, a stream or a row of pixels that ends before the image does, a
16-bit bitfield other than 5-5-5 or 5-6-5 (OpenCV reads the three masks
after the header, also for a v4/v5 header that holds them inside), and
the other compressions (JPEG, PNG, BI_ALPHABITFIELDS, Huffman).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_bmp", "BMP_SIGNATURE"]

BMP_SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


class _Stream:
    """Bytes read in order; reading past the end raises (cv2's stream throws)."""

    def __init__(self, buf: bytes, pos: int, name: str):
        self.buf, self.pos, self.name = buf, pos, name

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.name}: BMP data ends before the image does")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def decode_bmp(buf: bytes, name: str = "<bmp>") -> np.ndarray:
    """BMP bytes -> BGR uint8 (H, W, 3)."""
    if len(buf) < 26 or not buf.startswith(BMP_SIGNATURE):
        raise ValueError(f"{name}: not a BMP file")
    offset, size = struct.unpack("<iI", buf[10:18])
    palette = np.zeros((256, 3), np.uint8)  # BGR
    ok = False
    if size >= 36:
        width, height, bpp, comp = struct.unpack("<iixxHI", buf[18:34]) if len(buf) >= 50 else (0, 0, 0, -1)
        clrused = struct.unpack("<i", buf[46:50])[0] if len(buf) >= 50 else 0
        fmt_ok = ((bpp in (1, 4, 8, 24, 32) and comp == BI_RGB) or (bpp in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
                  or (bpp == 4 and comp == BI_RLE4) or (bpp == 8 and comp == BI_RLE8))
        if width > 0 and height != 0 and fmt_ok:
            ok = True
            after = 14 + size
            if bpp <= 8:
                if not 0 <= clrused <= 256:
                    raise ValueError(f"{name}: BMP palette of {clrused} entries")
                n = clrused or 1 << bpp
                entries = buf[after: after + 4 * n]
                if len(entries) < 4 * n:
                    raise ValueError(f"{name}: BMP palette is cut short")
                palette[:n] = np.frombuffer(entries, np.uint8).reshape(n, 4)[:, :3]
            elif bpp == 16 and comp == BI_BITFIELDS:
                masks = buf[after: after + 12]
                red, green, blue = struct.unpack("<III", masks) if len(masks) == 12 else (0, 0, 0)
                if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                    bpp = 15
                elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                    raise ValueError(f"{name}: a 16-bit BMP with bitfields other than 5-5-5 or 5-6-5 "
                                     f"({red:#x}, {green:#x}, {blue:#x}) (cv2 reads none)")
            elif bpp == 16:
                bpp = 15
    elif size == 12:
        width, height, bpp = struct.unpack("<HHxxH", buf[18:26])
        comp = BI_RGB
        if width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32):
            ok = True
            if bpp <= 8:
                n = 1 << bpp
                entries = buf[26: 26 + 3 * n]
                if len(entries) < 3 * n:
                    raise ValueError(f"{name}: BMP palette is cut short")
                palette[:n] = np.frombuffer(entries, np.uint8).reshape(n, 3)
    if not ok:
        raise ValueError(f"{name}: a BMP of a header, size or pixel format cv2 does not read")
    h = abs(height)
    if width > 1 << 20 or h > 1 << 20 or 3 * width * h >= 1 << 30:  # imdecode's limits and the reader's 1 GB one
        raise ValueError(f"{name}: a BMP of {width} x {h} pixels, over cv2's limits")
    if offset < 0:
        raise ValueError(f"{name}: BMP pixel data at a negative offset")
    st = _Stream(buf, offset, name)
    if comp in (BI_RLE8, BI_RLE4):
        img = _rle(st, width, h, palette, 8 if comp == BI_RLE8 else 4)
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = np.frombuffer(st.take(pitch * h), np.uint8).reshape(h, pitch)
        img = _unpack(rows, width, bpp, palette)
    return img[::-1].copy() if height > 0 else img  # file rows bottom-up unless the height is negative


def _unpack(rows: np.ndarray, w: int, bpp: int, palette: np.ndarray) -> np.ndarray:
    """Rows of the file (H, pitch) -> BGR (H, W, 3) in file row order."""
    h = rows.shape[0]
    if bpp <= 8:
        bits = np.unpackbits(rows, axis=1)[:, : w * bpp].reshape(h, w, bpp)
        idx = (bits << np.arange(bpp - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
        return palette[idx]
    if bpp in (15, 16):
        t = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        b = (t << 3) & 0xF8
        g = (t >> 2) & 0xF8 if bpp == 15 else (t >> 3) & 0xFC
        r = (t >> 7) & 0xF8 if bpp == 15 else (t >> 8) & 0xF8
        return np.stack([b, g, r], 2).astype(np.uint8)
    n = bpp // 8
    return rows[:, : n * w].reshape(h, w, n)[..., :3]


def _rle(st: _Stream, w: int, h: int, palette: np.ndarray, bits: int) -> np.ndarray:
    """OpenCV's RLE8 / RLE4 decode: pixel indices written at ``pos`` (row
    y = pos // w in file order); see the module docstring for the escapes."""
    idx = np.zeros(w * h, np.uint8)
    pos, line_end, y, line_end_flag = 0, w, 0, False

    def fill(count: int, value: int) -> None:  # OpenCV's FillUniColor: on over row ends until count or the image ends
        nonlocal pos, line_end, y
        while True:
            end = min(pos + count, line_end)
            count -= end - pos
            idx[pos:end] = value
            pos = end
            if pos >= line_end:
                line_end += w
                pos = line_end - w
                y += 1
                if y >= h:
                    return
            if count <= 0:
                return

    bad = ValueError(f"{st.name}: a BMP run passes the end of its row (cv2 reads none)")
    while True:
        n, code = st.take(2)
        if n:  # encoded run
            if pos + n > line_end:
                raise bad
            if bits == 8:
                prev_y = y
                fill(n, code)
                line_end_flag = y != prev_y
            else:
                idx[pos: pos + n] = np.resize(np.array([code >> 4, code & 15], np.uint8), n)
                pos += n
            if y >= h:
                break
        elif code > 2:  # absolute run
            if pos + code > line_end:
                raise bad
            raw = np.frombuffer(st.take((code + 1) & ~1 if bits == 8 else ((code + 1) // 2 + 1) & ~1), np.uint8)
            idx[pos: pos + code] = raw[:code] if bits == 8 else np.stack([raw >> 4, raw & 15], 1).ravel()[:code]
            pos += code
            if bits == 8:
                line_end_flag = False
        else:  # 0 end of line, 1 end of bitmap, 2 delta
            shift, y_shift = line_end - pos, h - y
            if bits == 4 or code or not line_end_flag or shift < w:
                if code == 2:
                    shift, y_shift = st.u8(), st.u8()
                if code != 0 and bits == 8:  # OpenCV's RLE4 computes this and then fills only shift
                    shift += y_shift * w
                if bits == 8 and y >= h:
                    break
                fill(shift, 0)
                if y >= h:
                    break
            line_end_flag = False
            if y >= h:
                break
    return palette[idx.reshape(h, w)]
