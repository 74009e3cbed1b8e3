"""TIFF decoding without cv2 or PIL, bit-equal to ``cv2.imdecode(...,
IMREAD_COLOR)``, the JAX package's ``imread``: OpenCV reads every 8-bit
colour TIFF through libtiff's RGBA interface (``TIFFReadRGBAStrip`` /
``TIFFReadRGBATile``), whose rules this module follows.

What is read:

- the first image (IFD0) of a classic or BigTIFF file, little- or
  big-endian; a DNG reads as the TIFF its IFD0 is (usually an RGB
  preview);
- strips, or tiles with the edge tiles cropped; samples interleaved
  (PlanarConfiguration 1) or in planes of their own (2);
- no compression, LZW (5), Deflate (8, 32946; the stdlib ``zlib``) and
  PackBits (32773); horizontal differencing (Predictor 2) at 8 and 16 bits;
- gray (MinIsBlack, MinIsWhite) at 1, 8 and 16 bits, RGB and RGBA at 8 and
  16 bits, gray + alpha, and palette images at 1 and 8 bits. libtiff's
  arithmetic: gray through its map (x * 255 / (2^bits - 1), inverted for
  MinIsWhite; a 16-bit gray sample keeps its high byte), other 16-bit
  samples rounded to 8 bits as (v + 128) / 257, a palette's 16-bit entries
  shifted right by 8 unless every entry is below 256; unassociated alpha
  (ExtraSamples 2) premultiplies the colour, (v * a + 127) / 255, which
  then stays when OpenCV drops the alpha; four samples with no ExtraSamples,
  or ExtraSamples 0, count as associated alpha (not premultiplied). In
  planes of their own a gray image reads as RGB would (no map: MinIsWhite is
  not inverted, 16 bits are rounded);
- the Orientation tag (274), as OpenCV and libtiff apply it: libtiff flips
  each strip or tile it reads horizontally for orientations 2, 3, 6 and 7
  (a tile's mirror stays in its own place), OpenCV then applies the
  orientation less its horizontal flip (1, 4, 7, 6 for those four) to the
  whole image.

LZW and PackBits are byte-serial: ``device="cuda"`` (the default) runs
them as host C++ (``fce_tiff_decode`` of ``csrc/imgcodecs.cu``, built into
the card's kernel libraries; no fallback where they cannot be built),
``"cpu"`` the plain Python versions here. The rest is numpy on the host.

What raises, naming it: the files cv2 reads and this reader does not
(JPEG-in-TIFF, CCITT and other compressions, YCbCr, CMYK and Lab
photometrics, FillOrder 2), and the files cv2 returns None for: 2- and
4-bit samples (OpenCV's header check takes 1, 8, 16, 32 or 64), 32- and
64-bit samples (libtiff's RGBA interface takes 16 at most), more than 4
samples a pixel, a missing PhotometricInterpretation, CFA and linear raw
photometrics, an uncompressed tile whose size is not a multiple of 1024
bytes (libtiff 4.7 refuses its byte count), and uncompressed data shorter
than its strip or tile. Compressed data that decodes short, or an LZW code
past the table, reads as libtiff leaves it for cv2: what was decoded, the
rest of the strip or tile zero, its differencing not undone; one warning
names the file.
"""

from __future__ import annotations

import struct
import warnings
import zlib

import numpy as np

__all__ = ["decode_tiff", "lzw_decode", "packbits_decode", "TIFF_SIGNATURES"]

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
MINISWHITE, MINISBLACK, RGB, PALETTE = 0, 1, 2, 3
COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_OTHER_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG", 7: "JPEG",
                       34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34887: "LERC", 32809: "ThunderScan"}
_OTHER_PHOTOMETRICS = {4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr", 8: "CIE Lab", 9: "ICC Lab",
                       10: "ITU Lab", 32844: "LogL", 32845: "LogLuv", 32803: "CFA (raw)", 34892: "linear raw"}
READ_ONLY = ("the port reads TIFF with no, LZW, Deflate or PackBits compression; gray at 1, 8 or 16 bits, RGB(A) at "
             "8 or 16 bits, palette at 1 or 8 bits")
_ERRORS = {-1: "decodes short", -2: "holds an LZW code past the table", -3: "old-style LZW data"}


def _refuse(name: str, what: str, cv2_reads: bool = True) -> ValueError:
    tail = READ_ONLY if cv2_reads else "cv2 reads none"
    return ValueError(f"{name}: a TIFF with {what}; {tail}")


def _ifd(buf: bytes, off: int, e: str, big: bool, name: str) -> dict[int, list]:
    """Tag -> values of the IFD at ``off`` (numbers as a list, ASCII/UNDEFINED as bytes)."""
    count_fmt, entry, slot = ("Q", 20, 8) if big else ("H", 12, 4)
    n = struct.calcsize(count_fmt)
    if off + n > len(buf):
        raise ValueError(f"{name}: TIFF IFD offset {off} is past the end of the file")
    (count,) = struct.unpack_from(e + count_fmt, buf, off)
    tags = {}
    for i in range(count):
        at = off + n + i * entry
        if at + entry > len(buf):
            raise ValueError(f"{name}: TIFF IFD is cut short")
        tag, typ = struct.unpack_from(e + "HH", buf, at)
        (cnt,) = struct.unpack_from(e + ("Q" if big else "I"), buf, at + 4)
        size = _SIZES.get(typ, 0) * cnt
        if not size:
            continue
        where = at + (12 if big else 8)
        if size > slot:
            (where,) = struct.unpack_from(e + ("Q" if big else "I"), buf, where)
        raw = buf[where: where + size]
        if len(raw) < size:
            raise ValueError(f"{name}: TIFF tag {tag} points past the end of the file")
        if typ in (2, 7):
            tags[tag] = raw
        elif typ in _CODES:
            tags[tag] = list(struct.unpack(e + _CODES[typ] * cnt, raw))
        else:  # rationals and floats: no tag this reader uses
            tags[tag] = raw
    return tags


def lzw_decode(raw: bytes, need: int, name: str = "<tiff>") -> tuple[bytes, int]:
    """TIFF LZW (MSB first, the width raised one code early, as libtiff
    decodes it) into ``need`` bytes. Returns them and 0, or, where libtiff
    stops with an error, what it decoded so far, zero-filled, and -1 (the
    data ran out) or -2 (a code past the table). Old-style (LSB-first) data
    raises."""
    if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
        raise _refuse(name, _ERRORS[-3])
    out = bytearray()
    acc, nacc, pos = 0, 0, 0
    table: list[bytes] = []
    width, prev = 9, None
    while len(out) < need:
        while nacc < width and pos < len(raw):
            acc = (acc << 8) | raw[pos]
            pos += 1
            nacc += 8
        if nacc < width:  # no EOI: the data ran out (libtiff warns, then finds it short)
            break
        nacc -= width
        code = (acc >> nacc) & ((1 << width) - 1)
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if not table:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
        if prev is None:
            if code >= 256:
                return _padded(out, need), -2
            s = table[code]
        else:
            if code < len(table):
                s = table[code]
                table.append(prev + s[:1])
            elif code == len(table):
                s = prev + prev[:1]
                table.append(s)
            else:
                return _padded(out, need), -2
            if len(table) > 4096:
                return _padded(out, need), -2
            if len(table) + 1 >= (1 << width) and width < 12:  # libtiff's early change
                width += 1
        out += s
        prev = s
    return _padded(out, need), -1 if len(out) < need else 0


def _padded(out: bytearray, need: int) -> bytes:
    return bytes(out[:need]) + bytes(max(0, need - len(out)))


def packbits_decode(raw: bytes, need: int, name: str = "<tiff>") -> tuple[bytes, int]:
    """PackBits into ``need`` bytes, as libtiff decodes it: a run past
    ``need`` is cut. Returns them and 0, or what the data gave, zero-filled,
    and -1."""
    out = bytearray()
    pos, n = 0, len(raw)
    while pos < n and len(out) < need:
        c = raw[pos]
        pos += 1
        if c == 128:
            continue
        if c > 128:
            if pos >= n:
                break
            out += raw[pos: pos + 1] * min(257 - c, need - len(out))
            pos += 1
        else:
            k = min(c + 1, need - len(out))
            if n - pos < k:
                break
            out += raw[pos: pos + k]
            pos += k
    return _padded(out, need), -1 if len(out) < need else 0


def _decode_block(raw: bytes, compression: int, need: int, name: str, device) -> tuple[bytes, int]:
    """One strip or tile -> ``need`` bytes and 0, or (zero-filled, -1 or -2)
    where libtiff decodes it short (see ``lzw_decode``)."""
    if compression == 1:
        if len(raw) < need:
            raise _refuse(name, "uncompressed data shorter than its strip or tile", cv2_reads=False)
        return raw[:need], 0
    if compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error:
            raise _refuse(name, "Deflate data that is corrupt", cv2_reads=False) from None
        return out + bytes(need - len(out)), -1 if len(out) < need else 0
    if device.type == "cpu":
        return (lzw_decode if compression == 5 else packbits_decode)(raw, need, name)
    from fce_yolo_tpu_torch.kernels import build as kbuild

    out = np.empty(need, np.uint8)
    err = kbuild.library().fce_tiff_decode(compression, raw, len(raw), out.ctypes.data, need)
    if err == -3:
        raise _refuse(name, _ERRORS[-3])
    if err not in (0, -1, -2):
        raise RuntimeError(f"fce_tiff_decode of {name}: error {err}")
    return out.tobytes(), err


def decode_tiff(buf: bytes, name: str = "<tiff>", device="cuda") -> np.ndarray:
    """TIFF bytes -> BGR uint8 (H, W, 3), oriented as ``cv2.imdecode``
    orients it. LZW and PackBits decode as host C++ for ``device="cuda"``,
    in Python for ``"cpu"``."""
    import torch

    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no TIFF decoder for device {device}")
    if buf[:4] not in TIFF_SIGNATURES:
        raise ValueError(f"{name}: not a TIFF file")
    e = "<" if buf[:2] == b"II" else ">"
    big = buf[2:4] in (b"+\x00", b"\x00+")
    if big:
        if len(buf) < 16 or struct.unpack_from(e + "HH", buf, 4) != (8, 0):
            raise ValueError(f"{name}: bad BigTIFF header")
        (first,) = struct.unpack_from(e + "Q", buf, 8)
    else:
        if len(buf) < 8:
            raise ValueError(f"{name}: TIFF header is cut short")
        (first,) = struct.unpack_from(e + "I", buf, 4)
    t = _ifd(buf, first, e, big, name)

    def one(tag: int, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    if 256 not in t or 257 not in t or 262 not in t:
        raise _refuse(name, "no ImageWidth, ImageLength or PhotometricInterpretation tag", cv2_reads=False)
    w, h, photometric = one(256), one(257), one(262)
    spp, compression, planar = one(277, 1), one(259, 1), one(284, 1)
    bits_all = t.get(258, [1])
    bits, fmt = bits_all[0], one(339, 1)
    if w <= 0 or h <= 0 or w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise _refuse(name, f"a size of {w} x {h} pixels", cv2_reads=False)
    if spp > 4:
        raise _refuse(name, f"{spp} samples a pixel", cv2_reads=False)
    if bits not in (1, 8, 16) or len(set(bits_all)) > 1:
        raise _refuse(name, f"{bits_all} bits a sample", cv2_reads=False)
    if fmt == 3:
        raise _refuse(name, "floating-point samples", cv2_reads=False)
    if compression not in COMPRESSIONS:
        raise _refuse(name, f"{_OTHER_COMPRESSIONS.get(compression, 'unknown')} compression ({compression})")
    if photometric not in (MINISWHITE, MINISBLACK, RGB, PALETTE):
        reads = photometric in (5, 6, 8, 9, 10, 32844, 32845)
        raise _refuse(name, f"a {_OTHER_PHOTOMETRICS.get(photometric, 'unknown')} photometric ({photometric})",
                      cv2_reads=reads)
    if one(266, 1) == 2:
        raise _refuse(name, "FillOrder 2 (least significant bit first)")
    predictor = one(317, 1)
    if predictor not in (1, 2) or (predictor == 2 and bits == 1):
        raise _refuse(name, f"predictor {predictor} at {bits} bits", cv2_reads=False)
    extra = t.get(338, [])
    colour = spp - len(extra)
    alpha = 0  # libtiff's img->alpha: 0 none, 1 associated, 2 unassociated
    if extra:
        alpha = 1 if extra[0] == 0 and spp > 3 else extra[0] if extra[0] in (1, 2) else 0
    elif spp == 4 and photometric == RGB:
        alpha = 1
    separate = planar == 2 and spp > 1
    if photometric in (MINISWHITE, MINISBLACK, PALETTE) and not separate and spp != 1 and bits < 8:
        raise _refuse(name, f"{spp} samples of {bits} bits interleaved", cv2_reads=False)
    if photometric == RGB and (colour < 3 or bits == 1):
        raise _refuse(name, f"RGB of {colour} colour samples at {bits} bits", cv2_reads=False)
    if photometric == PALETTE and (len(t.get(320, ())) < 3 << bits or bits == 16 or separate):
        raise _refuse(name, "a palette of 16-bit indices, in planes or without a full ColorMap", cv2_reads=False)
    if separate and bits != 8 and bits != 16:
        raise _refuse(name, f"planes of {bits}-bit samples", cv2_reads=False)

    tiled = 322 in t
    if tiled:
        tw, th = one(322), one(323)
        offsets, counts = t.get(324), t.get(325)
    else:
        rps = one(278, 0)
        tw, th = w, h if rps <= 0 or rps >= 0xFFFFFFFF else rps
        offsets, counts = t.get(273), t.get(279)
    if not tw or not th or offsets is None or counts is None:
        raise _refuse(name, "no tile or strip layout", cv2_reads=False)
    per_block = 1 if separate else spp
    row_bytes = -(-tw * per_block * bits // 8)
    across, down = -(-w // tw), -(-h // th)
    planes = spp if separate else 1
    if len(offsets) < across * down * planes or len(counts) < across * down * planes:
        raise _refuse(name, "fewer strips or tiles than the image needs", cv2_reads=False)
    if tiled and compression == 1 and (th * row_bytes) % 1024:
        raise _refuse(name, f"uncompressed {th} x {tw} tiles of {th * row_bytes} bytes", cv2_reads=False)
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    samples = np.zeros((down * th, across * tw, spp), dtype)
    k, warned = 0, False
    for p in range(planes):
        for by in range(down):
            for bx in range(across):
                rows = th if tiled else min(th, h - by * th)
                off, cnt = offsets[k], counts[k]
                k += 1
                data, err = _decode_block(buf[off: off + cnt], compression, rows * row_bytes, name, device)
                if err and not warned:
                    warnings.warn(f"{name}: TIFF data {_ERRORS[err]}; the rest of its strip or tile reads as zeros")
                    warned = True
                a = np.frombuffer(data, np.uint8).reshape(rows, row_bytes)
                if bits == 1:
                    a = np.unpackbits(a, axis=1)[:, : tw * per_block]
                a = a.view(dtype).reshape(rows, tw, per_block)
                if predictor == 2 and not err:  # libtiff undoes the differencing only where the decode succeeded
                    a = np.cumsum(a.astype(dtype.newbyteorder("=")), axis=1, dtype=dtype.newbyteorder("="))
                sl = slice(p, p + 1) if separate else slice(None)
                samples[by * th: by * th + rows, bx * tw: (bx + 1) * tw, sl] = a
    img = _to_bgr(samples[:h, :w].astype(samples.dtype.newbyteorder("=")), t, photometric, bits, colour, alpha,
                  separate)
    return _orient(img, one(274, 1), tw if tiled else w)


def _to_bgr(s: np.ndarray, t: dict, photometric: int, bits: int, colour: int, alpha: int,
            separate: bool) -> np.ndarray:
    """Samples (H, W, spp) -> BGR uint8 by libtiff's RGBA rules (module docstring)."""
    if photometric == PALETTE:
        n = 1 << bits
        cmap = np.asarray(t[320][: 3 * n], np.int64).reshape(3, n)
        if (cmap >= 256).any():  # libtiff's checkcmap: a 16-bit map
            cmap = cmap >> 8
        rgb = cmap.T.astype(np.uint8)[s[..., 0]]
        return rgb[..., ::-1].copy()
    if photometric in (MINISWHITE, MINISBLACK) and not separate:
        rng = 255 if bits == 16 else (1 << bits) - 1
        x = np.arange(rng + 1, dtype=np.int64)
        lut = ((rng - x if photometric == MINISWHITE else x) * 255 // rng).astype(np.uint8)
        g = lut[s[..., 0] >> 8 if bits == 16 else s[..., 0]]
        return np.repeat(g[..., None], 3, axis=2)
    to8 = (lambda v: ((v.astype(np.int64) + 128) // 257)) if bits == 16 else (lambda v: v.astype(np.int64))
    c = to8(s[..., :1] if colour == 1 else s[..., :3])
    if alpha == 2 and s.shape[2] > colour:
        c = (c * to8(s[..., colour: colour + 1]) + 127) // 255
    c = np.broadcast_to(c, s.shape[:2] + (3,))
    return c[..., ::-1].astype(np.uint8)


def _orient(img: np.ndarray, orientation: int, tw: int) -> np.ndarray:
    """libtiff's horizontal flip of each strip or tile (``tw`` wide) for
    orientations 2, 3, 6 and 7, then OpenCV's orientation without it."""
    from fce_yolo_tpu_torch.data.jpeg import apply_orientation

    if orientation in (2, 3, 6, 7):
        out = img.copy()
        for x in range(0, img.shape[1], tw):
            out[:, x: x + tw] = img[:, x: x + tw][:, ::-1]
        img, orientation = out, {2: 1, 3: 4, 6: 7, 7: 6}[orientation]
    return apply_orientation(img, orientation if 1 <= orientation <= 8 else 1)
