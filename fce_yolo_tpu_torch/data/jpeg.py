"""Baseline and progressive JPEG decoding without cv2 or PIL, bit-equal to the JAX package's
``imread`` (``fce_yolo_tpu/utils/patches.py:18``: ``cv2.imdecode(...,
IMREAD_COLOR)``, libjpeg-turbo with its defaults).

Two paths give the same bytes:

- ``device="cuda"``: ``fce_jpeg_decode`` of ``csrc/jpeg.cu``. The entropy
  decode runs as host C++ into a pinned buffer with the interpreter lock
  released for the whole call; dequantisation + IDCT (``jpeg_idct_kernel``)
  and upsampling + colour conversion (``jpeg_color_kernel``) run on the card.
  Each thread keeps its own stream and buffers (``_Buffers``).
- ``device="cpu"``: the plain version, ``parse_jpeg`` + ``entropy_decode``
  (Python, over bit windows; for small images) + ``jpeg_idct_reference`` +
  ``jpeg_color_reference`` (numpy int32).

What is read: SOF0/SOF1 (8-bit Huffman sequential) and SOF2 (8-bit Huffman
progressive), 1 or 3 components with sampling factors 1-4, 8- or 16-bit
quantisation tables, Huffman slots 0 and 1 that no DHT defined (Motion-JPEG
frames) read as the Annex K.3 tables, restart intervals, interleaved and
non-interleaved scans (a non-interleaved scan covers ceil(comp_w / 8) x
ceil(comp_h / 8) blocks, not the MCU-padded grid), the JFIF/Adobe colour
rules of libjpeg (``default_decompress_parms``) and the EXIF orientation as
``cv2.imdecode`` applies it. A progressive file's scans (spectral selection,
successive approximation, EOB runs, each with the Huffman tables in force
at its SOS) fill the same coefficient planes a sequential one does; the
IDCT and colour stages take them unchanged. Arithmetic, lossless,
hierarchical, 12-bit and 4-component (CMYK/YCCK) files raise ``ValueError``
naming the file; so does a progressive file whose scans leave any of
zig-zag positions 1-9 unfinished (libjpeg-turbo smooths such a file's
blocks, ``jdcoefct.c::decompress_smooth_data``, which the port does not
do), one whose data breaks off, and one whose scan breaks the progression
rules (cv2 reads none). There is no fallback.

libjpeg-turbo's arithmetic, reproduced by both paths:

- ISLOW IDCT (jidctint): CONST_BITS 13, PASS1_BITS 2, columns descaled by
  11 and rows by 18 with rounding, output ``clamp(v + 128, 0, 255)``. The C
  code wraps v mod 1024 before that; the SIMD build cv2 runs saturates,
  which only coefficients no encoder emits tell apart (cv2 is followed).
- Fancy upsampling (jdsample): h2v1 ``(3a + b + 1) >> 2`` / ``(3a + b + 2)
  >> 2``; h2v2 on column sums ``3 near + far``: ``(3s + s' + 8) >> 4`` /
  ``(3s + s' + 7) >> 4``; h1v2 ``(3 near + far + 1) >> 2`` above, ``+ 2``
  below. Neighbours past an edge are the edge sample itself, the component's
  last real row or column. h2v1 and h2v2 with a component two samples wide
  or less, and every other ratio (4:1:1 included), replicate.
- YCbCr -> BGR (jdcolor): SCALEBITS 16 tables of FIX(1.40200),
  FIX(1.77200), -FIX(0.71414) and -FIX(0.34414) + ONE_HALF, arithmetic
  shifts, clamped to 0-255. Gray is copied to the three channels; Adobe
  transform 0 (or component ids 'R', 'G', 'B') is RGB, not converted.
- Entropy data cut short by a marker: the bits missing are zeros (the MCU
  where they run out decodes from them), every later MCU of the restart
  interval is left zero, and one warning names the file, as libjpeg's
  "premature end of data segment". A file that ends without an EOI marker
  raises (``cv2.imdecode`` returns None for it).
- A frame over 2^30 pixels raises, as ``cv2.imdecode`` refuses it (None); so
  does one whose coefficients or BGR image pass 2^31 - 1 bytes (the C
  record is 32-bit), which cv2 would read.
"""

from __future__ import annotations

import re
import threading
import warnings
from dataclasses import dataclass, field

import numpy as np

__all__ = ["JpegHeader", "parse_jpeg", "entropy_decode", "jpeg_idct_reference", "jpeg_color_reference",
           "apply_orientation", "exif_orientation", "decode_jpeg_reference", "decode_jpeg", "jpeg_idct", "jpeg_color",
           "jpeg_coefficients", "header_from_info", "JPEG_SIGNATURE", "STD_HUFFMAN"]

JPEG_SIGNATURE = b"\xff\xd8\xff"
# zig-zag position k -> natural (row-major) index; positions past 63 land on 63, as libjpeg's table does
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63] + [63] * 16, np.int64)
_NATURAL = ZIGZAG.tolist()
COLOR_GRAY, COLOR_YCC, COLOR_RGB = 0, 1, 2
# marker -> what it starts, for the files this reader refuses
_REFUSED = {0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
            0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
            0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "arithmetic-coded JPEG (SOF11)",
            0xCC: "arithmetic-coded JPEG (DAC)", 0xCD: "arithmetic-coded JPEG (SOF13)",
            0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
            0xDE: "hierarchical JPEG (DHP)", 0xDF: "hierarchical JPEG (EXP)", 0xDC: "DNL-sized JPEG (DNL)"}
_SEGMENT_END = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])")  # a marker that ends a scan's entropy data
_RST = re.compile(rb"\xff+[\xd0-\xd7]")
MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS: imdecode refuses a larger frame
INT_MAX = (1 << 31) - 1
# The Huffman tables of ITU T.81 Annex K.3, (class, slot) -> (counts, symbols): libjpeg-turbo's
# std_huff_tables fills slots 0 (luminance) and 1 (chrominance) with them when no DHT defined them,
# as Motion-JPEG frames rely on (AVI1 frames carry no DHT)
STD_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
        "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a929394"
        "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
        "e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a2627"
        "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6"
        "e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    bw: int = 0  # blocks a row of the coefficient plane (MCU-padded)
    bh: int = 0
    width: int = 0  # real samples: ceil(W * h / hmax)
    height: int = 0


@dataclass
class Scan:
    comps: list[int]  # component indices
    data: bytes  # the entropy-coded bytes, RST markers included
    restart: int
    tables: dict  # ("dc" | "ac", component index) -> (counts, symbols) as defined when the scan starts
    ss: int = 0  # spectral selection: first and last zig-zag position the scan codes
    se: int = 63
    ah: int = 0  # successive approximation: the bit position before (0: a first scan) and after the scan
    al: int = 0


@dataclass
class JpegHeader:
    width: int
    height: int
    comps: list[Component]
    hmax: int
    vmax: int
    color: int
    orientation: int
    qt: dict[int, np.ndarray]  # table id -> (64,) natural order
    scans: list[Scan] = field(default_factory=list)
    progressive: bool = False


BASELINE_ONLY = "the port reads baseline and progressive (Huffman, 8-bit, 1 or 3 component) JPEG only"
UNFINISHED = ("a progressive JPEG whose scans leave coefficients unfinished (libjpeg smooths its blocks; the port "
              "does not)")
BREAKS_OFF = "a progressive JPEG whose data breaks off"


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}; {BASELINE_ONLY}")


def exif_orientation(tiff: bytes) -> int:
    """Orientation (tag 0x0112 of IFD0) of Exif data (a TIFF header and its
    IFDs: an APP1 ``Exif`` body after its 6-byte name, a PNG ``eXIf``
    chunk, a WebP ``EXIF`` chunk), else 1. As cv2's Exif reader: ``II`` is
    little-endian and any other pair big-endian, and the magic must be 42."""
    order = "little" if tiff[:2] == b"II" else "big"
    if len(tiff) < 8 or int.from_bytes(tiff[2:4], order) != 42:
        return 1
    off = int.from_bytes(tiff[4:8], order)
    if off + 2 > len(tiff):
        return 1
    for i in range(int.from_bytes(tiff[off:off + 2], order)):
        e = tiff[off + 2 + 12 * i: off + 14 + 12 * i]
        if len(e) < 12:
            break
        if int.from_bytes(e[:2], order) == 0x0112:
            v = int.from_bytes(e[8:10], order)
            return v if 1 <= v <= 8 else 1
    return 1


def parse_jpeg(buf: bytes, name: str = "<jpeg>") -> JpegHeader:
    """Markers of a baseline JPEG -> header, tables and scans. Raises
    ValueError for the files this reader refuses, naming ``name``."""
    if not buf.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos, n = 2, len(buf)
    qt: dict[int, np.ndarray] = {}
    huffman: dict = {}
    restart, frame, orientation, progressive = 0, None, None, False
    jfif = adobe = False
    transform = 1
    scans: list[Scan] = []
    while True:
        while pos < n and buf[pos] == 0xFF and pos + 1 < n and buf[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > n or buf[pos] != 0xFF:
            raise ValueError(f"{name}: JPEG data ends or breaks off before the EOI marker")
        marker = buf[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker in _REFUSED:
            raise _refuse(name, f"a {_REFUSED[marker]} file")
        if pos + 2 > n:
            raise ValueError(f"{name}: JPEG marker 0x{marker:02X} is cut short")
        length = int.from_bytes(buf[pos:pos + 2], "big")
        body = buf[pos + 2: pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{name}: JPEG marker 0x{marker:02X} is cut short")
        pos += length
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                size = 128 if pq else 64
                raw = body[p + 1: p + 1 + size]
                if len(raw) != size or tq > 3:
                    raise ValueError(f"{name}: bad DQT segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG[:64]] = vals
                qt[tq] = table
                p += 1 + size
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = list(body[p + 1: p + 17])
                symbols = body[p + 17: p + 17 + sum(counts)]
                if len(counts) != 16 or len(symbols) != sum(counts) or tc > 1 or th > 3:
                    raise ValueError(f"{name}: bad DHT segment")
                huffman[(tc, th)] = (counts, bytes(symbols))
                p += 17 + sum(counts)
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(body[:2], "big")
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2
            progressive = marker == 0xC2
            if frame is not None:
                raise ValueError(f"{name}: two SOF markers")
            precision, height, width, nc = body[0], int.from_bytes(body[1:3], "big"), \
                int.from_bytes(body[3:5], "big"), body[5]
            if precision != 8:
                raise _refuse(name, f"a {precision}-bit JPEG")
            if nc not in (1, 3):
                raise _refuse(name, f"a {nc}-component JPEG (CMYK/YCCK)" if nc == 4 else f"a {nc}-component JPEG")
            if height == 0:
                raise _refuse(name, "a JPEG sized by DNL (height 0)")
            if width == 0 or len(body) < 6 + 3 * nc:
                raise ValueError(f"{name}: bad SOF segment")
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
                comps.append(Component(cid, hv >> 4, hv & 15, tq))
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    raise ValueError(f"{name}: bad sampling factors or table in SOF")
            frame = (width, height, comps)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: SOS before SOF")
            ns = body[0] if body else 0
            if ns == 0 or len(body) < 4 + 2 * ns:
                raise ValueError(f"{name}: bad SOS segment")
            ids = [c.id for c in frame[2]]
            sel, td, ta = [], [], []
            for i in range(ns):
                cs, t = body[1 + 2 * i], body[2 + 2 * i]
                if cs not in ids:
                    raise ValueError(f"{name}: SOS names component {cs}, not in the frame")
                sel.append(ids.index(cs))
                td.append(t >> 4)
                ta.append(t & 15)
            if ns > 1 and sum(frame[2][i].h * frame[2][i].v for i in sel) > 10:
                raise ValueError(f"{name}: an interleaved MCU of more than 10 blocks")
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            elif (se > 63 or ss > se or (ss == 0) != (se == 0) or (ss and ns != 1) or al > 13
                  or (ah and al != ah - 1)):
                raise _refuse(name, f"a progressive JPEG with a bad scan (its Ss, Se, Ah or Al: {ss}, {se}, {ah}, "
                                    f"{al})")
            m = _SEGMENT_END.search(buf, pos)
            end = m.start() if m else n
            if m is None or end + 1 >= n:
                raise ValueError(f"{name}: JPEG data ends or breaks off before the EOI marker")
            tables = {("dc", j): huffman.get((0, t), STD_HUFFMAN.get((0, t))) for j, t in zip(sel, td)}
            tables.update({("ac", j): huffman.get((1, t), STD_HUFFMAN.get((1, t))) for j, t in zip(sel, ta)})
            scans.append(Scan(sel, buf[pos:end], restart, tables, ss, se, ah, al))
            pos = end
        elif marker == 0xE0:  # APP0
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\x00")
        elif marker == 0xE1:  # APP1
            if orientation is None and body[:6] == b"Exif\x00\x00":
                orientation = exif_orientation(body[6:])
        elif marker == 0xEE:  # APP14
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe, transform = True, body[11]
        elif marker == 0xC8 or (0xF0 <= marker <= 0xFD) or marker == 0xFE or 0xE2 <= marker <= 0xEF:
            pass  # JPG extensions, APPn, COM: skipped
        else:
            raise ValueError(f"{name}: unknown JPEG marker 0x{marker:02X}")
    if frame is None or not scans:
        raise ValueError(f"{name}: JPEG has no frame or no scan")
    width, height, comps = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise _refuse(name, "a JPEG with fractional sampling ratios")
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.width, c.height = -(-width * c.h // hmax), -(-height * c.v // vmax)
        if c.tq not in qt:
            raise ValueError(f"{name}: quantisation table {c.tq} is missing")
    if width * height > MAX_PIXELS or sum(64 * c.bw * c.bh for c in comps) > INT_MAX or 3 * width * height > INT_MAX:
        raise _refuse(name, _ERRORS[-12])
    if len(comps) == 1:
        color = COLOR_GRAY
    elif jfif:
        color = COLOR_YCC
    elif adobe:
        color = COLOR_RGB if transform == 0 else COLOR_YCC
    else:
        color = COLOR_RGB if [c.id for c in comps] == [82, 71, 66] else COLOR_YCC
    hdr = JpegHeader(width, height, comps, hmax, vmax, color, orientation or 1, qt, scans, progressive)
    if progressive and _unfinished(hdr):
        raise _refuse(name, UNFINISHED)
    return hdr


def _unfinished(hdr: JpegHeader) -> bool:
    """libjpeg-turbo's test for block smoothing (jdcoefct.c smoothing_ok):
    every component's DC has been coded, and some component's zig-zag
    positions 0-9 hold a coefficient whose last scan left bits to come
    (Al > 0) or that no scan coded."""
    bits = [[-1] * 64 for _ in hdr.comps]
    for scan in hdr.scans:
        for c in scan.comps:
            bits[c][scan.ss: scan.se + 1] = [scan.al] * (scan.se + 1 - scan.ss)
    return all(b[0] >= 0 for b in bits) and any(v != 0 for b in bits for v in b[1:10])


def _lookup(table, name: str) -> list[int]:
    """A 65536-entry list: 16 bits ahead -> (code length << 8) | symbol; a
    prefix no code starts is (17 << 8) | 0 (libjpeg's "bad Huffman code":
    17 bits consumed, symbol 0)."""
    if table is None:
        raise ValueError(f"{name}: a scan uses a Huffman table (slot 2 or 3) that was never defined")
    counts, symbols = table
    out = [(17 << 8)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            out[lo: lo + (1 << (16 - length))] = [(length << 8) | symbols[k]] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return out


def _windows(seg: bytes) -> tuple[list[int], int]:
    """Bit windows of an unstuffed entropy segment: w[q] holds bytes q..q+2
    (24 bits, zeros past the end); and the segment's length in bits."""
    data = seg.replace(b"\xff\x00", b"\xff")
    a = np.frombuffer(data + bytes(4096), np.uint8).astype(np.int64)
    return ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist(), 8 * len(data)


def entropy_decode(hdr: JpegHeader, name: str = "<jpeg>") -> list[np.ndarray]:
    """The scans' Huffman data -> one int16 plane (bh, bw, 64) of quantised
    coefficients a component, natural order (plain version of the host
    decoder in ``csrc/jpeg.cu``). A progressive file's scans fill the planes
    one after another (``_progressive_scan``)."""
    flat = [[0] * (c.bh * c.bw * 64) for c in hdr.comps]
    warned = False
    for scan in hdr.scans:
        comps = [hdr.comps[i] for i in scan.comps]
        alone = len(comps) == 1  # non-interleaved: MCU (my, mx) is the component's block (my, mx)
        if alone:
            gw, gh = -(-comps[0].width // 8), -(-comps[0].height // 8)
            blocks = [(0, 0, 0)]
        else:
            gw, gh = -(-hdr.width // (8 * hdr.hmax)), -(-hdr.height // (8 * hdr.vmax))
            blocks = [(j, by, bx) for j, c in enumerate(comps) for by in range(c.v) for bx in range(c.h)]
        if hdr.progressive:
            _progressive_scan(scan, comps, [flat[i] for i in scan.comps], alone, gw, gh, blocks, name)
            continue
        dc = [_lookup(scan.tables[("dc", i)], name) for i in scan.comps]
        ac = [_lookup(scan.tables[("ac", i)], name) for i in scan.comps]
        total = gw * gh
        per = scan.restart or total
        segments = _RST.split(scan.data)
        cut = False
        for s in range(-(-total // per)):
            if s >= len(segments):  # a marker ended the data: the rest of the scan stays zero
                cut = True
                break
            win, nbits = _windows(segments[s].rstrip(b"\xff"))
            p = 0
            pred = [0] * len(comps)
            for m in range(s * per, min(total, (s + 1) * per)):
                my, mx = divmod(m, gw)
                for j, by, bx in blocks:
                    c = comps[j]
                    out = flat[scan.comps[j]]
                    base = 64 * (my * c.bw + mx if alone else (my * c.v + by) * c.bw + mx * c.h + bx)
                    e = dc[j][(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    t = e & 255
                    if t:
                        r = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - t)
                        p += t
                        t = r - (1 << t) + 1 if r < (1 << (t - 1)) else r
                    pred[j] += t
                    out[base] = pred[j]
                    tab = ac[j]
                    k = 1
                    while k < 64:
                        e = tab[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                        p += e >> 8
                        r, t = (e >> 4) & 15, e & 15
                        if t:
                            k += r
                            v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - t)
                            p += t
                            out[base + _NATURAL[k]] = v - (1 << t) + 1 if v < (1 << (t - 1)) else v
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                if p > nbits:  # ran past the data: this MCU took zero bits, the rest of the interval is zero
                    cut = True
                    break
        if cut and not warned:
            warnings.warn(f"{name}: JPEG entropy data is cut short; the missing part decodes as zeros")
            warned = True
    return [np.array(f, np.int64).astype(np.int16).reshape(c.bh, c.bw, 64) for f, c in zip(flat, hdr.comps)]


def _progressive_scan(scan: Scan, comps: list[Component], out: list[list[int]], alone: bool, gw: int, gh: int,
                      blocks: list[tuple[int, int, int]], name: str) -> None:
    """One scan of a progressive file into the components' flat planes, as
    libjpeg's jdphuff decodes it: DC first (the difference added to the
    prediction, shifted left by Al) and DC refinement (one bit, OR-ed in at
    Al), AC first (runs, values shifted left by Al, EOB runs of 2^r + r bits
    blocks) and AC refinement (a new coefficient of +-2^Al after its run of
    still-zero positions, one correction bit for every already non-zero
    coefficient passed, also through an EOB run). Restart intervals reset
    the prediction and the EOB run. Data cut short raises."""
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -1 << al
    if ss == 0 and ah == 0:
        dc = [_lookup(scan.tables[("dc", i)], name) for i in scan.comps]
    elif ss:
        ac = _lookup(scan.tables[("ac", scan.comps[0])], name)
    total = gw * gh
    per = scan.restart or total
    segments = _RST.split(scan.data)
    for s in range(-(-total // per)):
        if s >= len(segments):
            raise _refuse(name, BREAKS_OFF)
        win, nbits = _windows(segments[s].rstrip(b"\xff"))
        p, pred, eobrun = 0, [0] * len(comps), 0

        def bits(n: int) -> int:
            nonlocal p
            v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - n)
            p += n
            return v

        def huff(tab) -> int:
            nonlocal p
            e = tab[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            p += e >> 8
            return e & 255

        for m in range(s * per, min(total, (s + 1) * per)):
            my, mx = divmod(m, gw)
            for j, by, bx in blocks:
                c = comps[j]
                f = out[j]
                base = 64 * (my * c.bw + mx if alone else (my * c.v + by) * c.bw + mx * c.h + bx)
                if ss == 0:
                    if ah:
                        if bits(1):
                            f[base] |= p1
                        continue
                    t = huff(dc[j])
                    if t:
                        r = bits(t)
                        t = r - (1 << t) + 1 if r < (1 << (t - 1)) else r
                    pred[j] += t
                    f[base] = pred[j] << al
                    continue
                k = ss
                if not ah:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    while k <= se:
                        rs = huff(ac)
                        r, t = rs >> 4, rs & 15
                        if t:
                            k += r
                            v = bits(t)
                            f[base + _NATURAL[k]] = (v - (1 << t) + 1 if v < (1 << (t - 1)) else v) << al
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = (1 << r) + (bits(r) if r else 0) - 1
                            break
                    continue
                if not eobrun:  # AC refinement
                    while k <= se:
                        rs = huff(ac)
                        r, t = rs >> 4, rs & 15
                        if t:
                            t = p1 if bits(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits(r) if r else 0)
                            break
                        while k <= se:
                            i = base + _NATURAL[k]
                            if f[i]:
                                if bits(1) and not f[i] & p1:
                                    f[i] += p1 if f[i] >= 0 else m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if t:
                            f[base + _NATURAL[k]] = t
                        k += 1
                if eobrun:
                    while k <= se:
                        i = base + _NATURAL[k]
                        if f[i] and bits(1) and not f[i] & p1:
                            f[i] += p1 if f[i] >= 0 else m1
                        k += 1
                    eobrun -= 1
            if p > nbits:
                raise _refuse(name, BREAKS_OFF)


# ISLOW constants (jidctint.c), FIX(x) = round(x * 2^13)
F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, 7373, 9633
F1501, F1847, F1961, F2053, F2562, F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _idct_1d(x: list[np.ndarray], shift: int) -> list[np.ndarray]:
    """One ISLOW pass over 8 int32 arrays (the 8 inputs of a column or row),
    each output descaled by ``shift`` with rounding."""
    z1 = (x[2] + x[6]) * F0541
    tmp2 = z1 - x[6] * F1847
    tmp3 = z1 + x[2] * F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F1175
    o0, o1, o2, o3 = o0 * F0298, o1 * F2053, o2 * F3072, o3 * F1501
    z1, z2, z3, z4 = z1 * -F0899, z2 * -F2562, z3 * -F1961 + z5, z4 * -F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                                          t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def jpeg_idct_reference(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise and ISLOW-IDCT one component: int16 (bh, bw, 64) natural
    order and its (64,) table -> uint8 plane (8 bh, 8 bw). int32 arithmetic
    (plain version of ``jpeg_idct_kernel``)."""
    bh, bw, _ = coef.shape
    d = coef.astype(np.int32) * qt.astype(np.int32)
    d = d.reshape(bh, bw, 8, 8)
    cols = _idct_1d([d[:, :, r, :] for r in range(8)], 11)  # pass 1: down each column
    ws = np.stack(cols, axis=2)  # (bh, bw, row, col)
    rows = _idct_1d([ws[:, :, :, c] for c in range(8)], 18)  # pass 2: along each row
    out = np.clip(np.stack(rows, axis=3) + 128, 0, 255).astype(np.uint8)  # (bh, bw, row, col)
    return out.transpose(0, 2, 1, 3).reshape(8 * bh, 8 * bw)


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's real samples (h, w) upsampled by (fh, fv) as libjpeg-turbo's
    jdsample does (module docstring); int32 out."""
    p = p.astype(np.int32)
    h, w = p.shape
    if fh == 2 and fv == 1 and w > 2:
        left = np.concatenate([p[:, :1], p[:, :-1]], 1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out
    if fh == 1 and fv == 2:
        up = np.concatenate([p[:1], p[:-1]], 0)
        down = np.concatenate([p[1:], p[-1:]], 0)
        out = np.empty((2 * h, w), np.int32)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if fh == 2 and fv == 2 and w > 2:
        up = np.concatenate([p[:1], p[:-1]], 0)
        down = np.concatenate([p[1:], p[-1:]], 0)
        out = np.empty((2 * h, 2 * w), np.int32)
        for v, s in ((0, 3 * p + up), (1, 3 * p + down)):
            left = np.concatenate([s[:, :1], s[:, :-1]], 1)
            right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
            out[v::2, 0::2] = (3 * s + left + 8) >> 4
            out[v::2, 1::2] = (3 * s + right + 7) >> 4
        return out
    return np.repeat(np.repeat(p, fv, 0), fh, 1)


def _ycc_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


def jpeg_color_reference(planes: list[np.ndarray], hdr: JpegHeader) -> np.ndarray:
    """Component planes (uint8, from ``jpeg_idct_reference``) -> BGR uint8
    (H, W, 3): each component cut to its real samples, upsampled, and
    converted by ``hdr.color`` (plain version of ``jpeg_color_kernel``)."""
    full = []
    for p, c in zip(planes, hdr.comps):
        up = _upsample(p[:c.height, :c.width], hdr.hmax // c.h, hdr.vmax // c.v)
        full.append(up[:hdr.height, :hdr.width])
    if hdr.color == COLOR_GRAY:
        return np.repeat(full[0][..., None], 3, axis=2).astype(np.uint8)
    if hdr.color == COLOR_RGB:
        return np.stack([full[2], full[1], full[0]], 2).astype(np.uint8)
    y, cb, cr = full
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([b, g, r], 2), 0, 255).astype(np.uint8)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied as ``cv2.imdecode`` applies it."""
    t = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
         5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
         7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: a.transpose(1, 0, 2)[::-1]}[orientation]
    return np.ascontiguousarray(t(img))


def decode_jpeg_reference(buf: bytes, name: str = "<jpeg>") -> np.ndarray:
    """The plain path: JPEG bytes -> BGR uint8 (H, W, 3), oriented."""
    hdr = parse_jpeg(buf, name)
    coefs = entropy_decode(hdr, name)
    planes = [jpeg_idct_reference(cf, hdr.qt[c.tq]) for cf, c in zip(coefs, hdr.comps)]
    return apply_orientation(jpeg_color_reference(planes, hdr), hdr.orientation)


# ------------------------------------------------------------------ the card
_LAUNCH_LOCK = threading.Lock()  # the loader's threads all count launches
_TLS = threading.local()
# the C decoder's int32 record: 0 W, 1 H, 2 components, 3 colour, 4 orientation, 5 hmax, 6 vmax,
# 7 total coefficients, 8 truncated flag, then per component c at 16 + 8c: h, v, bw, bh, width, height,
# coefficient offset, quantisation table id
INFO_LEN = 48
_GROW = -13  # the caller's buffers are too small for the record just filled in
# fce_jpeg_* return codes below 0 -> what the file is
_ERRORS = {-1: "not a JPEG file or a corrupt one", -2: UNFINISHED,
           -3: "an arithmetic-coded JPEG file", -4: "a JPEG of another precision than 8 bits",
           -5: "a lossless JPEG (SOF3) file", -6: "a 4-component JPEG (CMYK/YCCK) file",
           -7: "a hierarchical JPEG file", -8: "JPEG data that ends or breaks off before the EOI marker",
           -9: "a JPEG with fractional sampling ratios", -10: "a JPEG that uses an undefined table",
           -11: "a JPEG sized by DNL (height 0)",
           -12: "a JPEG over 2^30 pixels (cv2's limit) or over 2^31 - 1 bytes of coefficients or BGR",
           -14: "a progressive JPEG with a bad scan (its Ss, Se, Ah or Al)", -15: BREAKS_OFF}


def _check(code: int, name: str, what: str) -> None:
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{name}: {_ERRORS.get(code, f'error {code}')}; {BASELINE_ONLY}")
    raise RuntimeError(f"{what} of {name}: CUDA error {code}")


def _count(*wrappers) -> None:
    with _LAUNCH_LOCK:
        for w in wrappers:
            w.launches += 1


def jpeg_coefficients(buf: bytes, name: str = "<jpeg>") -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    """The C host decoder alone: (info, one int16 (bh, bw, 64) plane a
    component, (3, 64) int32 quantisation tables a component)."""
    from fce_yolo_tpu_torch.kernels import build as kbuild

    info = np.zeros(INFO_LEN, np.int32)
    coef = np.zeros(0, np.int16)
    qt = np.zeros((3, 64), np.int32)
    while (err := kbuild.library().fce_jpeg_coefficients(buf, len(buf), coef.ctypes.data, coef.size, qt.ctypes.data,
                                                         info.ctypes.data)) == _GROW:
        coef = np.zeros(int(info[7]), np.int16)
    _check(err, name, "fce_jpeg_coefficients")
    planes = []
    for c in range(int(info[2])):
        _, _, bw, bh, _, _, off, _ = info[16 + 8 * c: 24 + 8 * c]
        planes.append(coef[off: off + bh * bw * 64].reshape(bh, bw, 64))
    return info, planes, qt


class _Buffers:
    """One thread's stream and buffers, grown to the largest image seen:
    pinned host coefficients and BGR out, device coefficients, planes (one
    byte a coefficient) and BGR."""

    def __init__(self, device):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.coef_n = self.out_n = 0
        self.h_coef = self.d_coef = self.d_plane = self.d_out = self.h_out = None

    def ensure(self, coef_n: int, out_n: int) -> None:
        import torch

        with torch.cuda.stream(self.stream):
            if coef_n > self.coef_n:
                self.h_coef = torch.empty(coef_n, dtype=torch.int16, pin_memory=True)
                self.d_coef = torch.empty(coef_n, dtype=torch.int16, device=self.device)
                self.d_plane = torch.empty(coef_n, dtype=torch.uint8, device=self.device)
                self.coef_n = coef_n
            if out_n > self.out_n:
                self.d_out = torch.empty(out_n, dtype=torch.uint8, device=self.device)
                self.h_out = torch.empty(out_n, dtype=torch.uint8, pin_memory=True)
                self.out_n = out_n


def _buffers(device):
    import torch

    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per = getattr(_TLS, "buffers", None)
    if per is None:
        per = _TLS.buffers = {}
    if device not in per:
        per[device] = _Buffers(device)
    return per[device]


def decode_jpeg(buf: bytes, name: str = "<jpeg>", device="cuda", times: np.ndarray | None = None) -> np.ndarray:
    """JPEG bytes -> BGR uint8 (H, W, 3), oriented as ``cv2.imdecode`` does.

    ``device="cuda"`` (or a CUDA device): ``fce_jpeg_decode`` (host entropy
    decode, both kernels, copies) on this thread's stream; raises without
    CUDA, on a build or launch failure, and for the files the reader
    refuses. ``device="cpu"``: the plain version. ``times`` (float32 (5,),
    CUDA only) receives ms of host entropy decode, H2D, IDCT, colour, D2H."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return decode_jpeg_reference(buf, name)
    if device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: JPEG decode on {device} needs CUDA, which is not available; pass device='cpu' "
                           "for the plain version")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    if times is not None and (times.dtype != np.float32 or times.size < 5):
        raise ValueError("times must be a float32 array of 5")
    lib = kbuild.library()
    info = np.zeros(INFO_LEN, np.int32)
    b = _buffers(device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(b.device):  # a loader thread's current device may be another card
        # one parse a call: the first image larger than the buffers comes back with its sizes (_GROW)
        while (err := lib.fce_jpeg_decode(buf, len(buf), info.ctypes.data, ptr(b.h_coef), ptr(b.d_coef),
                                          ptr(b.d_plane), b.coef_n, ptr(b.d_out), ptr(b.h_out), b.out_n,
                                          None if times is None else times.ctypes.data,
                                          b.stream.cuda_stream)) == _GROW:
            b.ensure(int(info[7]), 3 * int(info[0]) * int(info[1]))
    _check(err, name, "fce_jpeg_decode")
    _count(jpeg_idct, jpeg_color)
    w, h = int(info[0]), int(info[1])
    if info[8]:
        warnings.warn(f"{name}: JPEG entropy data is cut short; the missing part decodes as zeros")
    img = b.h_out[: h * w * 3].numpy().reshape(h, w, 3)
    return apply_orientation(img, int(info[4])) if info[4] != 1 else img.copy()


def jpeg_idct(coef, qt: np.ndarray, info: np.ndarray):
    """Dequantise + IDCT every component: int16 coefficients of all
    components (flat, the layout of ``jpeg_coefficients``), their (3, 64)
    int32 tables (numpy) and the C parser's record -> uint8 planes (flat,
    the same layout). A CUDA tensor launches ``jpeg_idct_kernel`` on the
    current stream; a CPU tensor takes ``jpeg_idct_reference`` per component."""
    import torch

    comps = [info[16 + 8 * c: 24 + 8 * c] for c in range(int(info[2]))]
    qt = np.ascontiguousarray(qt, np.int32)
    if coef.device.type == "cpu":
        out = [jpeg_idct_reference(coef[o: o + bh * bw * 64].numpy().reshape(bh, bw, 64), qt[c])
               for c, (_, _, bw, bh, _, _, o, _) in enumerate(comps)]
        return torch.from_numpy(np.concatenate([p.ravel() for p in out]))
    if coef.device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {coef.device}")
    if coef.dtype != torch.int16 or not coef.is_contiguous() or coef.numel() < int(info[7]) or qt.shape != (3, 64):
        raise ValueError("jpeg_idct takes contiguous int16 coefficients of the record's size and (3, 64) tables")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    out = torch.empty(int(info[7]), dtype=torch.uint8, device=coef.device)
    with torch.cuda.device(coef.device):
        err = kbuild.library().fce_jpeg_idct(coef.data_ptr(), qt.ctypes.data, out.data_ptr(), info.ctypes.data,
                                             torch.cuda.current_stream().cuda_stream)
    kbuild.check(err, "fce_jpeg_idct")
    _count(jpeg_idct)
    return out


def jpeg_color(planes, info: np.ndarray):
    """Upsample + colour-convert: uint8 planes (flat, the layout of
    ``jpeg_idct``) and the C parser's record -> BGR uint8 (H, W, 3), not
    oriented. A CUDA tensor launches ``jpeg_color_kernel`` on the current
    stream; a CPU tensor takes ``jpeg_color_reference``."""
    import torch

    w, h = int(info[0]), int(info[1])
    if planes.device.type == "cpu":
        hdr = header_from_info(info)
        ps = []
        for c, comp in enumerate(hdr.comps):
            _, _, bw, bh, _, _, o, _ = info[16 + 8 * c: 24 + 8 * c]
            ps.append(planes[o: o + bh * bw * 64].numpy().reshape(8 * bh, 8 * bw))
        return torch.from_numpy(jpeg_color_reference(ps, hdr))
    if planes.device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {planes.device}")
    if planes.dtype != torch.uint8 or not planes.is_contiguous() or planes.numel() < int(info[7]):
        raise ValueError("jpeg_color takes contiguous uint8 planes of the record's size")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    out = torch.empty(h, w, 3, dtype=torch.uint8, device=planes.device)
    with torch.cuda.device(planes.device):
        err = kbuild.library().fce_jpeg_color(planes.data_ptr(), out.data_ptr(), info.ctypes.data,
                                              torch.cuda.current_stream().cuda_stream)
    kbuild.check(err, "fce_jpeg_color")
    _count(jpeg_color)
    return out


def header_from_info(info: np.ndarray) -> JpegHeader:
    """The geometry and colour of a C parser record, as a ``JpegHeader``."""
    comps = []
    for c in range(int(info[2])):
        hh, vv, bw, bh, cw, ch, _, tq = (int(x) for x in info[16 + 8 * c: 24 + 8 * c])
        comps.append(Component(c + 1, hh, vv, tq, bw, bh, cw, ch))
    return JpegHeader(int(info[0]), int(info[1]), comps, int(info[5]), int(info[6]), int(info[3]), int(info[4]), {})


jpeg_idct.launches = 0
jpeg_color.launches = 0
