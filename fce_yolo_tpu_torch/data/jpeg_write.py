"""Baseline JPEG writing without cv2 or PIL, byte-equal to the JAX package's
``imwrite`` of a ``.jpg`` (``fce_yolo_tpu/utils/patches.py:30``:
``cv2.imencode(".jpg", img)``, libjpeg-turbo at cv2's defaults).

cv2's defaults, which this writer keeps: quality 95 (``quality`` takes
another), 4:2:0 sampling for a BGR image (SOF0 components ``1 0x22 q0``,
``2 0x11 q1``, ``3 0x11 q1``) and one component for a gray (H, W) image, the
Annex K Huffman tables (no optimisation), no restart interval, and the
markers SOI, APP0 JFIF 1.01, DQT a table, SOF0, DHT a table (DC 0, AC 0,
DC 1, AC 1), SOS, EOI.

Two paths give the same bytes:

- ``device="cuda"``: ``jpeg_fdct`` launches ``jpeg_fdct_kernel`` of
  ``csrc/jpeg.cu`` (colour conversion, downsampling, forward DCT and
  quantisation, one launch an image), and ``fce_jpeg_entropy`` (host C++ in
  the same file, the interpreter lock released) writes the markers and the
  Huffman-coded data.
- ``device="cpu"``: the plain version, ``jpeg_fdct_reference`` (numpy
  int64) + ``entropy_encode`` (numpy, vectorised over the coefficients).

libjpeg-turbo's integer arithmetic, reproduced by both:

- jccolor: RGB -> YCbCr with SCALEBITS 16 tables, ``FIX(0.29900) r +
  FIX(0.58700) g + FIX(0.11400) b + ONE_HALF``; Cb and Cr with the rounding
  fudge ``CBCR_OFFSET + ONE_HALF - 1``; arithmetic shifts.
- jcsample / jcprepct: rows padded to an even count by repeating the last
  one, columns to whole MCUs by repeating the last one (``expand_right_edge``),
  then ``h2v2_downsample``: ``(a + b + c + d + bias) >> 2`` with the bias 1,
  2, 1, 2, ... along a row; the last row of each plane repeated to a whole
  iMCU (``expand_bottom_edge``).
- jccoefct: the luma blocks that fill an MCU past the image's last block
  column or row are dummies: AC 0, DC that of the block before them (the
  left one; below the image, the MCU's top-right one).
- jfdctint: the ISLOW forward DCT, CONST_BITS 13, PASS1_BITS 2.
- jcdctmgr: division by ``8 q`` through ``compute_reciprocal``'s
  reciprocal, correction and shift: ``((|x| + c) * r) >> s``, sign restored.
- jcparam: ``jpeg_set_quality`` scaling of the Annex K tables, clamped to
  1-255 (baseline).
"""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.data.jpeg import _GROW, STD_HUFFMAN, ZIGZAG

__all__ = ["QUALITY", "quant_tables", "reciprocals", "plane_grids", "jpeg_fdct_reference", "entropy_encode",
           "encode_jpeg_reference", "jpeg_fdct", "encode_jpeg", "entropy_encode_host"]

QUALITY = 95  # cv2's IMWRITE_JPEG_QUALITY default
# ITU T.81 Annex K.1, natural order: luminance, chrominance
_STD_QT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
     14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
     47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32], np.int64)
_ZZ = ZIGZAG[:64]  # zig-zag position -> natural index
# jfdctint's constants, FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765, _F0899, _F1175 = 2446, 3196, 4433, 6270, 7373, 9633
_F1501, _F1847, _F1961, _F2053, _F2562, _F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def quant_tables(quality: int = QUALITY) -> np.ndarray:
    """(2, 64) int64 luminance and chrominance tables, natural order
    (jcparam ``jpeg_set_quality`` with ``force_baseline``)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((_STD_QT * scale + 50) // 100, 1, 255)


def reciprocals(qt: np.ndarray) -> np.ndarray:
    """(3, n, 64) int64 reciprocal, correction and shift of each divisor
    ``8 q`` (jcdctmgr ``compute_reciprocal`` with 16-bit DCT elements)."""
    out = np.zeros((3, *qt.shape), np.int64)
    for idx, q in np.ndenumerate(qt):
        d = int(q) << 3
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two: fq is one bit too large
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        out[(slice(None), *idx)] = fq, c, r
    return out


def plane_grids(h: int, w: int, gray: bool) -> list[tuple[int, int]]:
    """(block rows, block columns) of each component's coefficient plane:
    the MCU-padded grid, as the decoder lays its planes out."""
    if gray:
        return [(-(-h // 8), -(-w // 8))]
    my, mx = -(-h // 16), -(-w // 16)
    return [(2 * my, 2 * mx), (my, mx), (my, mx)]


def _ycc(bgr: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    def fix(v):
        return int(v * 65536 + 0.5)

    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _pad(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _fdct_rows(d: list[np.ndarray], out_shift: int | None) -> list[np.ndarray]:
    """One pass of jfdctint over the 8 entries of ``d`` (arrays of any shape).
    ``out_shift`` None: the first pass (rows: even outputs << PASS1_BITS, odd
    ones descaled by CONST_BITS - PASS1_BITS); else the second (columns)."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = [None] * 8
    if out_shift is None:
        o[0], o[4], n = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2, 11
    else:
        o[0], o[4], n = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2), out_shift
    z1 = (tmp12 + tmp13) * _F0541
    o[2] = descale(z1 + tmp13 * _F0765, n)
    o[6] = descale(z1 - tmp12 * _F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2, z3, z4 = z1 * -_F0899, z2 * -_F2562, z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o[7] = descale(tmp4 + z1 + z3, n)
    o[5] = descale(tmp5 + z2 + z4, n)
    o[3] = descale(tmp6 + z2 + z3, n)
    o[1] = descale(tmp7 + z1 + z4, n)
    return o


def _quantized_blocks(plane: np.ndarray, rec: np.ndarray) -> np.ndarray:
    """Samples (8 bh, 8 bw) -> quantised coefficients (bh, bw, 64), natural order."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    rows = np.stack(_fdct_rows([x[..., i] for i in range(8)], None), -1)  # (bh, bw, row, u)
    coef = np.stack(_fdct_rows([rows[..., r, :] for r in range(8)], 15), 2).reshape(bh, bw, 64)
    recip, corr, shift = rec
    q = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -q, q).astype(np.int16)


def jpeg_fdct_reference(img: np.ndarray, quality: int = QUALITY) -> np.ndarray:
    """The plain version of ``jpeg_fdct_kernel``: BGR (H, W, 3) or gray
    (H, W) uint8 -> int16 coefficients, natural order, every component's
    ``plane_grids`` plane (bh, bw, 64) laid end to end (flat)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) or 0 in img.shape:
        raise ValueError(f"JPEG writing takes a non-empty uint8 (H, W) or (H, W, 3) image, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    grids = plane_grids(h, w, gray)
    rec = reciprocals(quant_tables(quality))
    if gray:
        (bh, bw), = grids
        return _quantized_blocks(_pad(img, 8 * bh, 8 * bw), rec[:, 0]).ravel()
    (ybh, ybw), (cbh, cbw) = grids[0], grids[1]
    even = np.pad(img, ((0, h % 2), (0, 16 * cbw - w), (0, 0)), mode="edge")
    y, cb, cr = _ycc(even)
    ycoef = _quantized_blocks(_pad(y, 8 * ybh, 8 * ybw), rec[:, 0])
    # dummy blocks of the last MCU column and row (jccoefct compress_data)
    hib, wib = -(-h // 8), -(-w // 8)
    ycoef[:, wib:] = 0
    ycoef[hib:] = 0
    if wib < ybw:
        ycoef[:hib, wib, 0] = ycoef[:hib, wib - 1, 0]
    if hib < ybh:
        ycoef[hib, :, 0] = np.repeat(ycoef[hib - 1, 1::2, 0], 2)
    out = [ycoef.ravel()]
    bias = np.tile(np.array([1, 2], np.int64), cbw * 4)
    for p in (cb, cr):
        down = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        out.append(_quantized_blocks(_pad(down, 8 * cbh, 8 * cbw), rec[:, 1]).ravel())
    return np.concatenate(out)


def _huffman_codes(counts: list[int], symbols: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(256,) code and length of each symbol (ITU T.81 Annex C)."""
    code_of, size_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _headers(h: int, w: int, gray: bool, qt: np.ndarray) -> bytes:
    ntab = 1 if gray else 2
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [_segment(0xDB, bytes([t]) + bytes(qt[t][_ZZ].astype(np.uint8))) for t in range(ntab)]
    comps = [(1, 0x11, 0)] if gray else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out.append(_segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(comps)])
                        + b"".join(bytes(c) for c in comps)))
    for t in range(ntab):
        for cls in (0, 1):
            counts, symbols = STD_HUFFMAN[(cls, t)]
            out.append(_segment(0xC4, bytes([cls << 4 | t]) + bytes(counts) + symbols))
    sel = [(1, 0x00)] if gray else [(1, 0x00), (2, 0x11), (3, 0x11)]
    out.append(_segment(0xDA, bytes([len(sel)]) + b"".join(bytes(s) for s in sel) + b"\x00\x3f\x00"))
    return b"".join(out)


def _scan_order(h: int, w: int, gray: bool) -> tuple[np.ndarray, np.ndarray]:
    """Flat block index (into the coefficient planes) of each block in scan
    order, and its component."""
    grids = plane_grids(h, w, gray)
    if gray:
        n = grids[0][0] * grids[0][1]
        return np.arange(n), np.zeros(n, np.int64)
    (ybh, ybw), (cbh, cbw) = grids[0], grids[1]
    my, mx = np.meshgrid(np.arange(cbh), np.arange(cbw), indexing="ij")
    my, mx = my.ravel(), mx.ravel()
    ny, nc = ybh * ybw, cbh * cbw
    y = [(2 * my + dy) * ybw + 2 * mx + dx for dy in (0, 1) for dx in (0, 1)]
    idx = np.stack(y + [ny + my * cbw + mx, ny + nc + my * cbw + mx], 1).ravel()
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), len(my))
    return idx, comp


def _nbits(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while (m := a >> n).any():
        n += m > 0
    return n


def entropy_encode(coef: np.ndarray, h: int, w: int, gray: bool, quality: int = QUALITY) -> bytes:
    """The plain version of ``fce_jpeg_entropy``: quantised coefficients
    (the layout of ``jpeg_fdct_reference``) -> the JPEG file's bytes."""
    idx, comp = _scan_order(h, w, gray)
    blocks = np.asarray(coef, np.int64).reshape(-1, 64)[idx][:, _ZZ]  # scan order, zig-zag
    tab = (comp > 0).astype(np.int64)  # Huffman slot: luminance 0, chrominance 1
    codes = [[_huffman_codes(*STD_HUFFMAN[(cls, t)]) for t in (0, 1)] for cls in (0, 1)]

    def lookup(cls, sym):
        c = np.where(tab[:, None] if sym.ndim == 2 else tab, codes[cls][1][0][sym], codes[cls][0][0][sym])
        n = np.where(tab[:, None] if sym.ndim == 2 else tab, codes[cls][1][1][sym], codes[cls][0][1][sym])
        return c, n

    def bits(v, n):  # the n low bits that follow a category code: v, or v - 1 in two's complement
        return np.where(v < 0, v + (1 << n) - 1, v)

    # DC: difference from the component's previous block
    dc = blocks[:, 0]
    pred = np.zeros_like(dc)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        pred[sel[1:]] = dc[sel[:-1]]
    diff = dc - pred
    dn = _nbits(diff)
    code, size = lookup(0, dn)
    vals = np.zeros((len(blocks), 65), np.int64)
    lens = np.zeros((len(blocks), 65), np.int64)
    vals[:, 0], lens[:, 0] = (code << dn) | bits(diff, dn), size + dn
    # AC: (zero run, category) symbols, a ZRL for each 16 zeros of the run
    ac = blocks[:, 1:]
    nz = ac != 0
    k = np.arange(1, 64)
    last = np.maximum.accumulate(np.where(nz, k, 0), axis=1)  # last nonzero position at or before k
    prev = np.concatenate([np.zeros((len(ac), 1), np.int64), last[:, :-1]], 1)
    run = k - prev - 1
    an = _nbits(ac)
    code, size = lookup(1, ((run & 15) << 4) | an)
    zrl_code, zrl_len = lookup(1, np.full(ac.shape, 0xF0))
    nzrl = run >> 4
    chain = np.zeros_like(run)
    for i in range(3):
        chain = np.where(nzrl > i, (chain << zrl_len) | zrl_code, chain)
    vals[:, 1:64] = (((chain << size) | code) << an) | bits(ac, an)
    lens[:, 1:64] = nzrl * zrl_len + size + an
    eob = ~nz[:, -1]
    eob_code, eob_len = lookup(1, np.zeros(len(blocks), np.int64))
    vals[:, 64], lens[:, 64] = eob_code, eob_len
    present = np.concatenate([np.ones((len(blocks), 1), bool), nz, eob[:, None]], 1)
    vals, lens = vals[present], lens[present]
    # pack MSB first, pad the last byte with ones, stuff a zero after every 0xFF
    ends = np.cumsum(lens)
    which = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(int(ends[-1])) - (ends - lens)[which]
    stream = (vals[which] >> (lens[which] - 1 - pos)) & 1
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(stream)
    ff = data == 0xFF
    out = np.zeros(len(data) + int(ff.sum()), np.uint8)
    out[np.arange(len(data)) + np.cumsum(ff) - ff] = data
    return _headers(h, w, gray, quant_tables(quality)) + out.tobytes() + b"\xff\xd9"


def encode_jpeg_reference(img: np.ndarray, quality: int = QUALITY) -> bytes:
    """The plain path: BGR (H, W, 3) or gray (H, W) uint8 -> JPEG bytes."""
    img = np.asarray(img)
    coef = jpeg_fdct_reference(img, quality)
    return entropy_encode(coef, img.shape[0], img.shape[1], img.ndim == 2, quality)


def jpeg_fdct(img, quality: int = QUALITY):
    """Colour conversion, downsampling, forward DCT and quantisation of one
    image tensor, uint8 (H, W, 3) BGR or (H, W) gray -> int16 coefficients
    (flat, the layout of ``jpeg_fdct_reference``). A CUDA tensor launches
    ``jpeg_fdct_kernel`` on the current stream; a CPU tensor takes
    ``jpeg_fdct_reference``."""
    import torch

    if img.device.type == "cpu":
        return torch.from_numpy(jpeg_fdct_reference(img.numpy(), quality))
    if img.device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {img.device}")
    if img.dtype != torch.uint8 or img.dim() not in (2, 3) or (img.dim() == 3 and img.shape[2] != 3) \
            or not img.is_contiguous() or img.numel() == 0:
        raise ValueError(f"jpeg_fdct takes a contiguous non-empty uint8 (H, W) or (H, W, 3) tensor, not "
                         f"{img.dtype} {tuple(img.shape)}")
    from fce_yolo_tpu_torch.data.jpeg import _count
    from fce_yolo_tpu_torch.kernels import build as kbuild

    h, w = img.shape[:2]
    n = sum(bh * bw * 64 for bh, bw in plane_grids(h, w, img.dim() == 2))
    out = torch.empty(n, dtype=torch.int16, device=img.device)
    with torch.cuda.device(img.device):
        err = kbuild.library().fce_jpeg_fdct(img.data_ptr(), out.data_ptr(), h, w, 1 if img.dim() == 2 else 3,
                                             int(quality), torch.cuda.current_stream().cuda_stream)
    kbuild.check(err, "fce_jpeg_fdct")
    _count(jpeg_fdct)
    return out


def encode_jpeg(img: np.ndarray, quality: int = QUALITY, device="cuda") -> bytes:
    """BGR (H, W, 3) or gray (H, W) uint8 -> the bytes of
    ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``.

    ``device="cuda"`` (or a CUDA device): ``jpeg_fdct_kernel`` on the card,
    then ``fce_jpeg_entropy`` on the host; raises without CUDA and on a build
    or launch failure. ``device="cpu"``: the plain version."""
    import torch

    device = torch.device(device)
    img = np.ascontiguousarray(img)
    if device.type == "cpu":
        return encode_jpeg_reference(img, quality)
    if device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"JPEG writing on {device} needs CUDA, which is not available; pass device='cpu' for "
                           "the plain version")
    coef = jpeg_fdct(torch.from_numpy(img).to(device), quality).cpu()
    return entropy_encode_host(coef.numpy(), img.shape[0], img.shape[1], img.ndim == 2, quality)


def entropy_encode_host(coef: np.ndarray, h: int, w: int, gray: bool, quality: int = QUALITY) -> bytes:
    """``fce_jpeg_entropy`` (host C++, the interpreter lock released): the
    card path's counterpart of ``entropy_encode``."""
    from fce_yolo_tpu_torch.kernels import build as kbuild

    coef = np.ascontiguousarray(coef, np.int16)
    size = np.zeros(1, np.int64)
    out = np.empty(2 * coef.size + 4096, np.uint8)  # most files; a larger one asks for its size
    while (err := kbuild.library().fce_jpeg_entropy(coef.ctypes.data, h, w, 1 if gray else 3, int(quality),
                                                    out.ctypes.data, out.size, size.ctypes.data)) == _GROW:
        out = np.empty(int(size[0]), np.uint8)
    if err:
        raise RuntimeError(f"fce_jpeg_entropy: error {err}")
    return out[: int(size[0])].tobytes()


jpeg_fdct.launches = 0
