"""The VP8L (lossless WebP) decoder and the ALPH alpha plane, plain
version: Python and numpy, bit-equal to the libwebp that ``cv2.imdecode``
carries (``src/dec/vp8l_dec.c``, ``alpha_dec.c``, ``utils/huffman_utils.c``,
``dsp/lossless.c``, ``dsp/filters.c``).

VP8L (RFC 9649):

- the bit reader takes bits LSB first; reading past the data's end
  (libwebp's ``eos_``: more bits than ``8 * max(len, 8)``) fails the file;
- prefix codes: simple (1 or 2 symbols of 1 or 8 bits) or normal (the
  code-length code in ``CODE_LENGTH_ORDER``, repeat codes 16/17/18, an
  optional ``max_symbol``); a code must be complete unless one symbol alone
  has a length, which then takes no bits (libwebp's ``BuildHuffmanTable``);
- the meta prefix-code image (groups of five codes by tile), the colour
  cache (hash ``0x1e35a7bd * argb >> (32 - bits)``), LZ77 copies with the
  length/distance prefix codes and the 120-entry distance map;
- the four transforms, undone in reverse order: predictor (14 modes,
  libwebp's ``Select``, ``ClampedAddSubtract*``, modes 14 and 15 as mode 0),
  cross-colour, subtract-green and colour-indexing (a delta-coded palette,
  entries past it transparent black, 1/2/4-bit indices bundled LSB first).

The output is ARGB as uint32 (H, W). ALPH (``decode_alpha``): raw or a VP8L
stream of the frame's size without header, whose green channel is alpha,
then libwebp's horizontal, vertical or gradient unfilter. A stream with only
the colour-indexing transform, no colour cache and single-symbol red, blue
and alpha codes is read as libwebp's 8-bit path reads it: running out of
data on its last pixel is not an error there. Anything libwebp refuses
raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["decode_vp8l", "decode_alpha", "vp8l_info", "VP8LError"]


class VP8LError(ValueError):
    """A VP8L or ALPH stream that libwebp refuses."""


CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# RFC 9649 section 4.2.2: distance code -> (dy << 4) | (8 - dx)
CODE_TO_PLANE = bytes([
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
])
ALPHABET = (256 + 24, 256, 256, 256, 40)  # green + lengths (+ cache), red, blue, alpha, distance
GREEN, RED, BLUE, ALPHA, DIST = range(5)
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)


class _Bits:
    """libwebp's VP8LBitReader: ``pos`` counts the bits read; past
    ``limit`` the stream has ended (``eos_``)."""

    __slots__ = ("buf", "pos", "limit")

    def __init__(self, data: bytes):
        self.buf = bytes(data) + bytes(8)
        self.pos = 0
        self.limit = 8 * max(len(data), 8)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (int.from_bytes(self.buf[p >> 3: (p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)

    def eos(self) -> bool:
        return self.pos > self.limit


def _sub_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


class _Code:
    """A prefix code as a lookup table over the next ``bits`` bits."""

    __slots__ = ("sym", "len", "bits")

    def __init__(self, lengths: list[int]):
        count = [0] * 16
        for n in lengths:
            if n > 15:
                raise VP8LError("a code length above 15")
            count[n] += 1
        if count[0] == len(lengths):
            raise VP8LError("a prefix code with no symbol")
        if sum(count[1:]) == 1:  # one symbol: it takes no bits
            s = next(i for i, n in enumerate(lengths) if n)
            self.sym, self.len, self.bits = [s], [0], 0
            return
        left = 1
        for n in range(1, 16):
            left = 2 * left - count[n]
            if left < 0:
                raise VP8LError("an over-subscribed prefix code")
        if left != 0:
            raise VP8LError("an incomplete prefix code")
        bits = max(n for n in lengths if n)
        size = 1 << bits
        sym, ln = [0] * size, [0] * size
        code = 0
        for n in range(1, bits + 1):
            for s, m in enumerate(lengths):
                if m != n:
                    continue
                rev = int(f"{code:0{n}b}"[::-1], 2)
                step = 1 << n
                k = size >> n
                sym[rev::step] = [s] * k
                ln[rev::step] = [n] * k
                code += 1
            code <<= 1
        self.sym, self.len, self.bits = sym, ln, bits


def _read_symbol(code: _Code, br: _Bits) -> int:
    if code.bits == 0:
        return code.sym[0]
    p = br.pos
    w = (int.from_bytes(br.buf[p >> 3: (p >> 3) + 4], "little") >> (p & 7)) & ((1 << code.bits) - 1)
    br.pos = p + code.len[w]
    return code.sym[w]


def _code_lengths(br: _Bits, cl_lengths: list[int], num_symbols: int) -> list[int]:
    """ReadHuffmanCodeLengths."""
    table = _Code(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > num_symbols:
            raise VP8LError("max_symbol above the alphabet")
    else:
        max_symbol = num_symbols
    out = [0] * num_symbols
    prev = 8
    s = 0
    while s < num_symbols:
        if max_symbol == 0:
            break
        max_symbol -= 1
        n = _read_symbol(table, br)
        if n < 16:
            out[s] = n
            s += 1
            if n:
                prev = n
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
            repeat = br.read(extra) + offset
            if s + repeat > num_symbols:
                raise VP8LError("a repeated code length past the alphabet")
            out[s: s + repeat] = [prev if n == 16 else 0] * repeat
            s += repeat
    return out


def _read_code(br: _Bits, alphabet: int) -> _Code:
    """ReadHuffmanCode: a simple or a normal prefix code."""
    if br.read(1):  # simple
        lengths = [0] * max(alphabet, 256)
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        lengths = lengths[:alphabet]
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_ORDER[i]] = br.read(3)
        lengths = _code_lengths(br, cl, alphabet)
    if br.eos():
        raise VP8LError("data ends inside a prefix code")
    return _Code(lengths)


class _Stream:
    """One image stream's entropy state: groups of codes, their tile image
    and the colour cache."""

    def __init__(self, br: _Bits, xs: int, ys: int, top: bool):
        self.cache_bits = 0
        if br.read(1):
            self.cache_bits = br.read(4)
            if not 1 <= self.cache_bits <= 11:
                raise VP8LError("a colour cache of bits outside 1-11")
        self.hbits, self.himg, self.hxs = 0, None, 0
        n_groups = 1
        if top and br.read(1):  # the meta prefix-code image
            self.hbits = br.read(3) + 2
            self.hxs = _sub_size(xs, self.hbits)
            img = _decode_image(br, self.hxs, _sub_size(ys, self.hbits), False)
            self.himg = [(p >> 8) & 0xFFFF for p in img]
            n_groups = max(self.himg) + 1
        extra = (1 << self.cache_bits) if self.cache_bits else 0
        self.groups = [[_read_code(br, ALPHABET[j] + (extra if j == 0 else 0)) for j in range(5)]
                       for _ in range(n_groups)]

    def group(self, x: int, y: int) -> list[_Code]:
        if self.himg is None:
            return self.groups[0]
        return self.groups[self.himg[(y >> self.hbits) * self.hxs + (x >> self.hbits)]]


def _prefix_value(sym: int, br: _Bits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xs: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * xs + 8 - (d & 0xF)
    return dist if dist >= 1 else 1


def _decode_pixels(br: _Bits, st: _Stream, xs: int, ys: int, alpha8: bool = False) -> list[int]:
    """DecodeImageData (or DecodeAlphaData when ``alpha8``): the LZ77 /
    cache-coded pixels of one stream."""
    total = xs * ys
    out = [0] * total
    cache_bits = st.cache_bits
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    last_cached = 0
    pos = x = y = 0
    while pos < total:
        g = st.group(x, y)
        code = _read_symbol(g[GREEN], br)
        if code < 256:
            if alpha8:
                out[pos] = code
            else:
                red = _read_symbol(g[RED], br)
                blue = _read_symbol(g[BLUE], br)
                alpha = _read_symbol(g[ALPHA], br)
                out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            x += 1
            if x >= xs:
                x, y = 0, y + 1
        elif code < 280:
            length = _prefix_value(code - 256, br)
            dist = _plane_distance(xs, _prefix_value(_read_symbol(g[DIST], br), br))
            if br.eos() and not alpha8:
                break
            if pos < dist or total - pos < length:
                raise VP8LError("a backward reference outside the image")
            for k in range(pos, pos + length):
                out[k] = out[k - dist]
            pos += length
            x += length
            while x >= xs:
                x, y = x - xs, y + 1
        elif code < cache_limit and not alpha8:
            while last_cached < pos:
                p = out[last_cached]
                cache[((0x1E35A7BD * p) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
            out[pos] = cache[code - 280]
            pos += 1
            x += 1
            if x >= xs:
                x, y = 0, y + 1
        else:
            raise VP8LError("a colour-cache code without a colour cache")
        if br.eos():
            break
        if cache is not None and x == 0:
            while last_cached < pos:
                p = out[last_cached]
                cache[((0x1E35A7BD * p) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
    if br.eos() and (pos < total or not alpha8):
        raise VP8LError("the data ends before the image does")
    return out


def _decode_image(br: _Bits, xs: int, ys: int, top: bool) -> list[int]:
    """DecodeImageStream of a sub-image (entropy or transform image)."""
    st = _Stream(br, xs, ys, top)
    return _decode_pixels(br, st, xs, ys)


def _read_transforms(br: _Bits, xs: int, ys: int) -> tuple[list[tuple], int]:
    seen = 0
    transforms = []
    while br.read(1):
        t = br.read(2)
        if seen & (1 << t):
            raise VP8LError("a transform used twice")
        seen |= 1 << t
        if t in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            data = _decode_image(br, _sub_size(xs, bits), _sub_size(ys, bits), False)
            transforms.append((t, xs, bits, data))
        elif t == COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 0 if n > 16 else (1 if n > 4 else (2 if n > 2 else 3))
            pal = _decode_image(br, n, 1, False)
            transforms.append((t, xs, bits, _expand_palette(pal, bits)))
            xs = _sub_size(xs, bits)
        else:
            transforms.append((t, xs, 0, None))
        if br.eos():
            raise VP8LError("data ends inside a transform")
    return transforms, xs


def _expand_palette(pal: list[int], bits: int) -> np.ndarray:
    """ExpandColorMap: the palette's deltas summed byte by byte, then
    transparent black up to 2 ** (8 >> bits) entries."""
    raw = np.array(pal, np.uint32).view(np.uint8).reshape(-1, 4)
    out = np.zeros((1 << (8 >> bits), 4), np.uint8)
    out[: len(pal)] = np.cumsum(raw, axis=0, dtype=np.uint32).astype(np.uint8)
    return out.view(np.uint32).ravel()


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(t: int, l_: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        a, b, c = (t >> sh) & 0xFF, (l_ >> sh) & 0xFF, (tl >> sh) & 0xFF
        s += abs(b - c) - abs(a - c)
    return t if s <= 0 else l_


def _clamp_full(a: int, b: int, c: int) -> int:
    out = 0
    for sh in (24, 16, 8, 0):
        v = ((a >> sh) & 0xFF) + ((b >> sh) & 0xFF) - ((c >> sh) & 0xFF)
        out |= (0 if v < 0 else (255 if v > 255 else v)) << sh
    return out


def _clamp_half(a: int, b: int) -> int:
    out = 0
    for sh in (24, 16, 8, 0):
        x, y = (a >> sh) & 0xFF, (b >> sh) & 0xFF
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))  # C division truncates
        out |= (0 if v < 0 else (255 if v > 255 else v)) << sh
    return out


def _predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:
        return _select(T, L, TL)
    if mode == 12:
        return _clamp_full(L, T, TL)
    if mode == 13:
        return _clamp_half(_avg(L, T), TL)
    return 0xFF000000  # mode 0, and 14 and 15 as libwebp's sentinels


def _inverse(tr: tuple, pix: np.ndarray, ys: int) -> np.ndarray:
    """One transform undone: uint32 pixels (ys, xs of the transform's input)
    -> uint32 (ys, xs of its output)."""
    t, xs, bits, data = tr
    if t == SUBTRACT_GREEN:
        g = (pix >> 8) & 0xFF
        r = (((pix >> 16) & 0xFF) + g) & 0xFF
        b = ((pix & 0xFF) + g) & 0xFF
        return (pix & 0xFF00FF00) | (r << 16) | b
    if t == CROSS_COLOR:
        tw = _sub_size(xs, bits)
        m = np.array(data, np.uint32).reshape(-1, tw)
        m = np.repeat(np.repeat(m, 1 << bits, 0), 1 << bits, 1)[:ys, :xs]
        g2r = (m & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        g2b = ((m >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        r2b = ((m >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        green = ((pix >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        red = ((pix >> 16) & 0xFF).astype(np.int32)
        red = (red + ((g2r * green) >> 5)) & 0xFF
        blue = (pix & 0xFF).astype(np.int32) + ((g2b * green) >> 5)
        blue = (blue + ((r2b * red.astype(np.uint8).view(np.int8).astype(np.int32)) >> 5)) & 0xFF
        return (pix & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)
    if t == COLOR_INDEXING:
        idx = ((pix >> 8) & 0xFF).astype(np.int64)
        if bits:
            per = 1 << bits
            bpp = 8 >> bits
            shifts = np.arange(per) * bpp
            idx = ((idx[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(ys, -1)[:, :xs]
        return data[idx]
    # predictor: sequential within a row
    tw = _sub_size(xs, bits)
    modes = [(m >> 8) & 0xF for m in data]
    src = pix.ravel().tolist()
    out = [0] * (xs * ys)
    out[0] = _add(src[0], 0xFF000000)
    for x in range(1, xs):
        out[x] = _add(src[x], out[x - 1])
    for y in range(1, ys):
        r = y * xs
        out[r] = _add(src[r], out[r - xs])
        mrow = (y >> bits) * tw
        for x in range(1, xs):
            i = r + x
            T = out[i - xs]
            out[i] = _add(src[i], _predict(modes[mrow + (x >> bits)], out[i - 1], T, out[i - xs + 1], out[i - xs - 1]))
    return np.array(out, np.uint32).reshape(ys, xs)


def vp8l_info(data: bytes) -> tuple[int, int, int] | None:
    """VP8LGetInfo: (width, height, alpha bit), or None when the data is not
    a VP8L stream libwebp takes."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5 != 0:
        return None
    bits = int.from_bytes(data[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _decode_stream(br: _Bits, xs: int, ys: int, alpha: bool = False) -> np.ndarray:
    """The level-0 image of a VP8L stream (after its header) -> uint32
    ARGB (ys, xs), or for ``alpha`` the uint8 green plane."""
    transforms, txs = _read_transforms(br, xs, ys)
    st = _Stream(br, txs, ys, True)
    alpha8 = (alpha and len(transforms) == 1 and transforms[0][0] == COLOR_INDEXING and not st.cache_bits
              and all(g[c].bits == 0 for g in st.groups for c in (RED, BLUE, ALPHA)))
    pix = np.array(_decode_pixels(br, st, txs, ys, alpha8), np.uint32).reshape(ys, txs)
    if alpha8:
        pix = pix << 8  # the index sits in green
    for tr in reversed(transforms):
        pix = _inverse(tr, pix, ys)
    return pix


def decode_vp8l(data: bytes, name: str = "<vp8l>") -> np.ndarray:
    """A VP8L stream (the payload of a ``VP8L`` chunk and whatever follows
    it in the buffer, as libwebp reads it) -> ARGB uint32 (H, W)."""
    br = _Bits(data)
    try:
        if br.read(8) != 0x2F:
            raise VP8LError("not a VP8L stream")
        w, h = br.read(14) + 1, br.read(14) + 1
        br.read(1)
        if br.read(3) != 0:
            raise VP8LError("a VP8L version other than 0")
        return _decode_stream(br, w, h)
    except VP8LError as e:
        raise VP8LError(f"{name}: {e}") from None


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's HorizontalUnfilter / VerticalUnfilter / GradientUnfilter,
    row by row (the first row of each is horizontal from 0)."""
    if method == 0:
        return a
    h, w = a.shape
    out = np.zeros((h, w), np.uint8)
    out[0] = np.cumsum(a[0], dtype=np.uint32).astype(np.uint8)
    for y in range(1, h):
        prev = out[y - 1]
        if method == 1:
            row = a[y].astype(np.uint32)
            row[0] += prev[0]
            out[y] = np.cumsum(row).astype(np.uint8)
        elif method == 2:
            out[y] = a[y] + prev
        else:
            left = top_left = int(prev[0])
            row = a[y].tolist()
            pv = prev.tolist()
            for x in range(w):
                top = pv[x]
                g = left + top - top_left
                left = (row[x] + (0 if g < 0 else (255 if g > 255 else g))) & 0xFF
                top_left = top
                row[x] = left
            out[y] = row
    return out


def decode_alpha(data: bytes, w: int, h: int, name: str = "<alph>") -> np.ndarray:
    """An ALPH chunk's payload for a w x h frame -> uint8 alpha (h, w)."""
    if len(data) <= 1:
        raise VP8LError(f"{name}: an empty ALPH chunk")
    method, filt, pre, rsrv = data[0] & 3, (data[0] >> 2) & 3, (data[0] >> 4) & 3, data[0] >> 6
    if method > 1 or pre > 1 or rsrv != 0:
        raise VP8LError(f"{name}: an ALPH chunk of an unknown method or reserved bits set")
    if method == 0:
        if len(data) - 1 < w * h:
            raise VP8LError(f"{name}: a raw ALPH chunk shorter than its frame")
        a = np.frombuffer(data, np.uint8, w * h, 1).reshape(h, w)
    else:
        try:
            a = ((_decode_stream(_Bits(data[1:]), w, h, alpha=True) >> 8) & 0xFF).astype(np.uint8)
        except VP8LError as e:
            raise VP8LError(f"{name}: alpha: {e}") from None
    return _unfilter(a, filt)
