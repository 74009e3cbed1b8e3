"""Zstandard decoder (RFC 8878), plain Python and numpy.

The plain version of ``csrc/zstd.cu``'s ``fce_zstd_decompress``: the two
decode the same frames step for step. ``decompress(data, device)`` runs
this one for a CPU ``device`` and the C++ one for ``cuda`` (raising if its
build or its call fails). Orbax writes every checkpoint node and every
array chunk as a zstd frame (``utils/ocdbt.py``, ``utils/zarr.py``).

Covered: frames with or without a content size, single-segment frames,
window descriptors, frames back to back, skippable frames; raw, RLE and
compressed blocks; raw, RLE, compressed and treeless literals in 1 or 4
Huffman streams; predefined, RLE, FSE and repeat sequence tables, the
repeat offsets and the tables carried from block to block within a frame;
the optional XXH64 content checksum. A frame that needs a dictionary
raises ``ValueError`` naming its id; a malformed one names the byte offset.

``COUNTS`` counts the block, literals and sequence kinds met (keys as
``"block_rle"``, ``"literals_treeless"``, ``"literals_4_streams"``,
``"sequences_repeat"``), so a test can show which it covered.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

__all__ = ["COUNTS", "decompress", "decompress_plain"]

COUNTS: Counter = Counter()

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50  # the top 28 bits; the low 4 are free
BLOCK_MAX = 128 << 10
WINDOW_MAX = 1 << 31  # what this decoder accepts; libzstd's decoder also stops at 2^31 (windowLog 31)

# literal-length and match-length codes: (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6), (128, 7),
    (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4), (99, 5), (131, 7),
    (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# predefined distributions (RFC 8878 3.1.1.3.2.2): counts, accuracy log
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# (max symbol, max accuracy log) of each sequence field
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)


def _bad(at: int, what: str) -> ValueError:
    return ValueError(f"zstd: malformed frame at byte {at}: {what}")


class _Forward:
    """Bits read from the start, least significant first (FSE table headers)."""

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.start, self.end, self.bit = buf, start, end, 0

    def peek(self, n: int) -> int:
        i = self.start + (self.bit >> 3)
        return (int.from_bytes(self.buf[i:i + 4], "little") >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.start + ((self.bit + 7) >> 3) > self.end:
            raise _bad(self.end, "a table description runs past its block")

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.skip(n)
        return v

    def size(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A bitstream read from its end (FSE and Huffman streams): the last
    byte's highest set bit marks the end; bits are read from the most
    significant down. Reading past the start gives zeros and leaves
    ``left`` negative (the reference decoder's "overflow")."""

    def __init__(self, buf: bytes, start: int, end: int):
        if end <= start or buf[end - 1] == 0:
            raise _bad(end - 1, "a bitstream without its end mark")
        self.buf, self.start = buf, start
        self.left = (end - start) * 8 - 8 + buf[end - 1].bit_length() - 1  # bits not yet read

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        lo = self.left - n  # the lowest bit taken
        self.left = lo
        if lo >= 0:
            i = self.start + (lo >> 3)
            return (int.from_bytes(self.buf[i:i + 8], "little") >> (lo & 7)) & ((1 << n) - 1)
        if lo + n <= 0:
            return 0
        return (int.from_bytes(self.buf[self.start:self.start + 8], "little") << -lo) & ((1 << n) - 1)


def _read_ncount(buf: bytes, start: int, end: int, max_symbol: int, max_log: int) -> tuple[list[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1) -> (normalized counts,
    accuracy log, bytes read)."""
    r = _Forward(buf, start, end)
    log = r.read(4) + 5
    if log > max_log:
        raise _bad(start, f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise _bad(start, "an FSE table with too many symbols")
        mx = 2 * threshold - 1 - remaining
        v = r.peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            r.skip(nbits - 1)
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            r.skip(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = r.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise _bad(start, "an FSE table with too many symbols")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise _bad(start, "FSE counts that do not fill the table")
    return counts, log, r.size()


def _fse_table(counts: list[int], log: int) -> tuple[list[int], list[int], list[int]]:
    """Decoding table of normalized ``counts``: per state (symbol, bits to
    read, baseline of the next state)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: malformed FSE table (the spread does not return to 0)")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        b = log - (n.bit_length() - 1)
        nbits[u] = b
        base[u] = (n << b) - size
    return symbol, nbits, base


def _rle_table(sym: int) -> tuple[list[int], list[int], list[int], int]:
    return [sym], [0], [0], 0


def _huffman_weights(buf: bytes, pos: int, end: int) -> tuple[list[int], int]:
    """The Huffman tree description -> (weights of every symbol, bytes read)."""
    if pos >= end:
        raise _bad(pos, "a Huffman tree description past its block")
    hb = buf[pos]
    if hb >= 128:  # direct: 4 bits a weight
        n = hb - 127
        size = 1 + (n + 1) // 2
        if pos + size > end:
            raise _bad(pos, "Huffman weights past their block")
        weights = []
        for i in range(n):
            b = buf[pos + 1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
        return weights, size
    size = 1 + hb
    if hb == 0 or pos + size > end:
        raise _bad(pos, "FSE-compressed Huffman weights past their block")
    counts, log, used = _read_ncount(buf, pos + 1, pos + size, 255, 6)
    symbol, nbits, base = _fse_table(counts, log)
    r = _Backward(buf, pos + 1 + used, pos + size)
    s1, s2 = r.read(log), r.read(log)
    weights = []
    while True:
        if len(weights) > 255:
            raise _bad(pos, "more than 255 Huffman weights")
        weights.append(symbol[s1])
        s1 = base[s1] + r.read(nbits[s1])
        if r.left < 0:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + r.read(nbits[s2])
        if r.left < 0:
            weights.append(symbol[s1])
            break
    if len(weights) > 255:
        raise _bad(pos, "more than 255 Huffman weights")
    return weights, size


def _huffman_table(weights: list[int], at: int) -> tuple[list[int], list[int], int]:
    """Weights -> (symbol, code length) per value of the ``log`` bits a
    lookup peeks, and ``log`` (the longest code)."""
    if any(w > 11 for w in weights):
        raise _bad(at, "a Huffman weight above 11")
    total = sum(1 << w >> 1 for w in weights)
    if total == 0:
        raise _bad(at, "Huffman weights all zero")
    log = total.bit_length()  # the longest code: the next power of two above the sum
    if log > 11:
        raise _bad(at, "a Huffman code longer than 11 bits")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise _bad(at, "Huffman weights that leave no power of two for the last symbol")
    weights = weights + [rest.bit_length()]
    rank = [0] * (log + 2)
    for w in weights:
        rank[w] += 1
    start, nxt = [0] * (log + 2), 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += rank[w] << (w - 1)
    size = 1 << log
    symbol, length = [0] * size, [0] * size
    for s, w in enumerate(weights):
        if w == 0:
            continue
        n = (1 << w) >> 1
        p = start[w]
        symbol[p:p + n] = [s] * n
        length[p:p + n] = [log + 1 - w] * n
        start[w] += n
    return symbol, length, log


def _huffman_stream(buf: bytes, start: int, end: int, count: int, table) -> bytes:
    """``count`` symbols of the Huffman stream ``buf[start:end]``. A symbol
    is the lookup of the ``log`` bits below the read position, so the lookup
    is made for every bit position at once (numpy); the walk from position
    to position (``position -= code length``) is serial. Past the start the
    walk falls into a sink of zero-length entries at the lists' end (index
    -1 .. -11), and the stream must end exactly on its last symbol."""
    symbol, length, log = table
    left = _Backward(buf, start, end).left
    b = np.zeros(end - start + 3, np.int32)
    b[:end - start] = np.frombuffer(buf, np.uint8, end - start, start)
    words = b[:-2] | (b[1:-1] << 8) | (b[2:] << 16)  # 24 bits from each byte on
    q = np.arange(left + 1, dtype=np.int32) - log  # the lowest bit of the lookup at each position
    qc = np.maximum(q, 0)
    v = (words[qc >> 3] >> (qc & 7)) & ((1 << log) - 1)
    low = q < 0  # near the start: the bits there, zeros below
    v[low] = (words[0] & ((1 << (q[low] + log)) - 1)) << -q[low]
    sym_at = np.asarray(symbol, np.uint8)[v].tolist() + [0] * 11
    len_at = np.asarray(length, np.uint8)[v].tolist() + [0] * 11
    out = bytearray(count)
    p = left
    for k in range(count):
        out[k] = sym_at[p]
        p -= len_at[p]
    if p != 0:
        raise _bad(start, "a Huffman stream that does not end on its last symbol")
    return bytes(out)


class _FrameState:
    """What carries from block to block within a frame."""

    def __init__(self):
        self.huffman = None
        self.tables: list = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


_DEFAULT_TABLES = None


def _default_tables():
    global _DEFAULT_TABLES
    if _DEFAULT_TABLES is None:
        _DEFAULT_TABLES = [(*_fse_table(c, log), log) for c, log in (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT)]
    return _DEFAULT_TABLES


def _literals(buf: bytes, pos: int, end: int, st: _FrameState) -> tuple[bytes, int]:
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        hsize = (1, 2, 1, 3)[fmt]
        if pos + hsize > end:
            raise _bad(pos, "a literals header past its block")
        c = int.from_bytes(buf[pos:pos + hsize], "little")
        size = c >> 3 if hsize == 1 else c >> 4
        if size > BLOCK_MAX:
            raise _bad(pos, "literals above the block size")
        if kind == 0:
            COUNTS["literals_raw"] += 1
            if pos + hsize + size > end:
                raise _bad(pos, "raw literals past their block")
            return bytes(buf[pos + hsize:pos + hsize + size]), hsize + size
        COUNTS["literals_rle"] += 1
        if pos + hsize >= end:
            raise _bad(pos, "RLE literals past their block")
        return bytes([buf[pos + hsize]]) * size, hsize + 1
    hsize = (3, 3, 4, 5)[fmt]
    if pos + hsize > end:
        raise _bad(pos, "a literals header past its block")
    c = int.from_bytes(buf[pos:pos + hsize], "little")
    bits = (10, 10, 14, 18)[fmt]
    size, csize = (c >> 4) & ((1 << bits) - 1), (c >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    if size > BLOCK_MAX:
        raise _bad(pos, "literals above the block size")
    p, stop = pos + hsize, pos + hsize + csize
    if stop > end:
        raise _bad(pos, "compressed literals past their block")
    if kind == 2:
        COUNTS["literals_compressed"] += 1
        weights, used = _huffman_weights(buf, p, stop)
        st.huffman = _huffman_table(weights, p)
        p += used
    else:
        COUNTS["literals_treeless"] += 1
        if st.huffman is None:
            raise _bad(pos, "treeless literals without an earlier Huffman table")
    COUNTS[f"literals_{streams}_stream{'s' if streams > 1 else ''}"] += 1
    if streams == 1:
        return _huffman_stream(buf, p, stop, size, st.huffman), hsize + csize
    if p + 6 > stop:
        raise _bad(p, "a jump table past its literals")
    s1, s2, s3 = (int.from_bytes(buf[p + 2 * i:p + 2 * i + 2], "little") for i in range(3))
    p += 6
    each = (size + 3) // 4
    if each * 3 > size or p + s1 + s2 + s3 > stop:
        raise _bad(p, "a jump table that does not fit its literals")
    bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, stop]
    parts = [_huffman_stream(buf, bounds[i], bounds[i + 1], each if i < 3 else size - 3 * each, st.huffman)
             for i in range(4)]
    return b"".join(parts), hsize + csize


def _seq_table(mode: int, buf: bytes, pos: int, end: int, which: int, st: _FrameState) -> int:
    """Set field ``which`` (0 LL, 1 OF, 2 ML)'s table from its mode; returns the bytes read."""
    name = ("predefined", "rle", "fse", "repeat")[mode]
    COUNTS[f"sequences_{name}"] += 1
    max_symbol, max_log = (LL_MAX, OF_MAX, ML_MAX)[which]
    if mode == 0:
        st.tables[which] = _default_tables()[which]
        return 0
    if mode == 1:
        if pos >= end:
            raise _bad(pos, "an RLE sequence code past its block")
        if buf[pos] > max_symbol:
            raise _bad(pos, f"sequence code {buf[pos]} above {max_symbol}")
        st.tables[which] = _rle_table(buf[pos])
        return 1
    if mode == 2:
        counts, log, used = _read_ncount(buf, pos, end, max_symbol, max_log)
        st.tables[which] = (*_fse_table(counts, log), log)
        return used
    if st.tables[which] is None:
        raise _bad(pos, "a repeated sequence table without an earlier one")
    return 0


def _sequences(buf: bytes, pos: int, end: int, st: _FrameState, lits: bytes, out: bytearray, frame_start: int,
               window: int) -> None:
    """Decode the sequences section and execute it onto ``out``."""
    if pos >= end:
        raise _bad(pos, "a block without its sequences section")
    b0 = buf[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise _bad(pos, "a sequences header past its block")
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise _bad(pos, "a sequences header past its block")
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise _bad(pos, "bytes after an empty sequences section")
        out += lits
        return
    if pos >= end:
        raise _bad(pos, "a sequences header past its block")
    modes = buf[pos]
    if modes & 3:
        raise _bad(pos, "reserved bits set in the sequence modes")
    pos += 1
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        pos += _seq_table((modes >> shift) & 3, buf, pos, end, which, st)
    (lsym, lnb, lbase, llog), (osym, onb, obase, olog), (msym, mnb, mbase, mlog) = st.tables
    r = _Backward(buf, pos, end)
    ls, os_, ms = r.read(llog), r.read(olog), r.read(mlog)
    rep = st.rep
    lp = 0
    for i in range(nseq):
        lc, oc, mc = lsym[ls], osym[os_], msym[ms]
        if oc > 31:
            raise _bad(pos, f"offset code {oc}")
        ov = (1 << oc) + r.read(oc)
        mb, mx = ML_CODES[mc]
        ml = mb + r.read(mx)
        lb, lx = LL_CODES[lc]
        ll = lb + r.read(lx)
        if ov > 3:
            off = ov - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 3:
                off = rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
            else:
                off = rep[idx]
                if idx == 2:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], off
        if i + 1 < nseq:
            ls = lbase[ls] + r.read(lnb[ls])
            ms = mbase[ms] + r.read(mnb[ms])
            os_ = obase[os_] + r.read(onb[os_])
        if r.left < 0:
            raise _bad(pos, "a sequence bitstream read past its start")
        if lp + ll > len(lits):
            raise _bad(pos, "a sequence asks for more literals than the block has")
        out += lits[lp:lp + ll]
        lp += ll
        have = len(out) - frame_start
        if off == 0 or off > have or off > window:
            raise _bad(pos, f"match offset {off} reaches before the frame or the window")
        src = len(out) - off
        if off >= ml:
            out += out[src:src + ml]
        else:  # the match overlaps what it writes: repeat the last ``off`` bytes
            piece = bytes(out[src:])
            out += (piece * (ml // off + 1))[:ml]
    if r.left != 0:
        raise _bad(pos, f"a sequence bitstream with {r.left} bits left")
    out += lits[lp:]


_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                           0x27D4EB2F165667C5)
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the frame checksum keeps its low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        lanes = np.frombuffer(data, "<u8", count=(n // 32) * 4).reshape(-1, 4).tolist()
        for row in lanes:
            v = [_round(v[j], row[j]) for j in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for j in range(4):
            h = ((h ^ _round(0, v[j])) * _P1 + _P4) & _M64
        p = (n // 32) * 32
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def _frame(buf: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``pos`` onto ``out``; returns the position after it."""
    start = pos
    if pos + 5 > len(buf):
        raise _bad(pos, "a frame header cut short")
    fhd = buf[pos + 4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise _bad(pos + 4, "the reserved bit of the frame header is set")
    pos += 5
    window = 0
    if not single:
        wd = buf[pos]
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
        pos += 1
    dsize = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(buf[pos:pos + dsize], "little")
    pos += dsize
    if dict_id:
        raise ValueError(f"zstd: the frame at byte {start} needs dictionary {dict_id}, which this decoder does not "
                         "have")
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fsize:
        content = int.from_bytes(buf[pos:pos + fsize], "little") + (256 if fsize == 2 else 0)
        pos += fsize
    if pos > len(buf):
        raise _bad(start, "a frame header cut short")
    if single:
        window = content
    if window > WINDOW_MAX:
        raise _bad(start, f"window of {window} bytes above {WINDOW_MAX}")
    block_max = min(window, BLOCK_MAX)
    st = _FrameState()
    frame_start = len(out)
    while True:
        if pos + 3 > len(buf):
            raise _bad(pos, "a block header cut short")
        h = int.from_bytes(buf[pos:pos + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        pos += 3
        if kind == 3:
            raise _bad(pos - 3, "a reserved block type")
        if size > block_max:
            raise _bad(pos - 3, f"a block of {size} bytes above the block size {block_max}")
        if kind == 0:
            COUNTS["block_raw"] += 1
            if pos + size > len(buf):
                raise _bad(pos, "a raw block cut short")
            out += buf[pos:pos + size]
            pos += size
        elif kind == 1:
            COUNTS["block_rle"] += 1
            if pos >= len(buf):
                raise _bad(pos, "an RLE block cut short")
            out += bytes([buf[pos]]) * size
            pos += 1
        else:
            COUNTS["block_compressed"] += 1
            end = pos + size
            if end > len(buf):
                raise _bad(pos, "a compressed block cut short")
            if size < 1:
                raise _bad(pos, "an empty compressed block")
            lits, used = _literals(buf, pos, end, st)
            before = len(out)
            _sequences(buf, pos + used, end, st, lits, out, frame_start, window)
            if len(out) - before > BLOCK_MAX:
                raise _bad(pos, "a block that decodes to more than 128 KiB")
            pos = end
        if content is not None and len(out) - frame_start > content:
            raise _bad(pos, "a frame longer than its content size")
        if last:
            break
    if content is not None and len(out) - frame_start != content:
        raise _bad(pos, f"a frame of {len(out) - frame_start} bytes where its header says {content}")
    if checksum:
        COUNTS["frame_checksum"] += 1
        if pos + 4 > len(buf):
            raise _bad(pos, "a checksum cut short")
        want = int.from_bytes(buf[pos:pos + 4], "little")
        if xxh64(bytes(out[frame_start:])) & 0xFFFFFFFF != want:
            raise _bad(pos, "the content checksum does not match")
        pos += 4
    COUNTS["frame"] += 1
    return pos


def decompress_plain(data: bytes) -> bytes:
    """Decode every frame of ``data``, skipping skippable frames."""
    buf = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise _bad(pos, "bytes after the last frame")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            COUNTS["skippable"] += 1
            if pos + 8 > len(buf):
                raise _bad(pos, "a skippable frame cut short")
            pos += 8 + int.from_bytes(buf[pos + 4:pos + 8], "little")
            if pos > len(buf):
                raise _bad(len(buf), "a skippable frame cut short")
            continue
        if magic != MAGIC:
            raise _bad(pos, f"magic {magic:#010x} is not a zstd frame's")
        try:
            pos = _frame(buf, pos, out)
        except IndexError:
            raise _bad(len(buf), "a frame cut short") from None
    return bytes(out)


def decompress(data: bytes, device="cpu", size_hint: int | None = None) -> bytes:
    """Decode ``data`` (frames back to back) in Python for a CPU ``device``,
    or with ``csrc/zstd.cu``'s ``fce_zstd_decompress`` on the host for a
    CUDA one (raising if it cannot be built or fails). ``size_hint`` is the
    room to try first (the C++ path grows it when a frame needs more)."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return decompress_plain(data)
    if device.type != "cuda":
        raise ValueError(f"no zstd decoder for device {device}")
    return decompress_host(data, size_hint)


def decompress_host(data: bytes, size_hint: int | None = None) -> bytes:
    """``fce_zstd_decompress``: the C++ decoder (host code in the kernel
    libraries). It returns 0 and the decoded size, -1 and the room it needs
    when ``out`` is too small (it is called again with that room), -2 for a
    malformed frame, -3 for one that needs a dictionary; the message names
    the byte offset or the dictionary id."""
    import ctypes

    from fce_yolo_tpu_torch.kernels import build as kbuild

    src = bytes(data)
    room = max(size_hint or 0, 4 * len(src) + 1024)
    info = np.zeros(2, np.int64)
    msg = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(room, np.uint8)
        rc = kbuild.library().fce_zstd_decompress(src, len(src), out.ctypes.data, room, info.ctypes.data, msg,
                                                  len(msg))
        decompress_host.launches += 1
        if rc == 0:
            return out[:int(info[0])].tobytes()
        if rc == -1 and int(info[0]) > room:
            room = int(info[0])
            continue
        raise ValueError(f"zstd: {msg.value.decode(errors='replace')}")


decompress_host.launches = 0
