// Zstandard decoder (RFC 8878), host C++ (no device code). The plain
// version, step for step the same, is decompress_plain in
// fce_yolo_tpu_torch/utils/zstd.py (Python); this is its fast twin for the
// card's machine, built into the kernel libraries by nvcc as every csrc/*.cu
// is (plain C interface, ctypes; reentrant, no globals). Orbax writes every
// checkpoint node and array chunk as a zstd frame; each Huffman symbol and
// each sequence depends on the bits before it, so there is nothing for the
// card to do in parallel: the decoded arrays go to the card as tensors.
//
// Frames back to back (skippable ones skipped), raw/RLE/compressed blocks,
// raw/RLE/compressed/treeless literals in 1 or 4 Huffman streams,
// predefined/RLE/FSE/repeat sequence tables, repeat offsets carried across
// blocks, the XXH64 content checksum. Returns 0 with info[0] = the decoded
// size; -1 with info[0] = the room needed when `room` is too small (nothing
// useful is written then); -2 for a malformed frame and -3 for a frame that
// needs a dictionary, with a message naming the byte offset or the id.
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <vector>

namespace {

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippable = 0x184D2A50u;
constexpr long long kBlockMax = 128 << 10;
constexpr unsigned long long kWindowMax = 1ull << 31;

struct Code {
  uint32_t base;
  int bits;
};
const Code kLL[36] = {{0, 0},     {1, 0},     {2, 0},     {3, 0},     {4, 0},     {5, 0},      {6, 0},      {7, 0},
                      {8, 0},     {9, 0},     {10, 0},    {11, 0},    {12, 0},    {13, 0},     {14, 0},     {15, 0},
                      {16, 1},    {18, 1},    {20, 1},    {22, 1},    {24, 2},    {28, 2},     {32, 3},     {40, 3},
                      {48, 4},    {64, 6},    {128, 7},   {256, 8},   {512, 9},   {1024, 10},  {2048, 11},  {4096, 12},
                      {8192, 13}, {16384, 14}, {32768, 15}, {65536, 16}};
const Code kML[53] = {{3, 0},      {4, 0},      {5, 0},      {6, 0},     {7, 0},     {8, 0},     {9, 0},     {10, 0},
                      {11, 0},     {12, 0},     {13, 0},     {14, 0},    {15, 0},    {16, 0},    {17, 0},    {18, 0},
                      {19, 0},     {20, 0},     {21, 0},     {22, 0},    {23, 0},    {24, 0},    {25, 0},    {26, 0},
                      {27, 0},     {28, 0},     {29, 0},     {30, 0},    {31, 0},    {32, 0},    {33, 0},    {34, 0},
                      {35, 1},     {37, 1},     {39, 1},     {41, 1},    {43, 2},    {47, 2},    {51, 3},    {59, 3},
                      {67, 4},     {83, 4},     {99, 5},     {131, 7},   {259, 8},   {515, 9},   {1027, 10}, {2051, 11},
                      {4099, 12},  {8195, 13},  {16387, 14}, {32771, 15}, {65539, 16}};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Error {
  int code;  // -2 malformed, -3 dictionary
  long long at;
  char what[160];
};

[[noreturn]] void fail(long long at, const char* what) {
  Error e{-2, at, {0}};
  snprintf(e.what, sizeof e.what, "%s", what);
  throw e;
}

inline uint64_t load64(const uint8_t* buf, long long n, long long i) {
  // little-endian bytes i..i+7, zero past n
  uint64_t v = 0;
  if (i >= 0 && i + 8 <= n) {
    memcpy(&v, buf + i, 8);
    return v;
  }
  for (int k = 0; k < 8; ++k)
    if (i + k >= 0 && i + k < n) v |= static_cast<uint64_t>(buf[i + k]) << (8 * k);
  return v;
}

// Bits from the start, least significant first (FSE table headers).
struct Forward {
  const uint8_t* buf;
  long long start, end, bit;
  uint32_t peek(int n) const {
    return static_cast<uint32_t>((load64(buf, end, start + (bit >> 3)) >> (bit & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) {
    bit += n;
    if (start + ((bit + 7) >> 3) > end) fail(end, "a table description runs past its block");
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  long long size() const { return (bit + 7) >> 3; }
};

// A bitstream read from its end; past the start it gives zeros and `left` goes negative.
struct Backward {
  const uint8_t* buf;
  long long start, end, left;
  Backward(const uint8_t* b, long long s, long long e) : buf(b), start(s), end(e) {
    if (e <= s || b[e - 1] == 0) fail(e - 1, "a bitstream without its end mark");
    int top = 7;
    while (!((b[e - 1] >> top) & 1)) --top;
    left = (e - s) * 8 - 8 + top;
  }
  inline uint64_t read(int n) {
    if (n == 0) return 0;
    long long lo = left - n;
    left = lo;
    if (lo >= 0) return (load64(buf, end, start + (lo >> 3)) >> (lo & 7)) & ((1ull << n) - 1);
    if (lo + n <= 0) return 0;
    return (load64(buf, end, start) << (-lo)) & ((1ull << n) - 1);
  }
};

struct Fse {
  std::vector<uint8_t> symbol, nbits;
  std::vector<uint16_t> base;
  int log = 0;
};

int read_ncount(const uint8_t* buf, long long start, long long end, int max_symbol, int max_log,
                std::vector<int16_t>& counts) {
  Forward r{buf, start, end, 0};
  int log = static_cast<int>(r.read(4)) + 5;
  if (log > max_log) fail(start, "an FSE accuracy log above its limit");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  counts.clear();
  while (remaining > 1) {
    if (static_cast<int>(counts.size()) > max_symbol) fail(start, "an FSE table with too many symbols");
    int mx = 2 * threshold - 1 - remaining;
    int v = static_cast<int>(r.peek(nbits));
    int count;
    if ((v & (threshold - 1)) < mx) {
      count = v & (threshold - 1);
      r.skip(nbits - 1);
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      r.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(static_cast<int16_t>(count));
    if (count == 0) {
      while (true) {
        int rep = static_cast<int>(r.read(2));
        for (int k = 0; k < rep; ++k) counts.push_back(0);
        if (rep != 3) break;
        if (static_cast<int>(counts.size()) > max_symbol + 1) fail(start, "an FSE table with too many symbols");
      }
      if (static_cast<int>(counts.size()) > max_symbol + 1) fail(start, "an FSE table with too many symbols");
    }
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(start, "FSE counts that do not fill the table");
  return log | static_cast<int>(r.size() << 8);
}

void fse_table(const int16_t* counts, int n, int log, Fse& t) {
  const int size = 1 << log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  t.log = log;
  std::vector<int> nxt(n);
  int high = size - 1;
  for (int s = 0; s < n; ++s) {
    if (counts[s] == -1) {
      t.symbol[high--] = static_cast<uint8_t>(s);
      nxt[s] = 1;
    } else {
      nxt[s] = counts[s];
    }
  }
  int pos = 0;
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s < n; ++s)
    for (int i = 0; i < counts[s]; ++i) {
      t.symbol[pos] = static_cast<uint8_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) fail(0, "an FSE table whose spread does not return to 0");
  for (int u = 0; u < size; ++u) {
    const int s = t.symbol[u];
    const int k = nxt[s]++;
    int hb = 31 - __builtin_clz(static_cast<unsigned>(k));
    const int b = log - hb;
    t.nbits[u] = static_cast<uint8_t>(b);
    t.base[u] = static_cast<uint16_t>((k << b) - size);
  }
}

void rle_table(int sym, Fse& t) {
  t.symbol.assign(1, static_cast<uint8_t>(sym));
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
  t.log = 0;
}

struct Huffman {
  std::vector<uint8_t> symbol, length;
  int log = 0;
  bool set = false;
};

long long huffman_weights(const uint8_t* buf, long long pos, long long end, std::vector<uint8_t>& w) {
  if (pos >= end) fail(pos, "a Huffman tree description past its block");
  const int hb = buf[pos];
  w.clear();
  if (hb >= 128) {
    const int n = hb - 127;
    const long long size = 1 + (n + 1) / 2;
    if (pos + size > end) fail(pos, "Huffman weights past their block");
    for (int i = 0; i < n; ++i) {
      const uint8_t b = buf[pos + 1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    return size;
  }
  const long long size = 1 + hb;
  if (hb == 0 || pos + size > end) fail(pos, "FSE-compressed Huffman weights past their block");
  std::vector<int16_t> counts;
  const int got = read_ncount(buf, pos + 1, pos + size, 255, 6, counts);
  const int log = got & 255;
  const long long used = got >> 8;
  Fse t;
  fse_table(counts.data(), static_cast<int>(counts.size()), log, t);
  Backward r(buf, pos + 1 + used, pos + size);
  int s1 = static_cast<int>(r.read(log)), s2 = static_cast<int>(r.read(log));
  while (true) {
    if (w.size() > 255) fail(pos, "more than 255 Huffman weights");
    w.push_back(t.symbol[s1]);
    s1 = t.base[s1] + static_cast<int>(r.read(t.nbits[s1]));
    if (r.left < 0) {
      w.push_back(t.symbol[s2]);
      break;
    }
    w.push_back(t.symbol[s2]);
    s2 = t.base[s2] + static_cast<int>(r.read(t.nbits[s2]));
    if (r.left < 0) {
      w.push_back(t.symbol[s1]);
      break;
    }
  }
  if (w.size() > 255) fail(pos, "more than 255 Huffman weights");
  return size;
}

void huffman_table(std::vector<uint8_t> w, long long at, Huffman& h) {
  long long total = 0;
  for (uint8_t x : w) {
    if (x > 11) fail(at, "a Huffman weight above 11");
    total += (1ll << x) >> 1;
  }
  if (total == 0) fail(at, "Huffman weights all zero");
  int log = 0;
  while ((1ll << log) <= total) ++log;  // the bit length of the sum
  if (log > 11) fail(at, "a Huffman code longer than 11 bits");
  const long long rest = (1ll << log) - total;
  if (rest & (rest - 1)) fail(at, "Huffman weights that leave no power of two for the last symbol");
  int last = 0;
  while ((1ll << last) <= rest) ++last;
  w.push_back(static_cast<uint8_t>(last));
  int rank[13] = {0}, start[13] = {0};
  for (uint8_t x : w) rank[x] += 1;
  int nxt = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = nxt;
    nxt += rank[k] << (k - 1);
  }
  const int size = 1 << log;
  h.symbol.assign(size, 0);
  h.length.assign(size, 0);
  for (size_t s = 0; s < w.size(); ++s) {
    const int x = w[s];
    if (x == 0) continue;
    const int n = (1 << x) >> 1;
    for (int i = 0; i < n; ++i) {
      h.symbol[start[x] + i] = static_cast<uint8_t>(s);
      h.length[start[x] + i] = static_cast<uint8_t>(log + 1 - x);
    }
    start[x] += n;
  }
  h.log = log;
  h.set = true;
}

void huffman_stream(const uint8_t* buf, long long start, long long end, long long count, const Huffman& h,
                    uint8_t* out) {
  Backward r(buf, start, end);
  long long left = r.left;
  const int log = h.log;
  const uint64_t mask = (1ull << log) - 1;
  const uint8_t* sym = h.symbol.data();
  const uint8_t* len = h.length.data();
  long long k = 0;
  // fast part: a 64-bit load serves while the window stays inside the stream
  while (k < count && left - log >= 0) {
    const long long lo = left - log;
    const uint64_t v = (load64(buf, end, start + (lo >> 3)) >> (lo & 7)) & mask;
    out[k++] = sym[v];
    left -= len[v];
  }
  for (; k < count; ++k) {
    const long long lo = left - log;
    uint64_t v;
    if (lo >= 0)
      v = (load64(buf, end, start + (lo >> 3)) >> (lo & 7)) & mask;
    else if (left > 0)
      v = (load64(buf, end, start) << (-lo)) & mask;
    else
      v = 0;
    out[k] = sym[v];
    left -= len[v];
  }
  if (left != 0) fail(start, "a Huffman stream that does not end on its last symbol");
}

struct FrameState {
  Huffman huffman;
  Fse tables[3];  // LL, OF, ML
  bool have[3] = {false, false, false};
  uint32_t rep[3] = {1, 4, 8};
};

long long literals(const uint8_t* buf, long long pos, long long end, FrameState& st, std::vector<uint8_t>& lits) {
  const int b0 = buf[pos];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind <= 1) {
    const int hsize = fmt == 1 ? 2 : fmt == 3 ? 3 : 1;
    if (pos + hsize > end) fail(pos, "a literals header past its block");
    uint32_t c = 0;
    for (int i = 0; i < hsize; ++i) c |= static_cast<uint32_t>(buf[pos + i]) << (8 * i);
    const long long size = hsize == 1 ? c >> 3 : c >> 4;
    if (size > kBlockMax) fail(pos, "literals above the block size");
    if (kind == 0) {
      if (pos + hsize + size > end) fail(pos, "raw literals past their block");
      lits.assign(buf + pos + hsize, buf + pos + hsize + size);
      return hsize + size;
    }
    if (pos + hsize >= end) fail(pos, "RLE literals past their block");
    lits.assign(size, buf[pos + hsize]);
    return hsize + 1;
  }
  const int hsize = fmt == 0 || fmt == 1 ? 3 : fmt == 2 ? 4 : 5;
  if (pos + hsize > end) fail(pos, "a literals header past its block");
  uint64_t c = 0;
  for (int i = 0; i < hsize; ++i) c |= static_cast<uint64_t>(buf[pos + i]) << (8 * i);
  const int bits = fmt <= 1 ? 10 : fmt == 2 ? 14 : 18;
  const long long size = (c >> 4) & ((1ull << bits) - 1), csize = (c >> (4 + bits)) & ((1ull << bits) - 1);
  const int streams = fmt == 0 ? 1 : 4;
  if (size > kBlockMax) fail(pos, "literals above the block size");
  long long p = pos + hsize;
  const long long stop = pos + hsize + csize;
  if (stop > end) fail(pos, "compressed literals past their block");
  if (kind == 2) {
    std::vector<uint8_t> w;
    p += huffman_weights(buf, p, stop, w);
    huffman_table(w, p, st.huffman);
  } else if (!st.huffman.set) {
    fail(pos, "treeless literals without an earlier Huffman table");
  }
  lits.resize(size);
  if (streams == 1) {
    huffman_stream(buf, p, stop, size, st.huffman, lits.data());
    return hsize + csize;
  }
  if (p + 6 > stop) fail(p, "a jump table past its literals");
  long long s[3];
  for (int i = 0; i < 3; ++i) s[i] = buf[p + 2 * i] | (buf[p + 2 * i + 1] << 8);
  p += 6;
  const long long each = (size + 3) / 4;
  if (each * 3 > size || p + s[0] + s[1] + s[2] > stop) fail(p, "a jump table that does not fit its literals");
  const long long bounds[5] = {p, p + s[0], p + s[0] + s[1], p + s[0] + s[1] + s[2], stop};
  for (int i = 0; i < 4; ++i)
    huffman_stream(buf, bounds[i], bounds[i + 1], i < 3 ? each : size - 3 * each, st.huffman,
                   lits.data() + i * each);
  return hsize + csize;
}

long long seq_table(int mode, const uint8_t* buf, long long pos, long long end, int which, FrameState& st) {
  static const int kMaxSymbol[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};
  if (mode == 0) {
    if (which == 0) fse_table(kLLDefault, 36, 6, st.tables[0]);
    if (which == 1) fse_table(kOFDefault, 29, 5, st.tables[1]);
    if (which == 2) fse_table(kMLDefault, 53, 6, st.tables[2]);
    st.have[which] = true;
    return 0;
  }
  if (mode == 1) {
    if (pos >= end) fail(pos, "an RLE sequence code past its block");
    if (buf[pos] > kMaxSymbol[which]) fail(pos, "an RLE sequence code above its limit");
    rle_table(buf[pos], st.tables[which]);
    st.have[which] = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int16_t> counts;
    const int got = read_ncount(buf, pos, end, kMaxSymbol[which], kMaxLog[which], counts);
    fse_table(counts.data(), static_cast<int>(counts.size()), got & 255, st.tables[which]);
    st.have[which] = true;
    return got >> 8;
  }
  if (!st.have[which]) fail(pos, "a repeated sequence table without an earlier one");
  return 0;
}

// Decode the sequences section at pos and execute it onto out.
void sequences(const uint8_t* buf, long long pos, long long end, FrameState& st, const std::vector<uint8_t>& lits,
               std::vector<uint8_t>& out, long long frame_start, unsigned long long window) {
  if (pos >= end) fail(pos, "a block without its sequences section");
  const int b0 = buf[pos];
  long long nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) fail(pos, "a sequences header past its block");
    nseq = ((b0 - 128) << 8) + buf[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) fail(pos, "a sequences header past its block");
    nseq = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != end) fail(pos, "bytes after an empty sequences section");
    out.insert(out.end(), lits.begin(), lits.end());
    return;
  }
  if (pos >= end) fail(pos, "a sequences header past its block");
  const int modes = buf[pos];
  if (modes & 3) fail(pos, "reserved bits set in the sequence modes");
  pos += 1;
  pos += seq_table((modes >> 6) & 3, buf, pos, end, 0, st);
  pos += seq_table((modes >> 4) & 3, buf, pos, end, 1, st);
  pos += seq_table((modes >> 2) & 3, buf, pos, end, 2, st);
  const Fse &lt = st.tables[0], &ot = st.tables[1], &mt = st.tables[2];
  Backward r(buf, pos, end);
  int ls = static_cast<int>(r.read(lt.log)), os = static_cast<int>(r.read(ot.log)),
      ms = static_cast<int>(r.read(mt.log));
  uint32_t* rep = st.rep;
  size_t lp = 0;
  for (long long i = 0; i < nseq; ++i) {
    const int lc = lt.symbol[ls], oc = ot.symbol[os], mc = mt.symbol[ms];
    if (oc > 31) fail(pos, "an offset code above 31");
    const uint64_t ov = (1ull << oc) + r.read(oc);
    const uint64_t ml = kML[mc].base + r.read(kML[mc].bits);
    const uint64_t ll = kLL[lc].base + r.read(kLL[lc].bits);
    uint64_t off;
    if (ov > 3) {
      off = ov - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = static_cast<uint32_t>(off);
    } else {
      const int idx = static_cast<int>(ov) - 1 + (ll == 0);
      if (idx == 0) {
        off = rep[0];
      } else if (idx == 3) {
        off = rep[0] - 1ull;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = static_cast<uint32_t>(off);
      } else {
        off = rep[idx];
        if (idx == 2) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = static_cast<uint32_t>(off);
      }
    }
    if (i + 1 < nseq) {
      ls = lt.base[ls] + static_cast<int>(r.read(lt.nbits[ls]));
      ms = mt.base[ms] + static_cast<int>(r.read(mt.nbits[ms]));
      os = ot.base[os] + static_cast<int>(r.read(ot.nbits[os]));
    }
    if (r.left < 0) fail(pos, "a sequence bitstream read past its start");
    if (lp + ll > lits.size()) fail(pos, "a sequence asks for more literals than the block has");
    out.insert(out.end(), lits.begin() + lp, lits.begin() + lp + ll);
    lp += ll;
    const unsigned long long have = out.size() - frame_start;
    if (off == 0 || off > have || off > window) fail(pos, "a match offset before the frame or the window");
    if (ml > static_cast<uint64_t>(kBlockMax)) fail(pos, "a match longer than a block");
    size_t src = out.size() - off;
    out.resize(out.size() + ml);
    uint8_t* o = out.data();
    size_t dst = out.size() - ml;
    if (off >= ml) {
      memcpy(o + dst, o + src, ml);
    } else {
      for (uint64_t k = 0; k < ml; ++k) o[dst + k] = o[src + k];  // overlapping: byte by byte
    }
  }
  if (r.left != 0) fail(pos, "a sequence bitstream with bits left");
  out.insert(out.end(), lits.begin() + lp, lits.end());
}

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full, P3 = 0x165667B19E3779F9ull,
                   P4 = 0x85EBCA77C2B2AE63ull, P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; i + 32 <= n; i += 32)
      for (int j = 0; j < 4; ++j) {
        uint64_t lane;
        memcpy(&lane, p + i + 8 * j, 8);
        v[j] = round64(v[j], lane);
      }
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int j = 0; j < 4; ++j) h = (h ^ round64(0, v[j])) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) {
    uint64_t lane;
    memcpy(&lane, p + i, 8);
    h = rotl(h ^ round64(0, lane), 27) * P1 + P4;
  }
  if (i + 4 <= n) {
    uint32_t lane;
    memcpy(&lane, p + i, 4);
    h = rotl(h ^ (static_cast<uint64_t>(lane) * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

long long frame(const uint8_t* buf, long long n, long long pos, std::vector<uint8_t>& out) {
  const long long start = pos;
  if (pos + 5 > n) fail(pos, "a frame header cut short");
  const int fhd = buf[pos + 4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail(pos + 4, "the reserved bit of the frame header is set");
  pos += 5;
  unsigned long long window = 0;
  if (!single) {
    if (pos >= n) fail(start, "a frame header cut short");
    const int wd = buf[pos];
    const int wlog = 10 + (wd >> 3);
    window = (1ull << wlog) + ((1ull << wlog) >> 3) * (wd & 7);
    pos += 1;
  }
  const int dsize = dict_flag == 0 ? 0 : dict_flag == 1 ? 1 : dict_flag == 2 ? 2 : 4;
  if (pos + dsize > n) fail(start, "a frame header cut short");
  uint32_t dict = 0;
  for (int i = 0; i < dsize; ++i) dict |= static_cast<uint32_t>(buf[pos + i]) << (8 * i);
  pos += dsize;
  if (dict) {
    Error e{-3, start, {0}};
    snprintf(e.what, sizeof e.what, "the frame at byte %lld needs dictionary %u, which this decoder does not have",
             start, dict);
    throw e;
  }
  const int fsize = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  bool has_content = fsize > 0;
  unsigned long long content = 0;
  if (pos + fsize > n) fail(start, "a frame header cut short");
  for (int i = 0; i < fsize; ++i) content |= static_cast<unsigned long long>(buf[pos + i]) << (8 * i);
  if (fsize == 2) content += 256;
  pos += fsize;
  if (single) window = content;
  if (window > kWindowMax) fail(start, "a window above 2 GiB");
  const long long block_max = window < static_cast<unsigned long long>(kBlockMax) ? static_cast<long long>(window)
                                                                                    : kBlockMax;
  FrameState st;
  const long long frame_start = static_cast<long long>(out.size());
  std::vector<uint8_t> lits;
  while (true) {
    if (pos + 3 > n) fail(pos, "a block header cut short");
    const uint32_t h = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16);
    const int last = h & 1, kind = (h >> 1) & 3;
    const long long size = h >> 3;
    pos += 3;
    if (kind == 3) fail(pos - 3, "a reserved block type");
    if (size > block_max) fail(pos - 3, "a block above the block size");
    if (kind == 0) {
      if (pos + size > n) fail(pos, "a raw block cut short");
      out.insert(out.end(), buf + pos, buf + pos + size);
      pos += size;
    } else if (kind == 1) {
      if (pos >= n) fail(pos, "an RLE block cut short");
      out.insert(out.end(), static_cast<size_t>(size), buf[pos]);
      pos += 1;
    } else {
      const long long end = pos + size;
      if (end > n) fail(pos, "a compressed block cut short");
      if (size < 1) fail(pos, "an empty compressed block");
      const long long used = literals(buf, pos, end, st, lits);
      const size_t before = out.size();
      sequences(buf, pos + used, end, st, lits, out, frame_start, window);
      if (static_cast<long long>(out.size() - before) > kBlockMax) fail(pos, "a block that decodes to more than 128 KiB");
      pos = end;
    }
    if (has_content && out.size() - frame_start > content) fail(pos, "a frame longer than its content size");
    if (last) break;
  }
  if (has_content && out.size() - frame_start != content) fail(pos, "a frame shorter than its content size");
  if (checksum) {
    if (pos + 4 > n) fail(pos, "a checksum cut short");
    const uint32_t want = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16) | (static_cast<uint32_t>(buf[pos + 3]) << 24);
    const uint64_t got = xxh64(out.data() + frame_start, out.size() - frame_start);
    if (static_cast<uint32_t>(got) != want) fail(pos, "the content checksum does not match");
    pos += 4;
  }
  return pos;
}

}  // namespace

extern "C" int fce_zstd_decompress(const void* src, long long n, void* dst, long long room, long long* info,
                                   char* msg, int msglen) {
  const uint8_t* buf = static_cast<const uint8_t*>(src);
  std::vector<uint8_t> out;
  out.reserve(room > 0 ? static_cast<size_t>(room) : 0);
  info[0] = 0;
  info[1] = 0;
  if (msglen > 0) msg[0] = 0;
  try {
    long long pos = 0;
    while (pos < n) {
      if (pos + 4 > n) fail(pos, "bytes after the last frame");
      const uint32_t magic = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16) |
                             (static_cast<uint32_t>(buf[pos + 3]) << 24);
      if ((magic & 0xFFFFFFF0u) == kSkippable) {
        if (pos + 8 > n) fail(pos, "a skippable frame cut short");
        const uint32_t skip = buf[pos + 4] | (buf[pos + 5] << 8) | (buf[pos + 6] << 16) |
                              (static_cast<uint32_t>(buf[pos + 7]) << 24);
        pos += 8 + static_cast<long long>(skip);
        if (pos > n) fail(n, "a skippable frame cut short");
        continue;
      }
      if (magic != kMagic) fail(pos, "a magic number that is not a zstd frame's");
      pos = frame(buf, n, pos, out);
    }
  } catch (const Error& e) {
    info[1] = e.at;
    if (msglen > 0) {
      if (e.code == -3)
        snprintf(msg, msglen, "%s", e.what);
      else
        snprintf(msg, msglen, "malformed frame at byte %lld: %s", e.at, e.what);
    }
    return e.code;
  } catch (...) {
    if (msglen > 0) snprintf(msg, msglen, "out of memory");
    return -4;
  }
  info[0] = static_cast<long long>(out.size());
  if (static_cast<long long>(out.size()) > room) {
    if (msglen > 0) snprintf(msg, msglen, "needs %lld bytes of room, got %lld", info[0], room);
    return -1;
  }
  if (!out.empty()) memcpy(dst, out.data(), out.size());
  return 0;
}
