// WebP decode for Hopper (sm_90a): the container, VP8L, VP8 and ALPH as host C++, then one colour kernel.
//
// Replaces what the JAX package reads a .webp file with: cv2.imdecode(buf, IMREAD_COLOR) in
// fce_yolo_tpu/utils/patches.py:18 (the libwebp cv2 carries). Not a Pallas kernel: the card takes the
// pixel stage of a host library, as csrc/jpeg.cu does for JPEG. The output is bit-equal to cv2's; the plain
// version this mirrors step for step is fce_yolo_tpu_torch/data/webp.py, webp_lossless.py and webp_lossy.py.
//
// 1. Host decode (reentrant: no globals, so loader threads may call it at once):
//    - the RIFF walk of libwebp's ParseHeadersInternal (VP8X, optional chunks, the last ALPH before the
//      image), or for an animation its demuxer's rules down to the first ANMF frame;
//    - VP8L: prefix codes as root tables of up to 10 bits with a canonical slow path for longer codes,
//      the meta prefix-code image, colour cache, LZ77 with the distance map, the four inverse transforms;
//    - VP8: libwebp's boolean decoder (its range - 1 state, byte-wise loads, VP8GetSigned), the frame
//      header, modes, tokens, reconstruction in the 32-byte-stride work buffer, then the loop filter;
//    - ALPH: raw or VP8L-coded, unfiltered; decoded (and checked) although IMREAD_COLOR drops it.
//    Out: a lossy frame's Y, U, V (and alpha) planes, or a lossless frame's ARGB.
// 2. webp_color_kernel: one thread a pixel; libwebp's fancy upsampling (UpsampleRgbLinePair, the first
//    and last rows as EmitFancyRGB treats them, in its separable near/far form) and VP8YuvToBgr (14-bit
//    MultHi, Clip8). Writes BGR uint8 into a canvas at the frame's offset.
//
// fce_webp_decode does a whole file with no return to Python: host decode into the caller's pinned buffer;
// for a lossy frame one H2D copy, the kernel and one D2H copy on the caller's stream; a lossless frame is
// written as BGR on the host and launches nothing. ctypes releases the interpreter lock for the call.
//
// What bounds it on the H100: the host. The entropy decode is serial, some ms for a 480 x 640 image; the
// kernel moves 1.5 bytes in and 3 out a pixel, a few us of HBM time, so at one image a call it is
// launch-bound. Times: PERF.md.
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <chrono>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kInfoLen = 16;
enum { kErrFormat = -1, kErrVP8 = -2, kErrVP8L = -3, kErrAlpha = -4, kErrAnim = -5, kErrTooLarge = -12, kGrow = -13 };
constexpr uint64_t kMaxChunk = 0xFFFFFFFFull - 8 - 1;  // libwebp's MAX_CHUNK_PAYLOAD
constexpr uint64_t kMaxPixels = 1ull << 30;            // cv2's CV_IO_MAX_IMAGE_PIXELS
constexpr int kMaxSide = 1 << 20;                       // cv2's CV_IO_MAX_IMAGE_WIDTH and _HEIGHT

struct Fail {
  int code;
};

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

// ------------------------------------------------------------------ VP8L
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };
constexpr int kRootBits = 10;

// libwebp's VP8LBitReader: pos counts the bits read; past limit the stream has ended (eos_)
struct BitsL {
  const uint8_t* buf;
  uint64_t len, pos, limit;
  BitsL(const uint8_t* b, uint64_t n) : buf(b), len(n), pos(0), limit(8 * std::max<uint64_t>(n, 8)) {}
  uint64_t window() const {
    const uint64_t b = pos >> 3;
    uint64_t v = 0;
    if (b + 8 <= len) {
      memcpy(&v, buf + b, 8);
    } else {
      for (uint64_t i = 0; i < 8 && b + i < len; ++i) v |= (uint64_t)buf[b + i] << (8 * i);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int n) {
    const uint32_t v = (uint32_t)(window() & ((1ull << n) - 1));
    pos += n;
    return v;
  }
  bool eos() const { return pos > limit; }
};

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// One prefix code: a root table over the next `bits` bits (entries sym | len << 16, or 1 << 24 for a code
// longer than the root, read the canonical way) or a single symbol of no bits.
struct Code {
  int single = -1, bits = 0, off = 0, sorted_off = 0;
  int16_t count[16] = {0};
};

struct Codes {
  std::vector<uint32_t> table;
  std::vector<uint16_t> sorted;
  std::vector<Code> codes;

  // BuildHuffmanTable's rules: a complete code, or one symbol alone
  void add(const int* lengths, int n) {
    Code c;
    int count[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) throw Fail{kErrVP8L};
      ++count[lengths[s]];
    }
    if (count[0] == n) throw Fail{kErrVP8L};
    if (n - count[0] == 1) {
      for (int s = 0; s < n; ++s) {
        if (lengths[s]) c.single = s;
      }
      codes.push_back(c);
      return;
    }
    int left = 1, maxlen = 0;
    for (int l = 1; l < 16; ++l) {
      left = 2 * left - count[l];
      if (left < 0) throw Fail{kErrVP8L};
      if (count[l]) maxlen = l;
    }
    if (left != 0) throw Fail{kErrVP8L};
    c.bits = std::min(maxlen, kRootBits);
    c.off = (int)table.size();
    c.sorted_off = (int)sorted.size();
    for (int l = 0; l < 16; ++l) c.count[l] = (int16_t)count[l];
    const int size = 1 << c.bits;
    table.resize(table.size() + size, 0);
    int code = 0;
    for (int l = 1; l <= maxlen; ++l) {
      for (int s = 0; s < n; ++s) {
        if (lengths[s] != l) continue;
        sorted.push_back((uint16_t)s);
        int rev = 0;
        for (int i = 0; i < l; ++i) rev |= ((code >> i) & 1) << (l - 1 - i);
        if (l <= c.bits) {
          for (int k = rev; k < size; k += 1 << l) table[c.off + k] = (uint32_t)s | ((uint32_t)l << 16);
        } else {
          table[c.off + (rev & (size - 1))] = 1u << 24;
        }
        ++code;
      }
      code <<= 1;
    }
    codes.push_back(c);
  }

  int read(int k, BitsL& br) const {
    const Code& c = codes[k];
    if (c.single >= 0) return c.single;
    const uint64_t w = br.window();
    const uint32_t e = table[c.off + (w & ((1u << c.bits) - 1))];
    if (!(e >> 24)) {
      br.pos += (e >> 16) & 0xFF;
      return (int)(e & 0xFFFF);
    }
    int code = 0, first = 0, index = 0;  // the canonical decode (puff's)
    for (int l = 1; l <= 15; ++l) {
      code |= (int)((w >> (l - 1)) & 1);
      const int cnt = c.count[l];
      if (code - cnt < first) {
        br.pos += l;
        return sorted[c.sorted_off + index + (code - first)];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    throw Fail{kErrVP8L};
  }
};

void code_lengths(BitsL& br, const int* cl, int num, int* out) {
  Codes t;
  t.add(cl, 19);
  int max_symbol = num;
  if (br.read(1)) {
    const int nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nbits);
    if (max_symbol > num) throw Fail{kErrVP8L};
  }
  for (int i = 0; i < num; ++i) out[i] = 0;
  int prev = 8, s = 0;
  while (s < num) {
    if (max_symbol-- == 0) break;
    const int n = t.read(0, br);
    if (n < 16) {
      out[s++] = n;
      if (n) prev = n;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int repeat = (int)br.read(kExtra[n - 16]) + kOffset[n - 16];
      if (s + repeat > num) throw Fail{kErrVP8L};
      for (int k = 0; k < repeat; ++k) out[s++] = n == 16 ? prev : 0;
    }
    if (br.eos()) break;
  }
}

void read_code(BitsL& br, int alphabet, Codes& into) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {  // simple
    const int two = (int)br.read(1);
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (two) lengths[br.read(8)] = 1;
  } else {
    int cl[19] = {0};
    const int n = (int)br.read(4) + 4;
    for (int i = 0; i < n; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
    code_lengths(br, cl, alphabet, lengths.data());
  }
  if (br.eos()) throw Fail{kErrVP8L};
  into.add(lengths.data(), alphabet);
}

// one image stream's entropy state
struct Stream {
  int cache_bits = 0, hbits = 0, hxs = 0;
  std::vector<uint32_t> himg;  // group a tile
  Codes codes;                  // 5 a group
  int groups = 1;
  int group(int x, int y) const { return himg.empty() ? 0 : (int)himg[(y >> hbits) * hxs + (x >> hbits)]; }
};

void decode_pixels(BitsL& br, const Stream& st, int xs, int ys, bool alpha8, std::vector<uint32_t>& out);

void decode_image(BitsL& br, int xs, int ys, std::vector<uint32_t>& out);

void read_stream(BitsL& br, int xs, int ys, bool top, Stream& st) {
  if (br.read(1)) {
    st.cache_bits = (int)br.read(4);
    if (st.cache_bits < 1 || st.cache_bits > 11) throw Fail{kErrVP8L};
  }
  if (top && br.read(1)) {
    st.hbits = (int)br.read(3) + 2;
    st.hxs = sub_size(xs, st.hbits);
    std::vector<uint32_t> img;
    decode_image(br, st.hxs, sub_size(ys, st.hbits), img);
    st.himg.resize(img.size());
    uint32_t mx = 0;
    for (size_t i = 0; i < img.size(); ++i) {
      st.himg[i] = (img[i] >> 8) & 0xFFFF;
      mx = std::max(mx, st.himg[i]);
    }
    st.groups = (int)mx + 1;
  }
  const int extra = st.cache_bits ? 1 << st.cache_bits : 0;
  for (int g = 0; g < st.groups; ++g) {
    for (int j = 0; j < 5; ++j) read_code(br, kAlphabet[j] + (j == 0 ? extra : 0), st.codes);
  }
}

inline int prefix_value(int sym, BitsL& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + (int)br.read(extra) + 1;
}

inline int plane_distance(int xs, int code) {
  if (code > 120) return code - 120;
  const int d = kCodeToPlane[code - 1];
  const int dist = (d >> 4) * xs + 8 - (d & 0xF);
  return dist >= 1 ? dist : 1;
}

void decode_pixels(BitsL& br, const Stream& st, int xs, int ys, bool alpha8, std::vector<uint32_t>& out) {
  const int64_t total = (int64_t)xs * ys;
  out.assign(total, 0);
  std::vector<uint32_t> cache(st.cache_bits ? 1u << st.cache_bits : 0);
  const int shift = 32 - st.cache_bits;
  const int cache_limit = 280 + (st.cache_bits ? 1 << st.cache_bits : 0);
  int64_t last_cached = 0, pos = 0;
  int x = 0, y = 0;
  auto flush = [&]() {
    while (last_cached < pos) {
      const uint32_t p = out[last_cached++];
      cache[(uint32_t)(0x1E35A7BDu * p) >> shift] = p;
    }
  };
  while (pos < total) {
    const int g = 5 * st.group(x, y);
    const int code = st.codes.read(g + GREEN, br);
    if (code < 256) {
      if (alpha8) {
        out[pos] = (uint32_t)code;
      } else {
        const uint32_t red = st.codes.read(g + RED, br);
        const uint32_t blue = st.codes.read(g + BLUE, br);
        const uint32_t alpha = st.codes.read(g + ALPHA, br);
        out[pos] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
      }
      ++pos;
      if (++x >= xs) x = 0, ++y;
    } else if (code < 280) {
      const int length = prefix_value(code - 256, br);
      const int dist = plane_distance(xs, prefix_value(st.codes.read(g + DIST, br), br));
      if (br.eos() && !alpha8) break;
      if (pos < dist || total - pos < length) throw Fail{kErrVP8L};
      for (int64_t k = pos; k < pos + length; ++k) out[k] = out[k - dist];
      pos += length;
      x += length;
      while (x >= xs) x -= xs, ++y;
    } else if (code < cache_limit && !alpha8) {
      flush();
      out[pos] = cache[code - 280];
      ++pos;
      if (++x >= xs) x = 0, ++y;
    } else {
      throw Fail{kErrVP8L};
    }
    if (br.eos()) break;
    if (st.cache_bits && x == 0) flush();
  }
  if (br.eos() && (pos < total || !alpha8)) throw Fail{kErrVP8L};
}

void decode_image(BitsL& br, int xs, int ys, std::vector<uint32_t>& out) {
  Stream st;
  read_stream(br, xs, ys, false, st);
  decode_pixels(br, st, xs, ys, false, out);
}

struct Transform {
  int type, xs, bits;
  std::vector<uint32_t> data;
};

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) | (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

uint32_t select_px(uint32_t t, uint32_t l, uint32_t tl) {
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (t >> sh) & 0xFF, b = (l >> sh) & 0xFF, c = (tl >> sh) & 0xFF;
    s += abs(b - c) - abs(a - c);
  }
  return s <= 0 ? t : l;
}

uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    out |= (uint32_t)clip255((int)((a >> sh) & 0xFF) + (int)((b >> sh) & 0xFF) - (int)((c >> sh) & 0xFF)) << sh;
  }
  return out;
}

uint32_t clamp_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int x = (a >> sh) & 0xFF, y = (b >> sh) & 0xFF;
    out |= (uint32_t)clip255(x + (x - y) / 2) << sh;
  }
  return out;
}

inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: return select_px(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(avg2(L, T), TL);
    default: return 0xFF000000u;  // mode 0, and 14 and 15 as libwebp's sentinels
  }
}

// one transform undone: pix (ys x the transform's input width) -> out (ys x its xs)
void inverse(const Transform& t, const std::vector<uint32_t>& pix, int ys, std::vector<uint32_t>& out) {
  const int xs = t.xs;
  out.assign((size_t)xs * ys, 0);
  if (t.type == SUBTRACT_GREEN) {
    for (size_t i = 0; i < out.size(); ++i) {
      const uint32_t p = pix[i], g = (p >> 8) & 0xFF;
      out[i] = (p & 0xFF00FF00u) | ((((p >> 16) + g) & 0xFF) << 16) | ((p + g) & 0xFF);
    }
  } else if (t.type == CROSS_COLOR) {
    const int tw = sub_size(xs, t.bits);
    for (int y = 0; y < ys; ++y) {
      for (int x = 0; x < xs; ++x) {
        const uint32_t m = t.data[(y >> t.bits) * tw + (x >> t.bits)], p = pix[(size_t)y * xs + x];
        const int g2r = (int8_t)(m & 0xFF), g2b = (int8_t)((m >> 8) & 0xFF), r2b = (int8_t)((m >> 16) & 0xFF);
        const int green = (int8_t)((p >> 8) & 0xFF);
        int red = (p >> 16) & 0xFF, blue = p & 0xFF;
        red = (red + ((g2r * green) >> 5)) & 0xFF;
        blue += (g2b * green) >> 5;
        blue = (blue + ((r2b * (int8_t)red) >> 5)) & 0xFF;
        out[(size_t)y * xs + x] = (p & 0xFF00FF00u) | ((uint32_t)red << 16) | (uint32_t)blue;
      }
    }
  } else if (t.type == COLOR_INDEXING) {
    const int pw = sub_size(xs, t.bits), bpp = 8 >> t.bits, per = 1 << t.bits;
    for (int y = 0; y < ys; ++y) {
      for (int x = 0; x < xs; ++x) {
        const uint32_t packed = (pix[(size_t)y * pw + (x >> t.bits)] >> 8) & 0xFF;
        const uint32_t idx = t.bits ? (packed >> (bpp * (x & (per - 1)))) & ((1u << bpp) - 1) : packed;
        out[(size_t)y * xs + x] = t.data[idx];
      }
    }
  } else {  // predictor
    const int tw = sub_size(xs, t.bits);
    out[0] = add_px(pix[0], 0xFF000000u);
    for (int x = 1; x < xs; ++x) out[x] = add_px(pix[x], out[x - 1]);
    for (int y = 1; y < ys; ++y) {
      const size_t r = (size_t)y * xs;
      out[r] = add_px(pix[r], out[r - xs]);
      const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tw;
      for (int x = 1; x < xs; ++x) {
        const size_t i = r + x;
        const int mode = (modes[x >> t.bits] >> 8) & 0xF;
        out[i] = add_px(pix[i], predict(mode, out[i - 1], out[i - xs], out[i - xs + 1], out[i - xs - 1]));
      }
    }
  }
}

// the level-0 image of a VP8L stream after its header -> ARGB (ys x xs); alpha: ALPH's 8-bit path
void decode_stream(BitsL& br, int xs, int ys, bool alpha, std::vector<uint32_t>& argb) {
  std::vector<Transform> tr;
  int seen = 0, txs = xs;
  while (br.read(1)) {
    Transform t;
    t.type = (int)br.read(2);
    if (seen & (1 << t.type)) throw Fail{kErrVP8L};
    seen |= 1 << t.type;
    t.xs = txs;
    t.bits = 0;
    if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
      t.bits = (int)br.read(3) + 2;
      decode_image(br, sub_size(txs, t.bits), sub_size(ys, t.bits), t.data);
    } else if (t.type == COLOR_INDEXING) {
      const int n = (int)br.read(8) + 1;
      t.bits = n > 16 ? 0 : (n > 4 ? 1 : (n > 2 ? 2 : 3));
      std::vector<uint32_t> pal;
      decode_image(br, n, 1, pal);
      t.data.assign((size_t)1 << (8 >> t.bits), 0);  // ExpandColorMap
      uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4 * n; ++i) d[i] = (uint8_t)(s[i] + (i >= 4 ? d[i - 4] : 0));
      txs = sub_size(txs, t.bits);
    }
    if (br.eos()) throw Fail{kErrVP8L};
    tr.push_back(std::move(t));
  }
  Stream st;
  read_stream(br, txs, ys, true, st);
  bool alpha8 = alpha && tr.size() == 1 && tr[0].type == COLOR_INDEXING && st.cache_bits == 0;
  for (int g = 0; alpha8 && g < st.groups; ++g) {
    for (int c : {RED, BLUE, ALPHA}) alpha8 = alpha8 && st.codes.codes[5 * g + c].single >= 0;
  }
  std::vector<uint32_t> pix, tmp;
  decode_pixels(br, st, txs, ys, alpha8, pix);
  if (alpha8) {
    for (uint32_t& p : pix) p <<= 8;  // the index sits in green
  }
  for (int i = (int)tr.size() - 1; i >= 0; --i) {
    inverse(tr[i], pix, ys, tmp);
    pix.swap(tmp);
  }
  argb.swap(pix);
}

void decode_vp8l(const uint8_t* data, uint64_t len, int w, int h, uint32_t* argb) {
  BitsL br(data, len);
  if (br.read(8) != 0x2F) throw Fail{kErrVP8L};
  br.read(14);
  br.read(14);
  br.read(1);
  if (br.read(3) != 0) throw Fail{kErrVP8L};
  std::vector<uint32_t> out;
  decode_stream(br, w, h, false, out);
  memcpy(argb, out.data(), out.size() * 4);
}

void decode_alpha(const uint8_t* data, uint64_t len, int w, int h, uint8_t* out) {
  if (len <= 1) throw Fail{kErrAlpha};
  const int method = data[0] & 3, filt = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) throw Fail{kErrAlpha};
  const size_t n = (size_t)w * h;
  std::vector<uint8_t> a(n);
  if (method == 0) {
    if (len - 1 < n) throw Fail{kErrAlpha};
    memcpy(a.data(), data + 1, n);
  } else {
    BitsL br(data + 1, len - 1);
    std::vector<uint32_t> argb;
    try {
      decode_stream(br, w, h, true, argb);
    } catch (const Fail&) {
      throw Fail{kErrAlpha};
    }
    for (size_t i = 0; i < n; ++i) a[i] = (uint8_t)((argb[i] >> 8) & 0xFF);
  }
  // libwebp's unfilters; every first row is horizontal from 0
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = a.data() + (size_t)y * w;
    uint8_t* o = out + (size_t)y * w;
    const uint8_t* prev = y ? o - w : nullptr;
    if (filt == 0) {
      memcpy(o, in, w);
    } else if (filt == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = o[x] = (uint8_t)(pred + in[x]);
    } else if (filt == 2) {
      for (int x = 0; x < w; ++x) o[x] = (uint8_t)(prev[x] + in[x]);
    } else {
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = (uint8_t)(in[x] + clip255(g));
        top_left = top;
        o[x] = (uint8_t)left;
      }
    }
  }
}

// ------------------------------------------------------------------ VP8
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0}, kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };
constexpr int BPS = 32, Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline int16_t i16(int v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libwebp's VP8BitReader as its x86-64 build runs it: a 64-bit value loaded 56 bits at a time while 8 bytes
// remain, then byte by byte, one zero byte past the end (eof); the window compared as a 32-bit range_t. On a
// valid stream this is the spec's decoder; on a corrupt one the wrap and the truncation decide as cv2 decides.
struct Bool {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
      buf += 7;
      value = v | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t rng = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (rng * (uint32_t)prob) >> 8;
    int bit;
    if ((uint32_t)(value >> pos) > split) {
      rng -= split;
      value -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      rng = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(rng));
    rng <<= shift;
    bits -= shift;
    range = rng - 1;
    return bit;
  }
  int signed_(int v) {  // VP8GetSigned
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    bits -= 1;
    if ((split - (uint32_t)(value >> pos)) & 0x80000000u) {  // libwebp's int32 sign mask
      range = (range - 1) | 1;
      value -= (uint64_t)(split + 1) << pos;
      return -v;
    }
    range |= 1;
    return v;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

struct MB {
  int segment, skip, is_i4x4, uvmode, f_inner;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
  int16_t coeffs[384];
};

struct VP8 {
  int width, height, mb_w, mb_h;
  // segment and filter headers
  int use_segment = 0, update_map = 0, absolute_delta = 1, quantizer[4] = {0}, filter_strength[4] = {0};
  int segments[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0, use_skip_proba = 0, skip_p = 0;
  int dq[4][3][2];
  uint8_t proba[4 * 8 * 3 * 11];
  const uint8_t* bands[4][17];  // [type][position] -> 3 x 11 probabilities
  Bool br, parts[8];
  int nparts = 1;
  // decoding state
  std::vector<uint8_t> intra_t, nz, nz_dc, top_y, top_u, top_v, py, pu, pv;
  uint8_t intra_l[4];
  int nz_left = 0, nz_dc_left = 0;
  uint8_t yuv_b[YUV_SIZE];
};

void parse_vp8_header(const uint8_t* data, size_t n, VP8& d) {
  if (n < 4) throw Fail{kErrVP8};
  const uint32_t bits = le24(data);
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) throw Fail{kErrVP8};
  const uint32_t part_len = bits >> 5;
  if (n - 3 < 7 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) throw Fail{kErrVP8};
  d.width = le16(data + 6) & 0x3FFF;
  d.height = le16(data + 8) & 0x3FFF;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  size_t pos = 10, left = n - 10;
  if (part_len > left) throw Fail{kErrVP8};
  Bool& br = d.br;
  br.init(data + pos, part_len);
  pos += part_len;
  left -= part_len;
  br.get(0x80);  // colour space
  br.get(0x80);  // clamping type
  d.use_segment = br.get(0x80);
  if (d.use_segment) {
    d.update_map = br.get(0x80);
    if (br.get(0x80)) {
      d.absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) d.filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.segments[s] = br.get(0x80) ? br.value_bits(8) : 255;
    }
  }
  if (br.eof) throw Fail{kErrVP8};
  d.simple = br.get(0x80);
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.get(0x80);
  if (d.use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i) {
      if (br.get(0x80)) d.ref_lf_delta[i] = br.signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.get(0x80)) d.mode_lf_delta[i] = br.signed_value(6);
    }
  }
  d.filter_type = d.level == 0 ? 0 : (d.simple ? 1 : 2);
  if (br.eof) throw Fail{kErrVP8};
  const int last = (1 << br.value_bits(2)) - 1;
  if (left < 3 * (size_t)last) throw Fail{kErrVP8};
  const uint8_t* sz = data + pos;
  size_t start = pos + 3 * last, left_p = left - 3 * last;
  for (int p = 0; p < last; ++p) {
    const size_t psize = std::min<size_t>(le24(sz + 3 * p), left_p);
    d.parts[p].init(data + start, psize);
    start += psize;
    left_p -= psize;
  }
  d.parts[last].init(data + start, left_p);
  d.nparts = last + 1;
  if (start >= n) throw Fail{kErrVP8};
  // quantiser
  const int q0 = br.value_bits(7);
  int dlt[5];
  for (int i = 0; i < 5; ++i) dlt[i] = br.get(0x80) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : (v > m ? m : v); };
  for (int s = 0; s < 4; ++s) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[s] + (d.absolute_delta ? 0 : q0);
    } else if (s > 0) {
      memcpy(d.dq[s], d.dq[0], sizeof(d.dq[0]));
      continue;
    } else {
      q = q0;
    }
    d.dq[s][0][0] = kDcTable[clip(q + dlt[0], 127)];
    d.dq[s][0][1] = kAcTable[clip(q, 127)];
    d.dq[s][1][0] = kDcTable[clip(q + dlt[1], 127)] * 2;
    d.dq[s][1][1] = std::max((kAcTable[clip(q + dlt[2], 127)] * 101581) >> 16, 8);
    d.dq[s][2][0] = kDcTable[clip(q + dlt[3], 117)];
    d.dq[s][2][1] = kAcTable[clip(q + dlt[4], 127)];
  }
  br.get(0x80);  // refresh entropy probabilities
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i) {
    d.proba[i] = br.get(kCoeffsUpdateProba[i]) ? (uint8_t)br.value_bits(8) : kCoeffsProba0[i];
  }
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 17; ++b) d.bands[t][b] = d.proba + (t * 8 + kBands[b]) * 3 * 11;
  }
  d.use_skip_proba = br.get(0x80);
  d.skip_p = d.use_skip_proba ? br.value_bits(8) : 0;
}

void intra_modes(VP8& d, int mb_x, MB& blk) {
  Bool& br = d.br;
  if (d.update_map) {
    blk.segment = !br.get(d.segments[0]) ? br.get(d.segments[1]) : br.get(d.segments[2]) + 2;
  } else {
    blk.segment = 0;
  }
  blk.skip = d.use_skip_proba ? br.get(d.skip_p) : 0;
  uint8_t* top = d.intra_t.data() + 4 * mb_x;
  uint8_t* left = d.intra_l;
  blk.is_i4x4 = !br.get(145);
  if (!blk.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
    blk.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = blk.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba + (top[x] * 10 + ymode) * 9;
        if (!br.get(p[0])) {
          ymode = 0;
        } else if (!br.get(p[1])) {
          ymode = 1;
        } else if (!br.get(p[2])) {
          ymode = 2;
        } else if (!br.get(p[3])) {
          ymode = !br.get(p[4]) ? 3 : (!br.get(p[5]) ? 4 : 5);
        } else {
          ymode = !br.get(p[6]) ? 6 : (!br.get(p[7]) ? 7 : (!br.get(p[8]) ? 8 : 9));
        }
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  blk.uvmode = !br.get(142) ? DC_PRED : (!br.get(114) ? V_PRED : (br.get(183) ? TM_PRED : H_PRED));
}

int large_value(Bool& br, const uint8_t* p) {
  if (!br.get(p[3])) return !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  if (!br.get(p[6])) {
    if (!br.get(p[7])) return 5 + br.get(159);
    const int v = 7 + 2 * br.get(165);
    return v + br.get(145);
  }
  const int bit1 = br.get(p[8]);
  const int cat = 2 * bit1 + br.get(p[9 + bit1]);
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
  return v + 3 + (8 << cat);
}

// GetCoeffs: one block's tokens dequantised into out (natural order); the position after the last read
int coeffs(Bool& br, const uint8_t* const* prob, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[n] + ctx * 11;
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = prob[++n];
      if (n == 16) return 16;
    }
    const uint8_t* pc = prob[n + 1];
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = pc + 11;
    } else {
      v = large_value(br, p);
      p = pc + 22;
    }
    out[kZigzag[n]] = i16(br.signed_(v) * dq[n > 0]);
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[64 * i] = i16((a0 + a1) >> 3);
    out[64 * i + 16] = i16((a3 + a2) >> 3);
    out[64 * i + 32] = i16((a0 - a1) >> 3);
    out[64 * i + 48] = i16((a3 - a2) >> 3);
  }
}

inline uint32_t nz_bits(uint32_t nz_coeffs, int nz, bool dc_nz) {
  return (nz_coeffs << 2) | (nz > 3 ? 3 : (nz > 1 ? 2 : (dc_nz ? 1 : 0)));
}

int residuals(VP8& d, Bool& br, int mb_x, MB& blk) {
  const int (*q)[2] = d.dq[blk.segment];
  int16_t* dst = blk.coeffs;
  memset(dst, 0, sizeof(blk.coeffs));
  const int top = d.nz[mb_x], left = d.nz_left;
  int first;
  const uint8_t* const* ac_proba;
  if (!blk.is_i4x4) {
    int16_t dc[16] = {0};
    const int nz = coeffs(br, d.bands[1], d.nz_dc[mb_x] + d.nz_dc_left, q[1], 0, dc);
    d.nz_dc[mb_x] = (uint8_t)(d.nz_dc_left = nz > 0);
    wht(dc, dst);
    first = 1;
    ac_proba = d.bands[0];
  } else {
    first = 0;
    ac_proba = d.bands[3];
  }
  uint32_t tnz = top & 0x0F, lnz = left & 0x0F, non_zero_y = 0, non_zero_uv = 0;
  int16_t* o = dst;
  for (int y = 0; y < 4; ++y) {
    uint32_t l = lnz & 1, nzc = 0;
    for (int x = 0; x < 4; ++x) {
      const int nz = coeffs(br, ac_proba, (int)(l + (tnz & 1)), q[0], first, o);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nzc = nz_bits(nzc, nz, o[0] != 0);
      o += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nzc;
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nzc = 0;
    tnz = top >> (4 + ch);
    lnz = left >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      uint32_t l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int nz = coeffs(br, d.bands[2], (int)(l + (tnz & 1)), q[2], 0, o);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        nzc = nz_bits(nzc, nz, o[0] != 0);
        o += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nzc << (4 * ch);
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xF0) << ch;
  }
  d.nz[mb_x] = (uint8_t)out_t;
  d.nz_left = (int)(out_l & 0xFF);
  blk.non_zero_y = non_zero_y;
  blk.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

void decode_mb(VP8& d, Bool& br, int mb_x, MB& blk) {
  int skip = d.use_skip_proba ? blk.skip : 0;
  if (!skip) {
    skip = residuals(d, br, mb_x, blk);
  } else {
    d.nz[mb_x] = 0;
    d.nz_left = 0;
    if (!blk.is_i4x4) d.nz_dc[mb_x] = 0, d.nz_dc_left = 0;
    blk.non_zero_y = blk.non_zero_uv = 0;
  }
  blk.f_inner = blk.is_i4x4 | !skip;
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1] - tl;
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l);
    dst += BPS;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc, 4);
      break;
    }
    case 1: true_motion(dst, 4); break;
    case 2: {  // VE
      const uint8_t vals[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C), (uint8_t)avg3(B, C, D),
                               (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case 3:  // HE
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2i(X, A);
      DST(1, 0) = DST(2, 2) = avg2i(A, B);
      DST(2, 0) = DST(3, 2) = avg2i(B, C);
      DST(3, 0) = avg2i(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2i(A, B);
      DST(1, 0) = DST(0, 2) = avg2i(B, C);
      DST(2, 0) = DST(1, 2) = avg2i(C, D);
      DST(3, 0) = DST(2, 2) = avg2i(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2i(I, X);
      DST(0, 1) = DST(2, 2) = avg2i(J, I);
      DST(0, 2) = DST(2, 3) = avg2i(K, J);
      DST(0, 3) = avg2i(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2i(I, J);
      DST(2, 0) = DST(0, 1) = avg2i(J, K);
      DST(2, 1) = DST(0, 2) = avg2i(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// VP8PredLuma16 (size 16) and VP8PredChroma8 (size 8)
void pred_block(uint8_t* dst, int mode, int size) {
  const int shift = size == 8 ? 4 : 5;
  if (mode == TM_PRED) {
    true_motion(dst, size);
    return;
  }
  if (mode == V_PRED) {
    for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
    return;
  }
  if (mode == H_PRED) {
    for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
    return;
  }
  int top = 0, left = 0;
  for (int i = 0; i < size; ++i) top += dst[i - BPS], left += dst[i * BPS - 1];
  int v;
  if (mode == DC_PRED) {
    v = (top + left + (1 << (shift - 1))) >> shift;
  } else if (mode == DC_NOTOP) {
    v = (left + (1 << (shift - 2))) >> (shift - 1);
  } else if (mode == DC_NOLEFT) {
    v = (top + (1 << (shift - 2))) >> (shift - 1);
  } else {
    v = 0x80;
  }
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne added to the 4x4 block at dst with clipping. sse2: as libwebp's SSE2 Transform (the one cv2 runs
// for blocks with coefficients past position 2 and for chroma with any AC), whose 16-bit lanes wrap after the
// first pass, before the final shift and on the add; on coefficients an encoder emits the two agree.
void transform(const int16_t* in, uint8_t* dst, bool sse2) {
  auto w = [sse2](int v) { return sse2 ? (int)i16(v) : v; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i] = w(a + d);
    tmp[4 * i + 1] = w(b + c);
    tmp[4 * i + 2] = w(b - c);
    tmp[4 * i + 3] = w(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* r = dst + i * BPS;
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int k = 0; k < 4; ++k) r[k] = clip8(w(r[k] + (w(v[k]) >> 3)));
  }
}

void reconstruct_row(VP8& d, int mb_y, const MB* blocks) {
  uint8_t* b = d.yuv_b;
  uint8_t *y_dst = b + Y_OFF, *u_dst = b + U_OFF, *v_dst = b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  const int yw = d.mb_w * 16, uvw = d.mb_w * 8;
  for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
    const MB& blk = blocks[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
        memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
      }
    }
    if (mb_y > 0) {
      memcpy(y_dst - BPS, d.top_y.data() + 16 * mb_x, 16);
      memcpy(u_dst - BPS, d.top_u.data() + 8 * mb_x, 8);
      memcpy(v_dst - BPS, d.top_v.data() + 8 * mb_x, 8);
    }
    uint32_t bits = blk.non_zero_y;
    if (blk.is_i4x4) {
      uint8_t* tr = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1) {
          memset(tr, d.top_y[16 * mb_x + 15], 4);
        } else {
          memcpy(tr, d.top_y.data() + 16 * mb_x + 16, 4);
        }
      }
      for (int k = 4; k <= 12; k += 4) memcpy(tr + k * BPS, tr, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        pred4(dst, blk.imodes[n]);
        if (bits >> 30) transform(blk.coeffs + n * 16, dst, bits >> 30 == 3);
      }
    } else {
      pred_block(y_dst, check_mode(mb_x, mb_y, blk.imodes[0]), 16);
      if (bits != 0) {
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          if (bits >> 30) transform(blk.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS, bits >> 30 == 3);
        }
      }
    }
    const int uv_mode = check_mode(mb_x, mb_y, blk.uvmode);
    pred_block(u_dst, uv_mode, 8);
    pred_block(v_dst, uv_mode, 8);
    for (int c = 0; c < 2; ++c) {
      const uint32_t bits_uv = (blk.non_zero_uv >> (8 * c)) & 0xFF;
      if (bits_uv) {
        uint8_t* dst = c ? v_dst : u_dst;
        for (int n = 0; n < 4; ++n) {
          transform(blk.coeffs + 256 + 64 * c + 16 * n, dst + (n & 1) * 4 + (n >> 1) * 4 * BPS, bits_uv & 0xAA);
        }
      }
    }
    if (mb_y < d.mb_h - 1) {
      memcpy(d.top_y.data() + 16 * mb_x, y_dst + 15 * BPS, 16);
      memcpy(d.top_u.data() + 8 * mb_x, u_dst + 7 * BPS, 8);
      memcpy(d.top_v.data() + 8 * mb_x, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j) memcpy(d.py.data() + (size_t)(16 * mb_y + j) * yw + 16 * mb_x, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(d.pu.data() + (size_t)(8 * mb_y + j) * uvw + 8 * mb_x, u_dst + j * BPS, 8);
      memcpy(d.pv.data() + (size_t)(8 * mb_y + j) * uvw + 8 * mb_x, v_dst + j * BPS, 8);
    }
  }
}

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

inline void filter2(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * s] = clip8(p1 + a3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int s) {
  const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * s] = clip8(p2 + a3);
  p[-2 * s] = clip8(p1 + a2);
  p[-s] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a2);
  p[2 * s] = clip8(q2 - a3);
}

void simple_edge(uint8_t* p, int s, int step, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int k = 0; k < 16; ++k, p += step) {
    if (4 * abs(p[-s] - p[0]) + abs(p[-2 * s] - p[s]) <= t2) filter2(p, s);
  }
}

void normal_edge(uint8_t* p, int s, int step, int size, int thresh, int ithresh, int hev, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int k = 0; k < size; ++k, p += step) {
    const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t2) continue;
    if (abs(p3 - p2) > ithresh || abs(p2 - p1) > ithresh || abs(p1 - p0) > ithresh || abs(q3 - q2) > ithresh ||
        abs(q2 - q1) > ithresh || abs(q1 - q0) > ithresh) {
      continue;
    }
    if (abs(p1 - p0) > hev || abs(q1 - q0) > hev) {
      filter2(p, s);
    } else if (mb_edge) {
      filter6(p, s);
    } else {
      filter4(p, s);
    }
  }
}

struct FInfo {
  int limit, ilevel, hev, inner;
};

void strengths(const VP8& d, FInfo out[4][2]) {
  for (int s = 0; s < 4; ++s) {
    const int base = d.use_segment ? d.filter_strength[s] + (d.absolute_delta ? 0 : d.level) : d.level;
    for (int i4 = 0; i4 <= 1; ++i4) {
      int level = base;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : (level > 63 ? 63 : level);
      FInfo f = {0, 0, 0, 0};
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          ilevel = std::min(ilevel, 9 - d.sharpness);
        }
        ilevel = std::max(ilevel, 1);
        f = {2 * level + ilevel, ilevel, level >= 40 ? 2 : (level >= 15 ? 1 : 0), 0};
      }
      out[s][i4] = f;
    }
  }
}

void loop_filter(VP8& d, const std::vector<FInfo>& infos) {
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      const FInfo& f = infos[(size_t)mb_y * d.mb_w + mb_x];
      if (f.limit == 0) continue;
      uint8_t* y0 = d.py.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
      if (d.filter_type == 1) {
        if (mb_x > 0) simple_edge(y0, 1, ys, f.limit + 4);
        if (f.inner) {
          for (int k = 4; k <= 12; k += 4) simple_edge(y0 + k, 1, ys, f.limit);
        }
        if (mb_y > 0) simple_edge(y0, ys, 1, f.limit + 4);
        if (f.inner) {
          for (int k = 4; k <= 12; k += 4) simple_edge(y0 + k * ys, ys, 1, f.limit);
        }
        continue;
      }
      const size_t c0 = (size_t)mb_y * 8 * uvs + mb_x * 8;
      uint8_t* const pc[2] = {d.pu.data() + c0, d.pv.data() + c0};
      if (mb_x > 0) {
        normal_edge(y0, 1, ys, 16, f.limit + 4, f.ilevel, f.hev, true);
        for (uint8_t* c : pc) normal_edge(c, 1, uvs, 8, f.limit + 4, f.ilevel, f.hev, true);
      }
      if (f.inner) {
        for (int k = 4; k <= 12; k += 4) normal_edge(y0 + k, 1, ys, 16, f.limit, f.ilevel, f.hev, false);
        for (uint8_t* c : pc) normal_edge(c + 4, 1, uvs, 8, f.limit, f.ilevel, f.hev, false);
      }
      if (mb_y > 0) {
        normal_edge(y0, ys, 1, 16, f.limit + 4, f.ilevel, f.hev, true);
        for (uint8_t* c : pc) normal_edge(c, uvs, 1, 8, f.limit + 4, f.ilevel, f.hev, true);
      }
      if (f.inner) {
        for (int k = 4; k <= 12; k += 4) normal_edge(y0 + k * ys, ys, 1, 16, f.limit, f.ilevel, f.hev, false);
        for (uint8_t* c : pc) normal_edge(c + 4 * uvs, uvs, 1, 8, f.limit, f.ilevel, f.hev, false);
      }
    }
  }
}

// a VP8 key frame -> Y (w x h), U, V ((w + 1) / 2 x (h + 1) / 2) planes, end to end in out
void decode_vp8(const uint8_t* data, size_t n, uint8_t* out) {
  VP8 d;
  parse_vp8_header(data, n, d);
  d.intra_t.assign(4 * d.mb_w, DC_PRED);
  d.nz.assign(d.mb_w, 0);
  d.nz_dc.assign(d.mb_w, 0);
  d.top_y.assign(16 * d.mb_w, 0);
  d.top_u.assign(8 * d.mb_w, 0);
  d.top_v.assign(8 * d.mb_w, 0);
  memset(d.yuv_b, 0, sizeof(d.yuv_b));
  const size_t yw = 16 * (size_t)d.mb_w, uvw = 8 * (size_t)d.mb_w;
  d.py.assign(yw * 16 * d.mb_h, 0);
  d.pu.assign(uvw * 8 * d.mb_h, 0);
  d.pv.assign(uvw * 8 * d.mb_h, 0);
  FInfo fs[4][2];
  strengths(d, fs);
  std::vector<FInfo> infos(d.filter_type ? (size_t)d.mb_w * d.mb_h : 0);
  std::vector<MB> blocks(d.mb_w);
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    Bool& token_br = d.parts[mb_y & (d.nparts - 1)];
    memset(d.intra_l, DC_PRED, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) intra_modes(d, mb_x, blocks[mb_x]);
    if (d.br.eof) throw Fail{kErrVP8};
    d.nz_left = d.nz_dc_left = 0;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      decode_mb(d, token_br, mb_x, blocks[mb_x]);
      if (token_br.eof) throw Fail{kErrVP8};
      if (d.filter_type) {
        const MB& b = blocks[mb_x];
        FInfo f = fs[b.segment][b.is_i4x4];
        f.inner = b.f_inner;
        infos[(size_t)mb_y * d.mb_w + mb_x] = f;
      }
    }
    reconstruct_row(d, mb_y, blocks.data());
  }
  if (d.filter_type) loop_filter(d, infos);
  const int w = d.width, h = d.height, uw = (w + 1) / 2, uh = (h + 1) / 2;
  uint8_t* o = out;
  for (int y = 0; y < h; ++y, o += w) memcpy(o, d.py.data() + y * yw, w);
  for (int y = 0; y < uh; ++y, o += uw) memcpy(o, d.pu.data() + y * uvw, uw);
  for (int y = 0; y < uh; ++y, o += uw) memcpy(o, d.pv.data() + y * uvw, uw);
}

// ------------------------------------------------------------------ container
struct Layout {
  int canvas_w = 0, canvas_h = 0, x = 0, y = 0, w = 0, h = 0;
  bool lossless = false, has_alpha = false, animated = false;
  size_t image = 0, image_end = 0;
  size_t alpha = 0, alpha_size = 0;
  bool alph = false;  // an ALPH chunk (of any size) belongs to a lossy frame
  size_t exif = 0, exif_size = 0;
};

void first_exif(const uint8_t* buf, size_t start, size_t end, Layout& L) {
  for (size_t pos = start; pos + 8 <= end;) {
    const uint64_t size = le32(buf + pos + 4);
    if (size > kMaxChunk) return;
    if (!memcmp(buf + pos, "EXIF", 4) && pos + 8 + size <= end) {
      L.exif = pos + 8;
      L.exif_size = size;
      return;
    }
    pos += 8 + size + (size & 1);
  }
}

// The EXIF chunk cv2 orients an extended still by: the first one, when the VP8X EXIF flag is set and libwebp's
// demuxer accepts the file (no reserved flag, every chunk inside the RIFF, one image, its ALPH right before it,
// no animation chunk).
void still_exif(const uint8_t* buf, uint32_t flags, size_t end, Layout& L) {
  if (!(flags & 0x08) || (flags & ~0x3Eu & 0xFFu)) return;
  size_t pos = 30, first = 0, first_size = 0;
  bool found = false, image = false, alph = false, anim = false;
  while (pos < end) {
    if (end - pos < 8) return;
    const uint64_t size = le32(buf + pos + 4), padded = size + (size & 1);
    const uint8_t* tag = buf + pos;
    if (size > kMaxChunk || padded > end - pos - 8 || !memcmp(tag, "VP8X", 4) || !memcmp(tag, "ANMF", 4)) return;
    const bool is_alph = !memcmp(tag, "ALPH", 4), is_vp8l = !memcmp(tag, "VP8L", 4);
    if (is_alph || is_vp8l || !memcmp(tag, "VP8 ", 4)) {
      if (anim || image || ((is_alph || is_vp8l) && alph)) return;
      alph = is_alph;
      image = !is_alph;
    } else if (alph) {  // a chunk between ALPH and its image
      return;
    } else if (!memcmp(tag, "ANIM", 4)) {
      anim = true;
    } else if (!memcmp(tag, "EXIF", 4) && !found) {
      found = true;
      first = pos + 8;
      first_size = size;
    }
    pos += 8 + padded;
  }
  if (image && found) L.exif = first, L.exif_size = first_size;
}

// VP8GetInfo / VP8LGetInfo of the image chunk's data
void image_info(const uint8_t* buf, size_t start, size_t size, size_t end, bool lossless, Layout& L, bool& vp8l_alpha) {
  const uint8_t* d = buf + start;
  const size_t n = end - start;
  if (lossless) {
    if (n < 5 || d[0] != 0x2F || (d[4] >> 5) != 0) throw Fail{kErrFormat};
    const uint32_t bits = le32(d + 1);
    L.w = (bits & 0x3FFF) + 1;
    L.h = ((bits >> 14) & 0x3FFF) + 1;
    vp8l_alpha = (bits >> 28) & 1;
  } else {
    if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) throw Fail{kErrFormat};
    const uint32_t bits = le24(d);
    L.w = le16(d + 6) & 0x3FFF;
    L.h = le16(d + 8) & 0x3FFF;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= size || !L.w || !L.h) {
      throw Fail{kErrFormat};
    }
    vp8l_alpha = false;
  }
}

// The demuxer's StoreFrame on the ANMF chunk at pos: its offset, then ALPH (optional) and the image chunk (F.w
// stays 0 when the frame holds neither). Returns where the demuxer goes on reading (after the image, not at
// the ANMF's end).
size_t anmf_frame(const uint8_t* buf, size_t pos, uint64_t padded, size_t end, Layout& F) {
  F.x = 2 * (int)le24(buf + pos + 8);
  F.y = 2 * (int)le24(buf + pos + 11);
  if ((1ull + le24(buf + pos + 14)) * (1ull + le24(buf + pos + 17)) >= (1ull << 32)) throw Fail{kErrAnim};
  const size_t start = pos + 24;
  size_t q = start;
  if (end - q < 8 || end - q < padded - 16) throw Fail{kErrAnim};
  bool alpha = false, image = false;
  for (;;) {
    const uint64_t size = le32(buf + q + 4), cpad = size + (size & 1);
    if (size > kMaxChunk || cpad > end - q - 8) throw Fail{kErrAnim};
    const bool is_vp8l = !memcmp(buf + q, "VP8L", 4);
    if (!memcmp(buf + q, "ALPH", 4) && !alpha) {
      alpha = true;
      F.alph = true;
      F.alpha = q + 8;
      F.alpha_size = size;
    } else if (is_vp8l && alpha) {
      throw Fail{kErrAnim};
    } else if ((is_vp8l || !memcmp(buf + q, "VP8 ", 4)) && !image) {
      bool vp8l_alpha;
      F.lossless = is_vp8l;
      image_info(buf, q + 8, size, q + 8 + cpad, is_vp8l, F, vp8l_alpha);
      F.image = q + 8;
      F.image_end = q + 8 + cpad;
      image = true;
    } else {
      break;
    }
    q += 8 + cpad;
    if (q == end) break;
    if (end - q < 8) throw Fail{kErrAnim};
  }
  if (q - start > padded - 16 || (alpha && !image)) throw Fail{kErrAnim};
  if (F.lossless) F.alph = false;
  F.w = image ? F.w : 0;  // no image and no alpha: the demuxer drops the frame and reads on
  return q;
}

// libwebp's demuxer on an animation (every frame checked, as WebPAnimDecoderNew checks them), down to its
// first frame; end is the RIFF's end
void anim_layout(const uint8_t* buf, uint32_t flags, size_t end, Layout& L) {
  if (flags & ~0x3Eu & 0xFFu) throw Fail{kErrAnim};
  size_t pos = 30;
  int anim = 0, frames = 0;
  while (pos != end) {
    if (end - pos < 8) throw Fail{kErrAnim};
    const uint64_t size = le32(buf + pos + 4), padded = size + (size & 1);
    if (size > kMaxChunk || padded > end - pos - 8) throw Fail{kErrAnim};
    const uint8_t* tag = buf + pos;
    if (!memcmp(tag, "VP8X", 4) || !memcmp(tag, "ALPH", 4) || !memcmp(tag, "VP8 ", 4) || !memcmp(tag, "VP8L", 4)) {
      throw Fail{kErrAnim};
    }
    if (!memcmp(tag, "ANMF", 4)) {
      if (anim == 0 || padded < 16) throw Fail{kErrAnim};
      Layout F;
      pos = anmf_frame(buf, pos, padded, end, F);
      if (F.w == 0) continue;
      if (F.x + F.w > L.canvas_w || F.y + F.h > L.canvas_h) throw Fail{kErrAnim};
      if (frames++ == 0) {
        F.canvas_w = L.canvas_w;
        F.canvas_h = L.canvas_h;
        L = F;
      }
      continue;
    }
    if (!memcmp(tag, "ANIM", 4)) {
      if (padded < 6) throw Fail{kErrAnim};
      ++anim;
    }
    pos += 8 + padded;
  }
  if (frames == 0) throw Fail{kErrAnim};
  L.has_alpha = flags & 0x10;
  L.animated = true;
  if (flags & 0x08) first_exif(buf, 30, end, L);  // the demuxer keeps EXIF only when flagged
}

// libwebp's ParseHeadersInternal (and its demuxer for an animation)
void parse_webp(const uint8_t* buf, size_t n, Layout& L) {
  if (n < 32 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WEBP", 4)) throw Fail{kErrFormat};
  const uint64_t riff = le32(buf + 4);
  if (riff < 12 || riff > kMaxChunk || riff > n - 8) throw Fail{kErrFormat};
  size_t pos = 12;
  uint32_t flags = 0;
  bool vp8x = false;
  if (!memcmp(buf + 12, "VP8X", 4)) {
    if (le32(buf + 16) != 10) throw Fail{kErrFormat};
    flags = le32(buf + 20);
    L.canvas_w = 1 + (int)le24(buf + 24);
    L.canvas_h = 1 + (int)le24(buf + 27);
    if ((uint64_t)L.canvas_w * L.canvas_h >= (1ull << 32)) throw Fail{kErrFormat};
    vp8x = true;
    pos = 30;
    if (flags & 0x02) {
      if ((uint64_t)L.canvas_w * L.canvas_h > kMaxPixels || std::max(L.canvas_w, L.canvas_h) > kMaxSide) {
        throw Fail{kErrTooLarge};
      }
      anim_layout(buf, flags, riff + 8, L);  // the demuxer reads no further than the RIFF
      return;
    }
  }
  size_t alpha = 0, alpha_size = 0;
  bool alph = false;
  if (vp8x) {  // ParseOptionalChunks
    uint64_t total = 4 + 8 + 10;
    for (;;) {
      if (n - pos < 8) throw Fail{kErrFormat};
      const uint64_t size = le32(buf + pos + 4);
      if (size > kMaxChunk) throw Fail{kErrFormat};
      const uint64_t disk = (8 + size + 1) & ~1ull;
      total += disk;
      if (total > riff) throw Fail{kErrFormat};
      if (!memcmp(buf + pos, "VP8 ", 4) || !memcmp(buf + pos, "VP8L", 4)) break;
      if (n - pos < disk) throw Fail{kErrFormat};
      if (!memcmp(buf + pos, "ALPH", 4)) alpha = pos + 8, alpha_size = size, alph = true;
      pos += disk;
    }
  }
  if (n - pos < 8) throw Fail{kErrFormat};
  const bool lossless = !memcmp(buf + pos, "VP8L", 4);
  if (!lossless && memcmp(buf + pos, "VP8 ", 4)) throw Fail{kErrFormat};
  const uint64_t size = le32(buf + pos + 4);
  if (size > riff - 12 || size > n - pos - 8) throw Fail{kErrFormat};
  bool vp8l_alpha;
  L.lossless = lossless;
  image_info(buf, pos + 8, size, n, lossless, L, vp8l_alpha);
  if (vp8x && (L.canvas_w != L.w || L.canvas_h != L.h)) throw Fail{kErrFormat};
  if ((uint64_t)L.w * L.h > kMaxPixels) throw Fail{kErrTooLarge};
  L.canvas_w = L.w;
  L.canvas_h = L.h;
  L.has_alpha = (lossless ? vp8l_alpha : (flags & 0x10) != 0) || alph;
  L.image = pos + 8;
  L.image_end = n;
  if (!lossless && alph) L.alpha = alpha, L.alpha_size = alpha_size, L.alph = true;
  if (vp8x) still_exif(buf, flags, riff + 8, L);  // a simple file's EXIF is not read
}

size_t plane_bytes(const Layout& L) {
  const size_t wh = (size_t)L.w * L.h;
  if (L.lossless) return 4 * wh;
  const size_t uv = (size_t)((L.w + 1) / 2) * ((L.h + 1) / 2);
  return wh + 2 * uv + (L.alph ? wh : 0);
}

void fill_info(const Layout& L, int* info) {
  memset(info, 0, kInfoLen * sizeof(int));
  info[0] = L.lossless ? 2 : 1;
  info[1] = L.canvas_w;
  info[2] = L.canvas_h;
  info[3] = L.w;
  info[4] = L.h;
  info[5] = L.x;
  info[6] = L.y;
  info[7] = L.has_alpha;
  info[8] = !L.lossless && L.alph;
  info[9] = (int)L.exif;
  info[10] = (int)L.exif_size;
  info[11] = (int)plane_bytes(L);
  info[12] = L.animated;
}

// the image (or first frame) into planes: lossy Y, U, V (+ alpha), lossless ARGB
void decode_planes(const uint8_t* buf, const Layout& L, uint8_t* planes) {
  if (L.lossless) {
    decode_vp8l(buf + L.image, L.image_end - L.image, L.w, L.h, reinterpret_cast<uint32_t*>(planes));
    return;
  }
  decode_vp8(buf + L.image, L.image_end - L.image, planes);
  if (L.alph) {
    const size_t uv = (size_t)((L.w + 1) / 2) * ((L.h + 1) / 2);
    decode_alpha(buf + L.alpha, L.alpha_size, L.w, L.h, planes + (size_t)L.w * L.h + 2 * uv);
  }
}

int guarded(int (*fn)(void*), void* arg) {
  try {
    return fn(arg);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {  // std::bad_alloc: a stream that asks for more than the host has
    return kErrFormat;
  }
}

#ifdef __CUDACC__
// one thread a pixel: a CUDA block covers 32 columns x 8 rows of the frame
__global__ void __launch_bounds__(256) webp_color_kernel(const uint8_t* __restrict__ planes,
                                                         uint8_t* __restrict__ out, int w, int h,
                                                         int out_w, int x0, int y0) {
  const int x = blockIdx.x * 32 + (threadIdx.x & 31), y = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (x >= w || y >= h) return;
  const int uw = (w + 1) >> 1, uh = (h + 1) >> 1;
  const uint8_t* u = planes + (size_t)w * h;
  const uint8_t* v = u + (size_t)uw * uh;
  // the near chroma row / column is index >> 1, the far one the next (odd) or previous (even), clamped
  const int nr = y >> 1, nc = x >> 1;
  const int fr = min(max((y & 1) ? nr + 1 : nr - 1, 0), uh - 1);
  const int fc = min(max((x & 1) ? nc + 1 : nc - 1, 0), uw - 1);
  const size_t inn = (size_t)nr * uw + nc, inf = (size_t)nr * uw + fc, ifn = (size_t)fr * uw + nc,
               iff = (size_t)fr * uw + fc;
  const int uu = ((((int)u[inn] + 3 * u[inf] + 3 * u[ifn] + u[iff] + 8) >> 3) + u[inn]) >> 1;
  const int vv = ((((int)v[inn] + 3 * v[inf] + 3 * v[ifn] + v[iff] + 8) >> 3) + v[inn]) >> 1;
  const int yy = (planes[(size_t)y * w + x] * 19077) >> 8;
  auto clip = [](int t) { return (uint8_t)((t & ~16383) == 0 ? t >> 6 : (t < 0 ? 0 : 255)); };
  uint8_t* o = out + ((size_t)(y + y0) * out_w + x + x0) * 3;
  o[0] = clip(yy + ((uu * 33050) >> 8) - 17685);
  o[1] = clip(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708);
  o[2] = clip(yy + ((vv * 26149) >> 8) - 14234);
}

cudaError_t launch_color(const uint8_t* planes, uint8_t* out, int w, int h, int out_w, int x0, int y0,
                         cudaStream_t st) {
  const dim3 grid((w + 31) / 32, (h + 7) / 8), block(256);
  webp_color_kernel<<<grid, block, 0, st>>>(planes, out, w, h, out_w, x0, y0);
  return cudaGetLastError();
}
#endif

}  // namespace

// info (int32[16]) gets 0 kind (1 lossy, 2 lossless), 1-2 canvas W H, 3-4 frame W H, 5-6 frame x y,
// 7 has_alpha, 8 an alpha plane follows the lossy planes, 9-10 EXIF offset and length (0: none), 11 host
// plane bytes, 12 animated. Each entry point returns 0, a negative code (data/webp.py _ERRORS) or a CUDA
// error; kGrow when the caller's buffers are too small for the record it filled in.

// The host decode alone: planes (host, cap bytes) get info[11] bytes (lossy Y, U, V and alpha; lossless ARGB).
extern "C" int fce_webp_planes(const void* buf, long long len, int* info, void* planes, long long cap) {
  struct Args {
    const uint8_t* buf;
    size_t len;
    int* info;
    uint8_t* planes;
    long long cap;
  } a = {static_cast<const uint8_t*>(buf), (size_t)len, info, static_cast<uint8_t*>(planes), cap};
  return guarded(
      [](void* p) {
        Args& a = *static_cast<Args*>(p);
        Layout L;
        parse_webp(a.buf, a.len, L);
        fill_info(L, a.info);
        if ((long long)plane_bytes(L) > a.cap) return (int)kGrow;
        decode_planes(a.buf, L, a.planes);
        return 0;
      },
      &a);
}

#ifdef __CUDACC__
// webp_color_kernel alone, on the caller's stream: planes (device Y, U, V of a w x h frame) -> out (device,
// BGR, rows of out_w pixels) at (x0, y0)
extern "C" int fce_webp_color(const void* planes, void* out, int w, int h, int out_w, int x0, int y0,
                              void* stream) {
  if (w < 1 || h < 1 || out_w < w + x0 || x0 < 0 || y0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_color(static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), w, h,
                                       out_w, x0, y0, static_cast<cudaStream_t>(stream)));
}

// A whole file: parse and decode into h_planes (pinned); a lossy frame: copy to d_planes, the kernel into d_out
// (the canvas zeroed first when the frame does not cover it), copy d_out to h_out (pinned); a lossless frame:
// BGR written into h_out on the host. Synchronises the stream. h_planes and d_planes hold plane_cap bytes,
// d_out and h_out out_cap; kGrow before touching any when info[11] > plane_cap or W H 3 > out_cap.
// times (float[4] or null): ms of the host decode, H2D, colour, D2H.
extern "C" int fce_webp_decode(const void* buf, long long len, int* info, void* h_planes, void* d_planes,
                               long long plane_cap, void* d_out, void* h_out, long long out_cap, float* times,
                               void* stream) {
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  Layout L;
  const auto t0 = std::chrono::steady_clock::now();
  struct Args {
    const uint8_t* b;
    size_t n;
    Layout* L;
    int* info;
    uint8_t* planes;
    long long plane_cap, out_cap;
  } a = {b, (size_t)len, &L, info, static_cast<uint8_t*>(h_planes), plane_cap, out_cap};
  int err = guarded(
      [](void* p) {
        Args& a = *static_cast<Args*>(p);
        parse_webp(a.b, a.n, *a.L);
        fill_info(*a.L, a.info);
        if ((long long)plane_bytes(*a.L) > a.plane_cap || 3LL * a.L->canvas_w * a.L->canvas_h > a.out_cap) {
          return (int)kGrow;
        }
        decode_planes(a.b, *a.L, a.planes);
        return 0;
      },
      &a);
  if (err) return err;
  const auto t1 = std::chrono::steady_clock::now();
  const size_t out_bytes = (size_t)3 * L.canvas_w * L.canvas_h;
  const bool covers = L.w == L.canvas_w && L.h == L.canvas_h;
  if (times) {
    times[0] = std::chrono::duration<float, std::milli>(t1 - t0).count();
    times[1] = times[2] = times[3] = 0.0f;
  }
  if (L.lossless) {  // BGR on the host, at the frame's offset on a canvas of zeros
    uint8_t* o = static_cast<uint8_t*>(h_out);
    if (!covers) memset(o, 0, out_bytes);
    const uint32_t* argb = static_cast<const uint32_t*>(h_planes);
    for (int y = 0; y < L.h; ++y) {
      uint8_t* r = o + ((size_t)(y + L.y) * L.canvas_w + L.x) * 3;
      for (int x = 0; x < L.w; ++x) {
        const uint32_t p = argb[(size_t)y * L.w + x];
        r[3 * x] = (uint8_t)p;
        r[3 * x + 1] = (uint8_t)(p >> 8);
        r[3 * x + 2] = (uint8_t)(p >> 16);
      }
    }
    return 0;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaEvent_t ev[4];
  if (times) {
    for (int i = 0; i < 4; ++i) {
      if (cudaEventCreate(&ev[i]) != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
    cudaEventRecord(ev[0], st);
  }
  const size_t uv = (size_t)((L.w + 1) / 2) * ((L.h + 1) / 2), yuv = (size_t)L.w * L.h + 2 * uv;
  cudaError_t e = cudaMemcpyAsync(d_planes, h_planes, yuv, cudaMemcpyHostToDevice, st);
  if (times) cudaEventRecord(ev[1], st);
  if (e == cudaSuccess && !covers) e = cudaMemsetAsync(d_out, 0, out_bytes, st);
  if (e == cudaSuccess) {
    e = launch_color(static_cast<const uint8_t*>(d_planes), static_cast<uint8_t*>(d_out), L.w, L.h, L.canvas_w,
                     L.x, L.y, st);
  }
  if (times) cudaEventRecord(ev[2], st);
  if (e == cudaSuccess) e = cudaMemcpyAsync(h_out, d_out, out_bytes, cudaMemcpyDeviceToHost, st);
  if (times) cudaEventRecord(ev[3], st);
  const cudaError_t sync = cudaStreamSynchronize(st);
  if (e == cudaSuccess) e = sync;
  if (times) {
    for (int i = 0; i < 3; ++i) cudaEventElapsedTime(&times[1 + i], ev[i], ev[i + 1]);
    for (int i = 0; i < 4; ++i) cudaEventDestroy(ev[i]);
  }
  return static_cast<int>(e);
}
#endif
