// TIFF's byte-serial codecs, host C++ (no device code): LZW and PackBits as
// libtiff decodes them, which cv2.imdecode (fce_yolo_tpu/utils/patches.py:18)
// runs for a TIFF. The plain versions, step for step the same, are
// lzw_decode and packbits_decode in fce_yolo_tpu_torch/data/tiff.py
// (Python); these are their fast twins for the card's machine, built into the
// kernel libraries by nvcc as every csrc/*.cu is (plain C interface, ctypes;
// reentrant, no globals). Each code or packet depends on the one before, so
// there is nothing for the card to do in parallel: the decoded strip goes to
// the card with the rest of the image.
//
// LZW: codes MSB first, 9 to 12 bits, the width raised one code early (when
// the next free entry reaches 2^width - 1), 256 clears the table, 257 ends
// the data. A string is written back to front from its table entry (prefix,
// last byte), cut at the room asked for as libtiff cuts a strip.
// PackBits: n < 128 copies n + 1 bytes, n > 128 repeats the next byte
// 257 - n times, 128 is skipped; a run past the room is cut.
//
// Either decodes exactly `need` bytes or returns an error: -1 the data ends
// first, -2 an LZW code past the table (both leave what was decoded and zero
// the rest, as libtiff leaves its strip buffer), -3 old-style (LSB-first) LZW.
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

enum { kShort = -1, kCorrupt = -2, kOldStyle = -3, kUnknown = -4 };

struct Entry {
  int prefix;  // the entry this one extends, -1 for a single byte
  int len;
  uint8_t last, first;
};

int lzw(const uint8_t* src, long long n, uint8_t* dst, long long need) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return kOldStyle;
  std::vector<Entry> tab(4096);
  for (int i = 0; i < 256; ++i) tab[i] = Entry{-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  int next = 258, width = 9, prev = -1, nacc = 0;
  uint64_t acc = 0;
  long long out = 0, pos = 0;
  while (out < need) {
    while (nacc < width && pos < n) {
      acc = (acc << 8) | src[pos++];
      nacc += 8;
    }
    if (nacc < width) break;  // no EOI: the data ran out
    nacc -= width;
    const int code = static_cast<int>((acc >> nacc) & ((1u << width) - 1));
    if (code == 256) {
      next = 258;
      width = 9;
      prev = -1;
      continue;
    }
    if (code == 257) break;
    if (prev >= 0) {
      if (code > next || next >= 4096) {
        memset(dst + out, 0, static_cast<size_t>(need - out));
        return kCorrupt;
      }
      const uint8_t first = code < next ? tab[code].first : tab[prev].first;
      tab[next] = Entry{prev, tab[prev].len + 1, first, tab[prev].first};
      ++next;
      if (next + 1 >= (1 << width) && width < 12) ++width;
    } else if (code >= 256) {
      memset(dst + out, 0, static_cast<size_t>(need - out));
      return kCorrupt;
    }
    const int len = tab[code].len;
    for (int i = len - 1, c = code; i >= 0; --i, c = tab[c].prefix) {
      if (out + i < need) dst[out + i] = tab[c].last;
    }
    out += len;
    prev = code;
  }
  if (out >= need) return 0;
  memset(dst + out, 0, static_cast<size_t>(need - out));
  return kShort;
}

int packbits(const uint8_t* src, long long n, uint8_t* dst, long long need) {
  long long out = 0, pos = 0;
  while (pos < n && out < need) {
    const int c = src[pos++];
    if (c == 128) continue;
    if (c > 128) {
      if (pos >= n) break;
      long long k = 257 - c;
      if (k > need - out) k = need - out;
      memset(dst + out, src[pos++], static_cast<size_t>(k));
      out += k;
    } else {
      long long k = c + 1;
      if (k > need - out) k = need - out;
      if (n - pos < k) break;
      memcpy(dst + out, src + pos, static_cast<size_t>(k));
      out += k;
      pos += k;
    }
  }
  if (out >= need) return 0;
  memset(dst + out, 0, static_cast<size_t>(need - out));
  return kShort;
}

}  // namespace

// One strip or tile: `n` bytes at src, compressed by TIFF compression 5 (LZW) or 32773 (PackBits), into
// exactly `need` bytes at dst (nothing is written past them). Returns 0 or a negative code (see the top).
extern "C" int fce_tiff_decode(int compression, const void* src, long long n, void* dst, long long need) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  if (compression == 5) return lzw(s, n, d, need);
  if (compression == 32773) return packbits(s, n, d, need);
  return kUnknown;
}
