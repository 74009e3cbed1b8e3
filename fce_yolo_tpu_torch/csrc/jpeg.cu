// Baseline and progressive JPEG decode for Hopper (sm_90a): host entropy decode, then two kernels.
//
// Replaces what the JAX package reads every image with: cv2.imdecode(buf,
// IMREAD_COLOR) in fce_yolo_tpu/utils/patches.py:18 (libjpeg-turbo). Not a
// Pallas kernel: the card takes the pixel stages of a host library. The
// output is bit-equal to cv2's on the baseline files it reads (see
// fce_yolo_tpu_torch/data/jpeg.py, whose plain version this mirrors).
//
// 1. Host entropy decode (C++ in this file, reentrant: no globals, so loader
//    threads may call it at once): markers, Huffman tables as 16-bit lookup
//    tables (slots 0 and 1 that no DHT defined take the Annex K.3 tables, as
//    Motion-JPEG frames need), DC prediction reset at each restart interval,
//    interleaved and non-interleaved scans, libjpeg's zero fill when a marker
//    cuts the data short. Out: int16 coefficient planes, one a component, natural order,
//    MCU-padded block grids laid end to end. A progressive file (SOF2) is
//    parsed whole first; its scans (DC first and refinement, AC first with
//    EOB runs, AC refinement with correction bits; progressive_block) fill
//    the same planes one after another, so the kernels take them as they
//    take a sequential file's. One whose scans leave coefficients 1-9
//    unfinished is refused (libjpeg would smooth its blocks).
// 2. jpeg_idct_kernel: dequantise + libjpeg's ISLOW IDCT (jidctint:
//    CONST_BITS 13, PASS1_BITS 2; columns descaled by 11, rows by 18, with
//    rounding; out clamp(v + 128, 0, 255), the saturation of the SIMD build
//    cv2 runs). 32 blocks a CUDA block, 8 threads a block: one thread a
//    column, then (after the block sits in shared memory) a row. Writes
//    uint8 component planes.
// 3. jpeg_color_kernel: one thread a pixel; libjpeg-turbo's fancy
//    upsampling (h2v1, h1v2, h2v2, with the edge sample standing in past an
//    edge; replication for every other ratio and for h2 components two
//    samples wide or less), YCbCr -> BGR with jdcolor's SCALEBITS 16
//    constants, RGB (Adobe transform 0) reordered, gray copied. Writes BGR
//    uint8 (H, W, 3).
//
// fce_jpeg_decode does a whole image with no return to Python: entropy
// decode into the caller's pinned buffer, one H2D copy, both kernels, one
// D2H copy, cudaStreamSynchronize on the caller's stream. ctypes releases
// the interpreter lock for the whole call.
//
// What bounds it on the H100: the host. The entropy decode is serial, some
// ms for a 480 x 640 image; each kernel moves 3 bytes a sample (int16 in,
// uint8 out; the colour kernel ~1.5-3 bytes in, 3 out a pixel), a few us
// of HBM time, so at one image a call the kernels are launch-bound.
// Batching images into one launch is later work. Times: PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <chrono>
#include <climits>
#include <vector>

namespace {

constexpr int kInfoLen = 48;
constexpr int kBlocksPerCta = 32;  // IDCT: JPEG blocks a CUDA block, 8 threads each
enum {
  kErrFormat = -1, kErrProgressive = -2, kErrArith = -3, kErrPrecision = -4, kErrLossless = -5,
  kErrComponents = -6, kErrHierarchical = -7, kErrTruncated = -8, kErrFractional = -9, kErrTable = -10,
  kErrDnl = -11, kErrTooLarge = -12,
  kGrow = -13,  // fce_jpeg_decode / fce_jpeg_coefficients: the caller's buffers are too small (info holds the sizes)
  kErrProgression = -14,  // a progressive scan's Ss, Se, Ah, Al break the rules
  kErrBreaksOff = -15,    // a progressive file's entropy data ends before its scan does
};
// kErrProgressive (-2): a progressive file whose scans leave coefficients unfinished (libjpeg smooths its blocks)
// cv2's CV_IO_MAX_IMAGE_PIXELS: imdecode refuses a larger frame
constexpr long long kMaxPixels = 1LL << 30;
enum { kGray = 0, kYcc = 1, kRgb = 2 };
// upsampling of a component: plain copy or replication, or one of libjpeg-turbo's fancy filters
enum { kReplicate = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3 };

// zig-zag position -> natural index; positions past 63 land on 63, as libjpeg's table does
const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t counts[16];
  uint8_t symbols[256];
};

// ITU T.81 Annex K.3: libjpeg-turbo's std_huff_tables puts these in slots 0 (luminance) and 1
// (chrominance) when no DHT defined them, which Motion-JPEG frames (no DHT) rely on
const uint8_t kStdCounts[2][2][16] = {
    {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}},
    {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d}, {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}}};
const uint8_t kStdAcSymbols[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
     0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
     0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
     0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// The table a scan finds in slot (tc, th): the DHT's, else Annex K.3's for slots 0 and 1, else undefined
Huff table_in_slot(const Huff (&huff)[2][4], int tc, int th) {
  if (huff[tc][th].defined || th > 1) return huff[tc][th];
  Huff h;
  h.defined = true;
  memcpy(h.counts, kStdCounts[tc][th], 16);
  if (tc == 0) {
    for (int i = 0; i < 12; ++i) h.symbols[i] = (uint8_t)i;
  } else {
    memcpy(h.symbols, kStdAcSymbols[th], 162);
  }
  return h;
}

struct Comp {
  int id, h, v, tq, bw, bh, width, height;
  long long off;  // first coefficient of the plane
};

struct Scan {
  int ns;
  int comp[4];
  Huff dc[4], ac[4];  // the tables as defined when the scan starts
  const uint8_t* data;
  long long len;
  int restart;
  int ss = 0, se = 63, ah = 0, al = 0;  // spectral selection and successive approximation (progressive)
};

struct Parsed {
  bool progressive = false;
  int width = 0, height = 0, ncomp = 0, color = kYcc, orientation = 1, hmax = 1, vmax = 1;
  long long total = 0;
  Comp comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  std::vector<Scan> scans;
};

// Geometry and tables of an image as the kernels take them (a kernel parameter, by value)
struct Geom {
  int ncomp, color, width, height;
  int blk_off[4];  // first block of each component; blk_off[ncomp] = all blocks
  int bw[3], ch[3], cw[3], mode[3], fh[3], fv[3];
  uint16_t q[3][64];
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int exif_orientation(const uint8_t* body, long long len) {
  if (len < 14) return 1;
  const uint8_t* t = body + 6;
  const long long n = len - 6;
  const bool le = t[0] == 'I' && t[1] == 'I';  // cv2's Exif reader: any other pair is big-endian
  auto u16 = [&](long long o) { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
  if (u16(2) != 42) return 1;
  auto u32 = [&](long long o) {
    return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24)
              : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) | ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3];
  };
  const long long off = u32(4);
  if (off + 2 > n) return 1;
  const int count = u16(off);
  for (int i = 0; i < count; ++i) {
    const long long e = off + 2 + 12LL * i;
    if (e + 12 > n) break;
    if (u16(e) == 0x0112) {
      const int v = u16(e + 8);
      return v >= 1 && v <= 8 ? v : 1;
    }
  }
  return 1;
}

// Markers -> Parsed; 0 or a negative code (the Python wrapper's _ERRORS).
int parse(const uint8_t* buf, long long n, Parsed& P) {
  if (n < 3 || buf[0] != 0xFF || buf[1] != 0xD8 || buf[2] != 0xFF) return kErrFormat;
  long long pos = 2;
  Huff huff[2][4];
  int restart = 0;
  bool frame = false, jfif = false, adobe = false, have_orientation = false;
  int transform = 1;
  for (;;) {
    while (pos + 1 < n && buf[pos] == 0xFF && buf[pos + 1] == 0xFF) ++pos;
    if (pos + 2 > n || buf[pos] != 0xFF) return kErrTruncated;
    const int marker = buf[pos + 1];
    pos += 2;
    if (marker == 0xD9) break;
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    switch (marker) {
      case 0xC3: return kErrLossless;
      case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF: return kErrHierarchical;
      case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE: case 0xCF: return kErrArith;
      case 0xDC: return kErrDnl;
      default: break;
    }
    if (pos + 2 > n) return kErrTruncated;
    const int length = be16(buf + pos);
    if (length < 2 || pos + length > n) return kErrTruncated;
    const uint8_t* body = buf + pos + 2;
    const int blen = length - 2;
    pos += length;
    if (marker == 0xDB) {  // DQT
      for (int p = 0; p < blen;) {
        const int pq = body[p] >> 4, tq = body[p] & 15, size = pq ? 128 : 64;
        if (tq > 3 || p + 1 + size > blen) return kErrFormat;
        for (int k = 0; k < 64; ++k)
          P.qt[tq][kNatural[k]] = pq ? (uint16_t)be16(body + p + 1 + 2 * k) : body[p + 1 + k];
        P.qt_defined[tq] = true;
        p += 1 + size;
      }
    } else if (marker == 0xC4) {  // DHT
      for (int p = 0; p < blen;) {
        if (p + 17 > blen) return kErrFormat;
        const int tc = body[p] >> 4, th = body[p] & 15;
        int sum = 0;
        for (int i = 0; i < 16; ++i) sum += body[p + 1 + i];
        if (tc > 1 || th > 3 || sum > 256 || p + 17 + sum > blen) return kErrFormat;
        Huff& h = huff[tc][th];
        h.defined = true;
        memcpy(h.counts, body + p + 1, 16);
        memcpy(h.symbols, body + p + 17, sum);
        p += 17 + sum;
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return kErrFormat;
      restart = be16(body);
    } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {  // SOF0 / SOF1 / SOF2
      if (frame || blen < 6) return kErrFormat;
      frame = true;
      P.progressive = marker == 0xC2;
      if (body[0] != 8) return kErrPrecision;
      P.height = be16(body + 1);
      P.width = be16(body + 3);
      P.ncomp = body[5];
      if (P.ncomp != 1 && P.ncomp != 3) return kErrComponents;
      if (P.height == 0) return kErrDnl;
      if (P.width == 0 || blen < 6 + 3 * P.ncomp) return kErrFormat;
      for (int i = 0; i < P.ncomp; ++i) {
        Comp& c = P.comp[i];
        c.id = body[6 + 3 * i];
        c.h = body[7 + 3 * i] >> 4;
        c.v = body[7 + 3 * i] & 15;
        c.tq = body[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kErrFormat;
      }
    } else if (marker == 0xDA) {  // SOS
      if (!frame || blen < 1) return kErrFormat;
      Scan s;
      s.ns = body[0];
      if (s.ns < 1 || s.ns > P.ncomp || blen < 4 + 2 * s.ns) return kErrFormat;
      if (P.progressive) {
        s.ss = body[1 + 2 * s.ns];
        s.se = body[2 + 2 * s.ns];
        s.ah = body[3 + 2 * s.ns] >> 4;
        s.al = body[3 + 2 * s.ns] & 15;
      }
      for (int i = 0; i < s.ns; ++i) {
        int j = -1;
        for (int c = 0; c < P.ncomp; ++c)
          if (P.comp[c].id == body[1 + 2 * i]) j = c;
        if (j < 0) return kErrFormat;
        s.comp[i] = j;
        const int td = body[2 + 2 * i] >> 4, ta = body[2 + 2 * i] & 15;
        if (td > 3 || ta > 3) return kErrTable;
        s.dc[i] = table_in_slot(huff, 0, td);
        s.ac[i] = table_in_slot(huff, 1, ta);
        // a scan needs the tables it codes with: both for a sequential one, DC for a first DC scan, AC for an AC one
        const bool dc_used = !P.progressive || (s.ss == 0 && s.ah == 0), ac_used = !P.progressive || s.ss > 0;
        if ((dc_used && !s.dc[i].defined) || (ac_used && !s.ac[i].defined)) return kErrTable;
      }
      int mcu_blocks = 0;
      for (int i = 0; i < s.ns; ++i) mcu_blocks += P.comp[s.comp[i]].h * P.comp[s.comp[i]].v;
      if (s.ns > 1 && mcu_blocks > 10) return kErrFormat;  // the standard's limit for an interleaved MCU
      if (P.progressive && (s.se > 63 || s.ss > s.se || (s.ss == 0) != (s.se == 0) || (s.ss && s.ns != 1) ||
                            s.al > 13 || (s.ah && s.al != s.ah - 1)))
        return kErrProgression;
      // the entropy data runs to the first marker that is not RSTn (FF 00 is a stuffed FF, FF FF a fill byte)
      long long end = pos;
      while (end < n && !(buf[end] == 0xFF && end + 1 < n && buf[end + 1] != 0x00 && buf[end + 1] != 0xFF &&
                          (buf[end + 1] < 0xD0 || buf[end + 1] > 0xD7)))
        ++end;
      if (end + 1 >= n) return kErrTruncated;
      s.data = buf + pos;
      s.len = end - pos;
      s.restart = restart;
      P.scans.push_back(s);
      pos = end;
    } else if (marker == 0xE0) {  // APP0
      if (blen >= 14 && memcmp(body, "JFIF\0", 5) == 0) jfif = true;
    } else if (marker == 0xE1) {  // APP1
      if (!have_orientation && blen >= 6 && memcmp(body, "Exif\0\0", 6) == 0) {
        P.orientation = exif_orientation(body, blen);
        have_orientation = true;
      }
    } else if (marker == 0xEE) {  // APP14
      if (blen >= 12 && memcmp(body, "Adobe", 5) == 0) {
        adobe = true;
        transform = body[11];
      }
    } else if (!(marker == 0xC8 || (marker >= 0xE2 && marker <= 0xEF) || (marker >= 0xF0 && marker <= 0xFE))) {
      return kErrFormat;
    }
  }
  if (!frame || P.scans.empty()) return kErrFormat;
  for (int i = 0; i < P.ncomp; ++i) {
    P.hmax = P.comp[i].h > P.hmax ? P.comp[i].h : P.hmax;
    P.vmax = P.comp[i].v > P.vmax ? P.comp[i].v : P.vmax;
  }
  const int mcux = (P.width + 8 * P.hmax - 1) / (8 * P.hmax), mcuy = (P.height + 8 * P.vmax - 1) / (8 * P.vmax);
  P.total = 0;
  for (int i = 0; i < P.ncomp; ++i) {
    Comp& c = P.comp[i];
    if (P.hmax % c.h || P.vmax % c.v) return kErrFractional;
    if (!P.qt_defined[c.tq]) return kErrTable;
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.width = (int)(((long long)P.width * c.h + P.hmax - 1) / P.hmax);
    c.height = (int)(((long long)P.height * c.v + P.vmax - 1) / P.vmax);
    c.off = P.total;
    P.total += 64LL * c.bw * c.bh;
  }
  // the record, the planes' offsets and the kernels' indices are 32-bit
  if ((long long)P.width * P.height > kMaxPixels || P.total > INT_MAX || 3LL * P.width * P.height > INT_MAX)
    return kErrTooLarge;
  if (P.progressive) {
    // libjpeg-turbo's test for block smoothing (jdcoefct.c smoothing_ok): every component's DC coded, and some
    // component's zig-zag positions 1-9 left with bits to come (its last scan's Al > 0) or never coded
    int bits[3][64];
    for (int c = 0; c < P.ncomp; ++c)
      for (int k = 0; k < 64; ++k) bits[c][k] = -1;
    for (const Scan& s : P.scans)
      for (int i = 0; i < s.ns; ++i)
        for (int k = s.ss; k <= s.se; ++k) bits[s.comp[i]][k] = s.al;
    bool dc_known = true, unfinished = false;
    for (int c = 0; c < P.ncomp; ++c) {
      dc_known = dc_known && bits[c][0] >= 0;
      for (int k = 1; k < 10; ++k) unfinished = unfinished || bits[c][k] != 0;
    }
    if (dc_known && unfinished) return kErrProgressive;
  }
  if (P.ncomp == 1) {
    P.color = kGray;
  } else if (jfif) {
    P.color = kYcc;
  } else if (adobe) {
    P.color = transform == 0 ? kRgb : kYcc;
  } else {
    P.color = P.comp[0].id == 82 && P.comp[1].id == 71 && P.comp[2].id == 66 ? kRgb : kYcc;
  }
  return 0;
}

void fill_info(const Parsed& P, int* info) {
  memset(info, 0, kInfoLen * sizeof(int));
  info[0] = P.width;
  info[1] = P.height;
  info[2] = P.ncomp;
  info[3] = P.color;
  info[4] = P.orientation;
  info[5] = P.hmax;
  info[6] = P.vmax;
  info[7] = (int)P.total;
  for (int c = 0; c < P.ncomp; ++c) {
    const Comp& k = P.comp[c];
    int* r = info + 16 + 8 * c;
    r[0] = k.h;
    r[1] = k.v;
    r[2] = k.bw;
    r[3] = k.bh;
    r[4] = k.width;
    r[5] = k.height;
    r[6] = (int)k.off;
    r[7] = k.tq;
  }
}

// Each component's quantisation table, natural order, into q (3 x 64)
void component_tables(const Parsed& P, int* q) {
  for (int c = 0; c < P.ncomp; ++c)
    for (int k = 0; k < 64; ++k) q[c * 64 + k] = P.qt[P.comp[c].tq][k];
}

// 16 bits ahead -> (code length << 8) | symbol; a prefix no code starts is 17 bits and symbol 0
// (libjpeg's "bad Huffman code")
void build_lookup(const Huff& h, std::vector<uint16_t>& lut) {
  lut.assign(65536, 17 << 8);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < h.counts[len - 1]; ++i) {
      const int lo = code << (16 - len), span = 1 << (16 - len);
      if (lo + span <= 65536)
        for (int j = 0; j < span; ++j) lut[lo + j] = (uint16_t)((len << 8) | h.symbols[k]);
      ++code;
      ++k;
    }
    code <<= 1;
  }
}

// Bits of one restart interval, FF 00 unstuffed; past the first marker, zero bits (counted in fake)
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int bits = 0;
  bool marker = false;
  long long fake = 0;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      } else {
        marker = true;
      }
      if (marker) fake += 8;
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek16() {
    if (bits < 32) fill();
    return (uint32_t)(acc >> 48);
  }
  void skip(int n) {
    acc <<= n;
    bits -= n;
  }
  int get(int n) {  // 1 <= n <= 16
    const int v = (int)(peek16() >> (16 - n));
    skip(n);
    return v;
  }
  bool overrun() const { return fake > bits; }  // zero bits past the data were consumed
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// One block of a progressive scan, as libjpeg's jdphuff decodes it: DC first (the difference added to the
// prediction, shifted left by Al) and refinement (one bit OR-ed in at Al); AC first (runs, values shifted left by Al,
// EOB runs of 2^r + r bits blocks) and refinement (a new +-2^Al after its run of still-zero positions, a
// correction bit for each already non-zero coefficient passed, also through an EOB run)
inline void progressive_block(const Scan& s, BitReader& br, const uint16_t* dc_lut, const uint16_t* ac_lut, int& pred,
                              int& eobrun, int16_t* out) {
  const int p1 = 1 << s.al, m1 = -p1;
  if (s.ss == 0) {
    if (s.ah) {
      if (br.get(1)) out[0] = static_cast<int16_t>(out[0] | p1);
      return;
    }
    const uint16_t e = dc_lut[br.peek16()];
    br.skip(e >> 8);
    int t = e & 255;
    if (t) t = t > 16 ? 0 : extend(br.get(t), t);
    pred += t;
    out[0] = static_cast<int16_t>(pred * p1);
    return;
  }
  int k = s.ss;
  if (!s.ah) {  // AC first
    if (eobrun) {
      --eobrun;
      return;
    }
    for (; k <= s.se; ++k) {
      const uint16_t e = ac_lut[br.peek16()];
      br.skip(e >> 8);
      const int r = (e >> 4) & 15, z = e & 15;
      if (z) {
        k += r;
        out[kNatural[k]] = static_cast<int16_t>(extend(br.get(z), z) * p1);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
        break;
      }
    }
    return;
  }
  if (!eobrun) {  // AC refinement
    for (; k <= s.se; ++k) {
      const uint16_t e = ac_lut[br.peek16()];
      br.skip(e >> 8);
      int r = (e >> 4) & 15, t = e & 15;
      if (t) {
        t = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = (1 << r) + (r ? br.get(r) : 0);
        break;
      }
      for (; k <= s.se; ++k) {
        int16_t& c = out[kNatural[k]];
        if (c) {
          if (br.get(1) && !(c & p1)) c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
        } else if (--r < 0) {
          break;
        }
      }
      if (t) out[kNatural[k]] = static_cast<int16_t>(t);
    }
  }
  if (eobrun) {
    for (; k <= s.se; ++k) {
      int16_t& c = out[kNatural[k]];
      if (c && br.get(1) && !(c & p1)) c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
    }
    --eobrun;
  }
}

// Huffman data of every scan -> coef (P.total int16, zeroed here); returns 1 when a marker cut a sequential file's
// data short (zero fill), kErrBreaksOff when it cut a progressive one's, else 0
int decode_coefficients(const Parsed& P, int16_t* coef) {
  memset(coef, 0, (size_t)P.total * sizeof(int16_t));
  bool cut = false;
  std::vector<uint16_t> dc_lut[4], ac_lut[4];
  for (const Scan& s : P.scans) {
    int gw, gh, nblk = 0;
    int bj[10], bby[10], bbx[10];  // the blocks of one MCU: component slot, row, column
    const bool alone = s.ns == 1;  // non-interleaved: MCU (my, mx) is the component's block (my, mx)
    if (alone) {
      const Comp& c = P.comp[s.comp[0]];
      gw = (c.width + 7) / 8;
      gh = (c.height + 7) / 8;
      bj[0] = bby[0] = bbx[0] = 0;
      nblk = 1;
    } else {
      gw = (P.width + 8 * P.hmax - 1) / (8 * P.hmax);
      gh = (P.height + 8 * P.vmax - 1) / (8 * P.vmax);
      for (int j = 0; j < s.ns; ++j) {
        const Comp& c = P.comp[s.comp[j]];
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx) {
            bj[nblk] = j;
            bby[nblk] = by;
            bbx[nblk++] = bx;
          }
      }
    }
    for (int j = 0; j < s.ns; ++j) {
      if (s.dc[j].defined) build_lookup(s.dc[j], dc_lut[j]);
      if (s.ac[j].defined) build_lookup(s.ac[j], ac_lut[j]);
    }
    const long long total = (long long)gw * gh;
    const long long per = s.restart ? s.restart : total;
    const uint8_t* p = s.data;
    const uint8_t* end = s.data + s.len;
    bool at_data = true;  // the reader stands at this interval's data (else a marker ended the scan)
    for (long long m0 = 0; m0 < total; m0 += per) {
      if (m0) {  // to the next RSTn; a scan that ended early has none
        at_data = false;
        while (p + 1 < end) {
          if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
            p += 2;
            at_data = true;
            break;
          }
          p += p[0] == 0xFF && p[1] == 0x00 ? 2 : 1;
        }
        if (!at_data) {
          if (P.progressive) return kErrBreaksOff;
          cut = true;
          break;
        }
      }
      BitReader br{p, end};
      int pred[4] = {0, 0, 0, 0}, eobrun = 0;
      const long long m1 = m0 + per < total ? m0 + per : total;
      for (long long m = m0; m < m1; ++m) {
        const int my = (int)(m / gw), mx = (int)(m % gw);
        for (int b = 0; b < nblk; ++b) {
          const int j = bj[b];
          const Comp& c = P.comp[s.comp[j]];
          const long long blk = alone ? (long long)my * c.bw + mx : (long long)(my * c.v + bby[b]) * c.bw + mx * c.h + bbx[b];
          int16_t* out = coef + c.off + 64 * blk;
          if (P.progressive) {
            progressive_block(s, br, dc_lut[j].data(), ac_lut[j].data(), pred[j], eobrun, out);
            continue;
          }
          uint16_t e = dc_lut[j][br.peek16()];
          br.skip(e >> 8);
          int t = e & 255;
          if (t) t = t > 16 ? 0 : extend(br.get(t), t);
          pred[j] += t;
          out[0] = (int16_t)pred[j];
          const uint16_t* lut = ac_lut[j].data();
          for (int k = 1; k < 64; ++k) {
            e = lut[br.peek16()];
            br.skip(e >> 8);
            const int r = (e >> 4) & 15, z = e & 15;
            if (z) {
              k += r;
              out[kNatural[k]] = (int16_t)extend(br.get(z), z);
            } else if (r != 15) {
              break;
            } else {
              k += 15;
            }
          }
        }
        if (br.overrun()) {  // this MCU took zero bits past the data: the rest of the interval stays zero
          if (P.progressive) return kErrBreaksOff;
          cut = true;
          break;
        }
      }
      // the reader stops at the marker (or short of it): the next interval searches from here
      p = br.p;
    }
  }
  return cut ? 1 : 0;
}

// The kernels' parameter from a record of fill_info and each component's table (3 x 64, or null)
Geom geom_from(const int* info, const int* qt) {
  Geom g;
  memset(&g, 0, sizeof g);
  g.width = info[0];
  g.height = info[1];
  g.ncomp = info[2];
  g.color = info[3];
  int blk = 0;
  for (int c = 0; c < g.ncomp; ++c) {
    const int* r = info + 16 + 8 * c;
    g.blk_off[c] = blk;
    blk += r[2] * r[3];
    g.bw[c] = r[2];
    g.cw[c] = r[4];
    g.ch[c] = r[5];
    g.fh[c] = info[5] / r[0];
    g.fv[c] = info[6] / r[1];
    g.mode[c] = kReplicate;
    if (g.fh[c] == 2 && g.fv[c] == 1 && r[4] > 2) g.mode[c] = kH2V1;
    if (g.fh[c] == 1 && g.fv[c] == 2) g.mode[c] = kH1V2;
    if (g.fh[c] == 2 && g.fv[c] == 2 && r[4] > 2) g.mode[c] = kH2V2;
    if (qt)
      for (int k = 0; k < 64; ++k) g.q[c][k] = (uint16_t)qt[c * 64 + k];
  }
  g.blk_off[g.ncomp] = blk;
  return g;
}

// ISLOW constants (jidctint.c): FIX(x) = round(x * 2^13)
constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633;
constexpr int F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// One ISLOW pass over x[0..7] (inputs at stride 1), each output descaled by shift with rounding
__device__ __forceinline__ void idct8(const int* x, int* o, int shift) {
  int z1 = (x[2] + x[6]) * F0541;
  const int tmp2 = z1 - x[6] * F1847;
  const int tmp3 = z1 + x[2] * F0765;
  const int tmp0 = (x[0] + x[4]) * 8192;
  const int tmp1 = (x[0] - x[4]) * 8192;
  const int t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  int o0 = x[7], o1 = x[5], o2 = x[3], o3 = x[1];
  z1 = o0 + o3;
  int z2 = o1 + o2, z3 = o0 + o2, z4 = o1 + o3;
  const int z5 = (z3 + z4) * F1175;
  o0 *= F0298;
  o1 *= F2053;
  o2 *= F3072;
  o3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;
  const int half = 1 << (shift - 1);
  o[0] = (t10 + o3 + half) >> shift;
  o[7] = (t10 - o3 + half) >> shift;
  o[1] = (t11 + o2 + half) >> shift;
  o[6] = (t11 - o2 + half) >> shift;
  o[2] = (t12 + o1 + half) >> shift;
  o[5] = (t12 - o1 + half) >> shift;
  o[3] = (t13 + o0 + half) >> shift;
  o[4] = (t13 - o0 + half) >> shift;
}

// coef: every component's int16 blocks end to end (g.blk_off); planes: the same layout as uint8 pixels,
// each component a (8 bh, 8 bw) row-major plane
__global__ void __launch_bounds__(kBlocksPerCta * 8) jpeg_idct_kernel(const int16_t* __restrict__ coef,
                                                                      uint8_t* __restrict__ planes, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_in = reinterpret_cast<int16_t*>(smem);                              // [32][64]
  int* s_ws = reinterpret_cast<int*>(smem + kBlocksPerCta * 64 * sizeof(int16_t));  // [32][64]
  const int t = threadIdx.x, lb = t >> 3, lane = t & 7;
  const int nblocks = g.blk_off[g.ncomp];
  const int first = blockIdx.x * kBlocksPerCta;
  // coalesced load: each thread 8 consecutive coefficients (16 bytes)
  {
    const long long idx = (long long)first * 64 + t * 8;
    if (first + (t >> 3) < nblocks) {
      *reinterpret_cast<uint4*>(s_in + t * 8) = *reinterpret_cast<const uint4*>(coef + idx);
    }
  }
  __syncthreads();
  const int gb = first + lb;
  const bool live = gb < nblocks;
  const int c = gb >= g.blk_off[2] && g.ncomp > 2 ? 2 : (gb >= g.blk_off[1] && g.ncomp > 1 ? 1 : 0);
  int x[8], o[8];
  if (live) {  // pass 1: this thread's column
    for (int r = 0; r < 8; ++r) x[r] = (int)s_in[lb * 64 + r * 8 + lane] * (int)g.q[c][r * 8 + lane];
    idct8(x, o, 11);
    for (int r = 0; r < 8; ++r) s_ws[lb * 64 + r * 8 + lane] = o[r];
  }
  __syncthreads();
  if (live) {  // pass 2: this thread's row
    for (int k = 0; k < 8; ++k) x[k] = s_ws[lb * 64 + lane * 8 + k];
    idct8(x, o, 18);
    const int li = gb - g.blk_off[c], by = li / g.bw[c], bx = li % g.bw[c];
    uint8_t px[8];
    for (int k = 0; k < 8; ++k) {
      const int v = o[k] + 128;
      px[k] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    uint8_t* dst = planes + (long long)g.blk_off[c] * 64 + (long long)(8 * by + lane) * (8 * g.bw[c]) + 8 * bx;
    uint2 w;
    memcpy(&w, px, 8);
    *reinterpret_cast<uint2*>(dst) = w;
  }
}

// The upsampled value of component c at output pixel (x, y)
__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes, const Geom& g, int c, int x, int y) {
  const uint8_t* p = planes + (long long)g.blk_off[c] * 64;
  const int stride = 8 * g.bw[c], cw = g.cw[c], ch = g.ch[c];
  switch (g.mode[c]) {
    case kH2V1: {
      const int cx = x >> 1, odd = x & 1;
      const int nb = odd ? min(cx + 1, cw - 1) : max(cx - 1, 0);
      return (3 * p[y * stride + cx] + p[y * stride + nb] + 1 + odd) >> 2;
    }
    case kH1V2: {
      const int cy = y >> 1, odd = y & 1;
      const int far = odd ? min(cy + 1, ch - 1) : max(cy - 1, 0);
      return (3 * p[cy * stride + x] + p[far * stride + x] + 1 + odd) >> 2;
    }
    case kH2V2: {
      const int cx = x >> 1, cy = y >> 1, ox = x & 1, oy = y & 1;
      const int far = oy ? min(cy + 1, ch - 1) : max(cy - 1, 0);
      const int nb = ox ? min(cx + 1, cw - 1) : max(cx - 1, 0);
      const int s0 = 3 * p[cy * stride + cx] + p[far * stride + cx];
      const int s1 = 3 * p[cy * stride + nb] + p[far * stride + nb];
      return (3 * s0 + s1 + 8 - ox) >> 4;
    }
    default:
      return p[(y / g.fv[c]) * stride + x / g.fh[c]];
  }
}

__device__ __forceinline__ uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// one thread a pixel: a CUDA block covers 32 columns x 8 rows
__global__ void __launch_bounds__(256) jpeg_color_kernel(const uint8_t* __restrict__ planes,
                                                         uint8_t* __restrict__ out, const Geom g) {
  const int x = blockIdx.x * 32 + (threadIdx.x & 31), y = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (x >= g.width || y >= g.height) return;
  uint8_t* o = out + ((long long)y * g.width + x) * 3;
  const int s0 = sample(planes, g, 0, x, y);
  if (g.color == kGray) {
    o[0] = o[1] = o[2] = (uint8_t)s0;
    return;
  }
  const int s1 = sample(planes, g, 1, x, y), s2 = sample(planes, g, 2, x, y);
  if (g.color == kRgb) {
    o[0] = (uint8_t)s2;
    o[1] = (uint8_t)s1;
    o[2] = (uint8_t)s0;
    return;
  }
  // jdcolor.c, SCALEBITS 16: FIX(1.40200) 91881, FIX(1.77200) 116130, FIX(0.71414) 46802, FIX(0.34414) 22554
  const int cb = s1 - 128, cr = s2 - 128;
  o[0] = clamp255(s0 + ((116130 * cb + 32768) >> 16));
  o[1] = clamp255(s0 + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  o[2] = clamp255(s0 + ((91881 * cr + 32768) >> 16));
}

cudaError_t launch_idct(const int16_t* coef, uint8_t* planes, const Geom& g, cudaStream_t st) {
  const dim3 grid((g.blk_off[g.ncomp] + kBlocksPerCta - 1) / kBlocksPerCta), block(kBlocksPerCta * 8);
  const int smem_bytes = kBlocksPerCta * 64 * (int)(sizeof(int16_t) + sizeof(int));
  jpeg_idct_kernel<<<grid, block, smem_bytes, st>>>(coef, planes, g);
  return cudaGetLastError();
}

cudaError_t launch_color(const uint8_t* planes, uint8_t* out, const Geom& g, cudaStream_t st) {
  const dim3 grid((g.width + 31) / 32, (g.height + 7) / 8), block(256);
  const int smem_bytes = 0;
  jpeg_color_kernel<<<grid, block, smem_bytes, st>>>(planes, out, g);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ encoder
// jpeg_fdct_kernel + fce_jpeg_entropy: cv2.imencode(".jpg", img) at cv2's defaults (quality 95 unless given,
// 4:2:0, Annex K tables, no restart), byte for byte. The plain version: data/jpeg_write.py.

// ITU T.81 Annex K.1 quantisation tables, natural order
const uint8_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,  14, 13, 16, 24, 40,  57,
     69, 56, 14, 17, 22,  29,  51,  87,  80, 62, 18, 22, 37,  56,  68,  109, 103, 77, 24, 35, 55, 64,
     81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95,  98,  112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
     99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jccolor.c's SCALEBITS 16 constants
constexpr int fix16(double v) { return static_cast<int>(v * 65536 + 0.5); }
constexpr int kYR = fix16(0.29900), kYG = fix16(0.58700), kYB = fix16(0.11400);
constexpr int kCbR = fix16(0.16874), kCbG = fix16(0.33126), kHalf = fix16(0.5);
constexpr int kCrG = fix16(0.41869), kCrB = fix16(0.08131);
constexpr int kCbCrOffset = (128 << 16) + (1 << 15) - 1;  // CBCR_OFFSET + ONE_HALF - 1

struct EncGeom {
  int width, height, ncomp;
  int wib, hib;  // luma blocks that hold image samples; the MCU's others are dummies
  int bw[3], bh[3], blk_off[4];
  uint8_t quant[2][64];  // natural order
  uint16_t recip[2][64], corr[2][64];
  uint8_t shift[2][64];
};

// jcparam.c jpeg_set_quality (force_baseline) and jcdctmgr.c compute_reciprocal of each divisor 8 q
EncGeom enc_geom(int width, int height, int ncomp, int quality) {
  EncGeom g{};
  g.width = width;
  g.height = height;
  g.ncomp = ncomp;
  g.wib = (width + 7) / 8;
  g.hib = (height + 7) / 8;
  if (ncomp == 1) {
    g.bw[0] = g.wib;
    g.bh[0] = g.hib;
  } else {
    const int mx = (width + 15) / 16, my = (height + 15) / 16;
    g.bw[0] = 2 * mx;
    g.bh[0] = 2 * my;
    g.bw[1] = g.bw[2] = mx;
    g.bh[1] = g.bh[2] = my;
  }
  g.blk_off[0] = 0;
  for (int c = 0; c < ncomp; ++c) g.blk_off[c + 1] = g.blk_off[c] + g.bw[c] * g.bh[c];
  const int q = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  const int scale = q < 50 ? 5000 / q : 200 - 2 * q;
  for (int t = 0; t < 2; ++t) {
    for (int k = 0; k < 64; ++k) {
      int v = (kStdQuant[t][k] * scale + 50) / 100;
      v = v < 1 ? 1 : (v > 255 ? 255 : v);
      g.quant[t][k] = static_cast<uint8_t>(v);
      const uint32_t d = static_cast<uint32_t>(v) << 3;
      int r = 16 + (31 - __builtin_clz(d));
      uint32_t fq = (1u << r) / d, c = d / 2;
      const uint32_t fr = (1u << r) % d;
      if (fr == 0) {  // a power of two: fq is one bit too large
        fq >>= 1;
        --r;
      } else if (fr <= d / 2) {
        ++c;
      } else {
        ++fq;
      }
      g.recip[t][k] = static_cast<uint16_t>(fq);
      g.corr[t][k] = static_cast<uint16_t>(c);
      g.shift[t][k] = static_cast<uint8_t>(r);
    }
  }
  return g;
}

// One jfdctint pass over x[0..7]. pass 1 (rows): even outputs << PASS1_BITS, odd descaled by 11; pass 2
// (columns): even descaled by PASS1_BITS, odd by 15.
__device__ __forceinline__ void fdct8(const int* d, int* o, bool second) {
  const int tmp0 = d[0] + d[7], tmp7 = d[0] - d[7], tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int tmp2 = d[2] + d[5], tmp5 = d[2] - d[5], tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int n = second ? 15 : 11, half = 1 << (n - 1);
  if (second) {
    o[0] = (tmp10 + tmp11 + 2) >> 2;
    o[4] = (tmp10 - tmp11 + 2) >> 2;
  } else {
    o[0] = (tmp10 + tmp11) * 4;
    o[4] = (tmp10 - tmp11) * 4;
  }
  int z1 = (tmp12 + tmp13) * F0541;
  o[2] = (z1 + tmp13 * F0765 + half) >> n;
  o[6] = (z1 - tmp12 * F1847 + half) >> n;
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * F1175;
  const int t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072, t7 = tmp7 * F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  o[7] = (t4 + z1 + z3 + half) >> n;
  o[5] = (t5 + z2 + z4 + half) >> n;
  o[3] = (t6 + z2 + z3 + half) >> n;
  o[1] = (t7 + z1 + z4 + half) >> n;
}

__device__ __forceinline__ int luma(const uint8_t* p) { return (kYR * p[2] + kYG * p[1] + kYB * p[0] + 32768) >> 16; }

// Cb (c == 1) or Cr of the BGR pixel p
__device__ __forceinline__ int chroma(const uint8_t* p, int c) {
  return c == 1 ? (-kCbR * p[2] - kCbG * p[1] + kHalf * p[0] + kCbCrOffset) >> 16
                : (kHalf * p[2] - kCrG * p[1] - kCrB * p[0] + kCbCrOffset) >> 16;
}

// img: BGR (H, W, 3) or gray (H, W) uint8, on the card; coef: every component's int16 blocks end to end
// (g.blk_off), natural order. 32 JPEG blocks a CUDA block, 8 threads each: one thread a row of samples
// (edge-replicated, colour-converted, 2x2-averaged for chroma), then after the rows' pass sits in shared
// memory, a column; quantised values go through shared memory to coalesced 16-byte stores.
__global__ void __launch_bounds__(kBlocksPerCta * 8) jpeg_fdct_kernel(const uint8_t* __restrict__ img,
                                                                      int16_t* __restrict__ coef, const EncGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ws = reinterpret_cast<int*>(smem);                                            // [32][64]
  int16_t* s_out = reinterpret_cast<int16_t*>(smem + kBlocksPerCta * 64 * sizeof(int));  // [32][64]
  const int t = threadIdx.x, lb = t >> 3, lane = t & 7;
  const int nblocks = g.blk_off[g.ncomp];
  const int first = blockIdx.x * kBlocksPerCta;
  const int gb = first + lb;
  const bool live = gb < nblocks;
  const int c = g.ncomp > 2 && gb >= g.blk_off[2] ? 2 : (g.ncomp > 1 && gb >= g.blk_off[1] ? 1 : 0);
  const int li = gb - g.blk_off[c];
  int by = li / g.bw[c], bx = li % g.bw[c];
  // a dummy luma block (jccoefct compress_data) takes the DC of its source block and no AC
  bool dummy = false;
  if (c == 0 && g.ncomp == 3) {
    if (by >= g.hib) {
      dummy = true;
      by = g.hib - 1;
      bx = (bx | 1) < g.wib ? (bx | 1) : (bx & ~1);
    } else if (bx >= g.wib) {
      dummy = true;
      bx -= 1;
    }
  }
  int x[8], o[8];
  if (live) {  // pass 1: this thread's row of samples
    const int W = g.width, H = g.height;
    if (c == 0) {
      const int py = min(8 * by + lane, H - 1);
      for (int k = 0; k < 8; ++k) {
        const int px = min(8 * bx + k, W - 1);
        const long long i = (long long)py * W + px;
        x[k] = (g.ncomp == 1 ? img[i] : luma(img + 3 * i)) - 128;
      }
    } else {  // h2v2_downsample of the edge-expanded full-resolution plane, bias 1, 2, 1, 2, ...
      const int cy = min(8 * by + lane, (H + 1) / 2 - 1);
      const int r0 = 2 * cy, r1 = min(2 * cy + 1, H - 1);
      for (int k = 0; k < 8; ++k) {
        const int cx = 8 * bx + k;
        const int c0 = min(2 * cx, W - 1), c1 = min(2 * cx + 1, W - 1);
        const int s = chroma(img + 3 * ((long long)r0 * W + c0), c) + chroma(img + 3 * ((long long)r0 * W + c1), c) +
                      chroma(img + 3 * ((long long)r1 * W + c0), c) + chroma(img + 3 * ((long long)r1 * W + c1), c);
        x[k] = ((s + 1 + (k & 1)) >> 2) - 128;
      }
    }
    fdct8(x, o, false);
    for (int u = 0; u < 8; ++u) s_ws[lb * 64 + lane * 8 + u] = o[u];
  }
  __syncthreads();
  if (live) {  // pass 2: this thread's column, then quantisation (jcdctmgr quantize)
    for (int r = 0; r < 8; ++r) x[r] = s_ws[lb * 64 + r * 8 + lane];
    fdct8(x, o, true);
    const int tb = c > 0;
    for (int v = 0; v < 8; ++v) {
      const int k = v * 8 + lane;
      const unsigned a = (unsigned)abs(o[v]);
      const int q = (int)(((a + g.corr[tb][k]) * (unsigned)g.recip[tb][k]) >> g.shift[tb][k]);
      s_out[lb * 64 + k] = (int16_t)(dummy && k ? 0 : (o[v] < 0 ? -q : q));
    }
  }
  __syncthreads();
  if (first + (t >> 3) < nblocks) {  // each thread 8 consecutive coefficients (16 bytes)
    *reinterpret_cast<uint4*>(coef + (long long)first * 64 + t * 8) = *reinterpret_cast<const uint4*>(s_out + t * 8);
  }
}

cudaError_t launch_fdct(const uint8_t* img, int16_t* coef, const EncGeom& g, cudaStream_t st) {
  const dim3 grid((g.blk_off[g.ncomp] + kBlocksPerCta - 1) / kBlocksPerCta), block(kBlocksPerCta * 8);
  const int smem_bytes = kBlocksPerCta * 64 * (int)(sizeof(int) + sizeof(int16_t));
  jpeg_fdct_kernel<<<grid, block, smem_bytes, st>>>(img, coef, g);
  return cudaGetLastError();
}

// ITU T.81 Annex C: each symbol's code and length
struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

// Annex K.3's table of slot (tc, th), th 0 or 1
Huff std_table(int tc, int th) {
  const Huff none[2][4] = {};
  return table_in_slot(none, tc, th);
}

HuffCodes huff_codes(int tc, int th) {
  const Huff h = std_table(tc, th);
  HuffCodes out{};
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < h.counts[len - 1]; ++i, ++k) {
      out.code[h.symbols[k]] = static_cast<uint16_t>(code++);
      out.size[h.symbols[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  return out;
}

// MSB-first bits with a zero stuffed after every 0xFF byte (jchuff.c)
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t bits, int len) {
    acc = (acc << len) | bits;
    n += len;
    while (n >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  void flush() {  // pad the last byte with ones
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

inline int nbits(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void put_segment(std::vector<uint8_t>& out, int marker, const std::vector<uint8_t>& body) {
  const int len = static_cast<int>(body.size()) + 2;
  out.insert(out.end(), {0xFF, static_cast<uint8_t>(marker), static_cast<uint8_t>(len >> 8),
                         static_cast<uint8_t>(len & 0xFF)});
  out.insert(out.end(), body.begin(), body.end());
}

// The whole file: SOI, APP0 JFIF 1.01, DQT a table, SOF0, DHT a table, SOS, the Huffman-coded blocks in scan
// order (4:2:0: an MCU is Y00 Y01 Y10 Y11 Cb Cr), EOI.
void encode_file(const int16_t* coef, const EncGeom& g, std::vector<uint8_t>& out) {
  const int ntab = g.ncomp == 1 ? 1 : 2;
  out.clear();
  out.insert(out.end(), {0xFF, 0xD8});
  put_segment(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < ntab; ++t) {
    std::vector<uint8_t> body{static_cast<uint8_t>(t)};
    for (int k = 0; k < 64; ++k) body.push_back(g.quant[t][kNatural[k]]);
    put_segment(out, 0xDB, body);
  }
  std::vector<uint8_t> sof{8, static_cast<uint8_t>(g.height >> 8), static_cast<uint8_t>(g.height & 0xFF),
                           static_cast<uint8_t>(g.width >> 8), static_cast<uint8_t>(g.width & 0xFF),
                           static_cast<uint8_t>(g.ncomp)};
  for (int c = 0; c < g.ncomp; ++c) {
    sof.insert(sof.end(), {static_cast<uint8_t>(c + 1), static_cast<uint8_t>(g.ncomp == 3 && c == 0 ? 0x22 : 0x11),
                           static_cast<uint8_t>(c > 0)});
  }
  put_segment(out, 0xC0, sof);
  HuffCodes dc[2], ac[2];
  for (int t = 0; t < ntab; ++t) {
    dc[t] = huff_codes(0, t);
    ac[t] = huff_codes(1, t);
    for (int tc = 0; tc < 2; ++tc) {
      const Huff h = std_table(tc, t);
      std::vector<uint8_t> body{static_cast<uint8_t>(tc << 4 | t)};
      body.insert(body.end(), h.counts, h.counts + 16);
      int n = 0;
      for (int i = 0; i < 16; ++i) n += h.counts[i];
      body.insert(body.end(), h.symbols, h.symbols + n);
      put_segment(out, 0xC4, body);
    }
  }
  std::vector<uint8_t> sos{static_cast<uint8_t>(g.ncomp)};
  for (int c = 0; c < g.ncomp; ++c) sos.insert(sos.end(), {static_cast<uint8_t>(c + 1), static_cast<uint8_t>(c ? 0x11 : 0)});
  sos.insert(sos.end(), {0, 63, 0});
  put_segment(out, 0xDA, sos);
  BitWriter bw{out};
  int pred[3] = {0, 0, 0};
  auto block = [&](int c, int by, int bx) {
    const int16_t* b = coef + ((long long)g.blk_off[c] + (long long)by * g.bw[c] + bx) * 64;
    const int t = c > 0;
    const int diff = b[0] - pred[c];
    pred[c] = b[0];
    int n = nbits(diff);
    bw.put(dc[t].code[n], dc[t].size[n]);
    if (n) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff) & ((1u << n) - 1), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = b[kNatural[k]];
      if (!v) {
        ++run;
        continue;
      }
      for (; run > 15; run -= 16) bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
      n = nbits(v);
      const int sym = run << 4 | n;
      bw.put(ac[t].code[sym], ac[t].size[sym]);
      bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << n) - 1), n);
      run = 0;
    }
    if (run) bw.put(ac[t].code[0], ac[t].size[0]);
  };
  if (g.ncomp == 1) {
    for (int by = 0; by < g.bh[0]; ++by)
      for (int bx = 0; bx < g.bw[0]; ++bx) block(0, by, bx);
  } else {
    for (int my = 0; my < g.bh[1]; ++my) {
      for (int mx = 0; mx < g.bw[1]; ++mx) {
        for (int i = 0; i < 4; ++i) block(0, 2 * my + (i >> 1), 2 * mx + (i & 1));
        block(1, my, mx);
        block(2, my, mx);
      }
    }
  }
  bw.flush();
  out.insert(out.end(), {0xFF, 0xD9});
}

}  // namespace

// info (int32[48]) gets W, H, components, colour, orientation, hmax, vmax, total coefficients, then per
// component c at 16 + 8c: h, v, bw, bh, width, height, coefficient offset, table; info[8] is set to 1 when
// a marker cut the data short. Each entry point returns 0, a negative code (data/jpeg.py _ERRORS) or a
// CUDA error; kGrow when the caller's buffers are too small for the record it filled in.

// The host entropy decode alone: coef (cap int16) gets info[7] coefficients, qt (3 x 64 int32) each
// component's table, natural order.
extern "C" int fce_jpeg_coefficients(const void* buf, long long len, void* coef, long long cap, void* qt, int* info) {
  Parsed P;
  const int err = parse(static_cast<const uint8_t*>(buf), len, P);
  if (err) return err;
  fill_info(P, info);
  if (P.total > cap) return kGrow;
  const int cut = decode_coefficients(P, static_cast<int16_t*>(coef));
  if (cut < 0) return cut;
  info[8] = cut;
  component_tables(P, static_cast<int*>(qt));
  return 0;
}

// jpeg_idct_kernel alone, on the caller's stream: coef (device, info[7] int16) -> planes (device, info[7]
// uint8); qt: host 3 x 64 int32 (as fce_jpeg_coefficients gives them).
extern "C" int fce_jpeg_idct(const void* coef, const void* qt, void* planes, const int* info, void* stream) {
  if (info[2] != 1 && info[2] != 3) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom_from(info, static_cast<const int*>(qt));
  return static_cast<int>(launch_idct(static_cast<const int16_t*>(coef), static_cast<uint8_t*>(planes), g,
                                      static_cast<cudaStream_t>(stream)));
}

// jpeg_color_kernel alone, on the caller's stream: planes (device) -> out (device, H x W x 3 uint8)
extern "C" int fce_jpeg_color(const void* planes, void* out, const int* info, void* stream) {
  if (info[2] != 1 && info[2] != 3) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom_from(info, nullptr);
  return static_cast<int>(launch_color(static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), g,
                                       static_cast<cudaStream_t>(stream)));
}

// A whole image: parse, entropy decode into h_coef (pinned), copy to d_coef, both kernels, copy d_out to h_out
// (pinned), synchronise the stream. h_coef and d_coef hold coef_cap int16, d_plane coef_cap bytes, d_out and
// h_out out_cap bytes; when info[7] > coef_cap or W H 3 > out_cap it returns kGrow before touching any of
// them. times (float[5] or null): ms of the host entropy decode, H2D, IDCT, colour, D2H.
extern "C" int fce_jpeg_decode(const void* buf, long long len, int* info, void* h_coef, void* d_coef, void* d_plane,
                               long long coef_cap, void* d_out, void* h_out, long long out_cap, float* times,
                               void* stream) {
  Parsed P;
  int err = parse(static_cast<const uint8_t*>(buf), len, P);
  if (err) return err;
  fill_info(P, info);
  if (P.total > coef_cap || 3LL * P.width * P.height > out_cap) return kGrow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto t0 = std::chrono::steady_clock::now();
  const int cut = decode_coefficients(P, static_cast<int16_t*>(h_coef));
  if (cut < 0) return cut;
  info[8] = cut;
  const auto t1 = std::chrono::steady_clock::now();
  int qt[3 * 64];
  component_tables(P, qt);
  const Geom g = geom_from(info, qt);
  cudaEvent_t ev[5];
  if (times) {
    times[0] = std::chrono::duration<float, std::milli>(t1 - t0).count();
    for (int i = 0; i < 5; ++i) {
      if (cudaEventCreate(&ev[i]) != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
    cudaEventRecord(ev[0], st);
  }
  const size_t coef_bytes = (size_t)P.total * sizeof(int16_t), out_bytes = (size_t)P.width * P.height * 3;
  cudaError_t e = cudaMemcpyAsync(d_coef, h_coef, coef_bytes, cudaMemcpyHostToDevice, st);
  if (times) cudaEventRecord(ev[1], st);
  if (e == cudaSuccess) e = launch_idct(static_cast<const int16_t*>(d_coef), static_cast<uint8_t*>(d_plane), g, st);
  if (times) cudaEventRecord(ev[2], st);
  if (e == cudaSuccess) e = launch_color(static_cast<const uint8_t*>(d_plane), static_cast<uint8_t*>(d_out), g, st);
  if (times) cudaEventRecord(ev[3], st);
  if (e == cudaSuccess) e = cudaMemcpyAsync(h_out, d_out, out_bytes, cudaMemcpyDeviceToHost, st);
  if (times) cudaEventRecord(ev[4], st);
  const cudaError_t sync = cudaStreamSynchronize(st);
  if (e == cudaSuccess) e = sync;
  if (times) {
    for (int i = 0; i < 4; ++i) cudaEventElapsedTime(&times[1 + i], ev[i], ev[i + 1]);
    for (int i = 0; i < 5; ++i) cudaEventDestroy(ev[i]);
  }
  return static_cast<int>(e);
}

// jpeg_fdct_kernel alone, on the caller's stream: img (device, H x W x ncomp uint8, ncomp 1 or 3) -> coef
// (device int16, every component's MCU-padded block grid end to end, natural order)
extern "C" int fce_jpeg_fdct(const void* img, void* coef, int height, int width, int ncomp, int quality,
                             void* stream) {
  if ((ncomp != 1 && ncomp != 3) || height < 1 || width < 1 || height > 65535 || width > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncGeom g = enc_geom(width, height, ncomp, quality);
  return static_cast<int>(launch_fdct(static_cast<const uint8_t*>(img), static_cast<int16_t*>(coef), g,
                                      static_cast<cudaStream_t>(stream)));
}

// The host half of the writer: coef (host, fce_jpeg_fdct's layout) -> the JPEG file in out (cap bytes);
// *size gets its length. kGrow (nothing written) when cap is too small.
extern "C" int fce_jpeg_entropy(const void* coef, int height, int width, int ncomp, int quality, void* out,
                                long long cap, long long* size) {
  if ((ncomp != 1 && ncomp != 3) || height < 1 || width < 1 || height > 65535 || width > 65535) return kErrFormat;
  const EncGeom g = enc_geom(width, height, ncomp, quality);
  std::vector<uint8_t> file;
  encode_file(static_cast<const int16_t*>(coef), g, file);
  *size = static_cast<long long>(file.size());
  if (*size > cap) return kGrow;
  memcpy(out, file.data(), file.size());
  return 0;
}
