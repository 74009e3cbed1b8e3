// The outer outlines of a binary mask, host C++ (no device code): what
// cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) returns, which
// the JAX package calls for mask outlines (fce_yolo_tpu/engine/results.py:76-84,
// fce_yolo_tpu/ops/geometry.py:177-200). The plain version, step for step the
// same, is fce_yolo_tpu_torch/ops/contours.py (Python); this one is its fast
// twin for the card's machine, built into the kernel libraries by nvcc as
// every csrc/*.cu is (plain C interface, ctypes; reentrant, no globals).
//
// Suzuki and Abe's border following as OpenCV writes it: the mask's box of
// nonzero pixels is copied into an int8 plane with a frame of zeros; rows are
// scanned left to right, a 0 -> 1 step starting an outer border unless the
// last labelled run of the row is positive; a trace searches clockwise from
// the left for its first neighbour, then walks counter-clockwise, labelling
// each border pixel -126 (the search passed its zero right neighbour) or 2,
// and keeps a point where the direction changes. The list comes out last
// found first, as cv2's.
//
// What bounds it: one pass over the mask for its box, then the scan reads
// each pixel of the box once and the walk each border pixel a few times.
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

constexpr int kGrow = -13;  // the caller's buffers are too small (n_out holds the sizes)
constexpr int8_t kRightBound = -126, kBorder = 2;
constexpr int kCodeDx[8] = {1, 1, 0, -1, -1, -1, 0, 1}, kCodeDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// Follow the outer border starting at flat index i0 (mask pixel (x, y)), appending its points to pts.
void trace(std::vector<int8_t>& img, long long step, long long i0, int x, int y, std::vector<int32_t>& pts) {
  const long long d8[8] = {1, 1 - step, -step, -step - 1, -1, step - 1, step, step + 1};
  int s = 4, s_end = 4;
  long long i1 = i0;
  while (true) {
    s = (s - 1) & 7;
    i1 = i0 + d8[s];
    if (img[i1] != 0 || s == s_end) break;
  }
  if (s == s_end) {  // a lone pixel
    img[i0] = kRightBound;
    pts.push_back(x);
    pts.push_back(y);
    return;
  }
  long long i3 = i0, i4 = i0;
  int prev_s = s ^ 4;
  while (true) {
    s_end = s;
    while (s < 15) {
      ++s;
      i4 = i3 + d8[s & 7];
      if (img[i4] != 0) break;
    }
    s &= 7;
    if (s >= 1 && s <= s_end) {  // the search passed the zero right neighbour
      img[i3] = kRightBound;
    } else if (img[i3] == 1) {
      img[i3] = kBorder;
    }
    if (s != prev_s) {
      pts.push_back(x);
      pts.push_back(y);
      prev_s = s;
    }
    x += kCodeDx[s];
    y += kCodeDy[s];
    if (i4 == i0 && i3 == i1) return;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

}  // namespace

// mask: uint8 (h, w), rows `stride` bytes apart, nonzero = inside. pts (int32 x, y pairs, room for pts_cap
// points) gets every outline's points end to end, counts (room for counts_cap) each outline's point count, in
// cv2's order; n_out[0] = outlines, n_out[1] = points. Returns 0, or kGrow (nothing written) when either room is
// too small, with n_out filled.
extern "C" int fce_find_contours(const void* mask, int h, int w, long long stride, int* pts, long long pts_cap,
                                 int* counts, long long counts_cap, long long* n_out) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int r0 = h, r1 = -1, c0 = w, c1 = -1;
  for (int y = 0; y < h; ++y) {  // the box of nonzero pixels: an OR over each row, then its ends
    const uint8_t* row = m + (long long)y * stride;
    uint8_t any = 0;
    for (int x = 0; x < w; ++x) any |= row[x];
    if (!any) continue;
    int first = 0, last = w - 1;
    while (!row[first]) ++first;
    while (!row[last]) --last;
    r0 = r0 < y ? r0 : y;
    r1 = y;
    c0 = c0 < first ? c0 : first;
    c1 = c1 > last ? c1 : last;
  }
  std::vector<std::vector<int32_t>> found;
  if (r1 >= 0) {
    const int ph = r1 - r0 + 3, pw = c1 - c0 + 3;  // the box and a frame of zeros
    const long long step = pw;
    std::vector<int8_t> img((size_t)ph * pw, 0);
    std::vector<char> busy(ph, 0);
    for (int y = r0; y <= r1; ++y) {
      const uint8_t* row = m + (long long)y * stride;
      int8_t* dst = img.data() + (long long)(y - r0 + 1) * step + 1;
      for (int x = c0; x <= c1; ++x) {
        dst[x - c0] = row[x] != 0;
        busy[y - r0 + 1] |= row[x] != 0;
      }
    }
    for (int y = 1; y < ph - 1; ++y) {
      if (!busy[y]) continue;
      const long long base = (long long)y * step;
      int8_t prev = 0;
      long long lnbd = base;  // the last labelled run of this row: its value decides
      for (int x = 1; x < pw - 1; ++x) {
        const int8_t p = img[base + x];
        if (p == prev) continue;
        if (prev == 0 && p == 1) {  // an outer border starts here, unless inside a traced object
          if (img[lnbd] <= 0) {
            found.emplace_back();
            trace(img, step, base + x, x - 1 + c0, y - 1 + r0, found.back());
            prev = img[base + x];
            continue;
          }
        } else if (p == 0 && prev > 1) {  // a hole starts after a labelled pixel
          lnbd = base + x - 1;
        }
        prev = p;
        if (p != 0 && p != 1) lnbd = base + x;
      }
    }
  }
  long long n_pts = 0;
  for (const auto& c : found) n_pts += (long long)c.size() / 2;
  n_out[0] = (long long)found.size();
  n_out[1] = n_pts;
  if ((long long)found.size() > counts_cap || n_pts > pts_cap) return kGrow;
  long long k = 0, j = 0;
  for (auto it = found.rbegin(); it != found.rend(); ++it) {  // cv2 lists the outlines last found first
    counts[j++] = (int)(it->size() / 2);
    memcpy(pts + 2 * k, it->data(), it->size() * sizeof(int32_t));
    k += (long long)it->size() / 2;
  }
  return 0;
}
