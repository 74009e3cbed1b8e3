// Batched greedy NMS for Hopper (sm_90a): sort, IoU bitmask, one-warp scan.
//
// Replaces the TPU kernel fce_yolo_tpu/ops/pallas_nms.py::_nms_kernel
// (launched by pallas_pick_suppress). Per image: pick the argmax of the live
// scores (lowest index on ties, the jnp.argmax rule), stop once the row is
// empty or max_det picks are made, and kill every candidate whose IoU with
// the pick exceeds thres, and the pick. Returns idx (B, max_det) int32 and
// ok (B, max_det) bool; after the row is exhausted idx = 0 and ok = false.
//
// Three launches on the caller's stream; no block waits for another:
// 1. nms_sort_kernel, one block per image. A 64-bit key per candidate: the
//    live score's bits turned so that unsigned order is descending score,
//    then the index. A bitonic sort in shared memory (next power of two of
//    K keys) gives the ordered positions, skipped when the keys come in
//    order (the top-K of the main path gives them so); the block writes the
//    boxes in that order, each position's original index, and n_v, the live
//    count. An invalid candidate or a score of -inf sorts last, not live.
// 2. nms_mask_kernel, a grid of (32-column word, 128-row tile, image) over
//    the ordered positions. Bit q of row p says IoU(p, q) > thres, for p != q
//    below n_v. Tiles wholly below the diagonal or past n_v exit at once, so
//    the work is about n_v^2 / 2 pairs, spread over every SM. Each pair's
//    test is branch-free but for the division, which only pairs within
//    2^-20 of the threshold take (iou_above).
// 3. nms_scan_kernel, one warp per image. The removed-bitset lives in the
//    lanes' registers (lane l holds words l, l + 32, ...; 1, 4 or 10 words
//    a lane, fixed at compile time for K up to 1024, 4096 or 10240). The warp walks the
//    ordered positions 32 at a time: the chunk's free candidates are those
//    whose removed bit is clear; the greedy order inside the chunk is
//    resolved with ballots over the chunk's own 32 x 32 block of the mask
//    (a candidate stays when no earlier kept one of the chunk overlaps it;
//    iterated to its fixed point, at most 33 rounds and usually 2 or 3); the
//    kept rows are ORed into the bitset. The mask rows of the next chunks
//    are copied into shared memory with cp.async while the warp decides the
//    current one.
//
// What bounds it on the H100: not the bytes (21 in per candidate, the mask
// stays in L2) but the dependent chain: three launches, then the scan's
// ceil(n_v / 32) chunk steps per image, each some 300 instructions of one
// warp with nothing to hide their latency (~0.5 us a step). The mask's pair
// tests (n_v^2 / 2 pairs of ~25 instructions, on every SM) take as long at
// B = 16, K = 1024 and dominate at B = 64 or K = 4096. Times: PERF.md. The
// argmax loop it replaces was max_det dependent block-wide steps, each a
// reduction with three barriers and an IoU pass over all K.
//
// Why the keep-set is bit-equal to the argmax loop (pick_suppress_reference):
// - Order. The argmax of the live scores with the lowest index on ties is
//   always the first live candidate in (score descending, index ascending)
//   order, so a walk over that order that skips killed candidates picks the
//   same boxes in the same order.
// - -0.0. argmax treats -0.0 and +0.0 as equal (the lower index wins) but
//   their bits sort apart, so -0.0 becomes +0.0 before the key is built.
// - The IoU. Computed with explicitly rounded operations in the JAX order,
//   inter / (((a_i + a_j) - inter) + 1e-7), so nvcc contracts nothing into
//   an FMA. fminf, fmaxf and the rounded add and multiply are commutative,
//   so IoU(p, q) and IoU(q, p) have the same bits and the scan may read the
//   pick-q test from row p. A zero intersection skips the division only for
//   thres >= 0, where 0 / den > thres is false whatever den is.
// NaN scores or boxes are outside the contract, as they were for the argmax
// loop.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kDead = 0xff800000u;  // the key of -inf: this and above are not live
constexpr int kMaskRows = 128;           // mask: rows per block, one a thread, each one word
constexpr int kMaxSlots = 10;            // removed-bitset words per lane, at most
constexpr int kMaxK = 32 * 32 * kMaxSlots;  // the bitset's reach: 10240 candidates
constexpr int kAhead = 4;                // scan: chunks of mask rows in flight
constexpr int kMaskSmem = 32 * (16 + 4);

// words per mask row: ceil(K / 32) rounded up to whole 16-byte groups
__host__ __device__ inline int mask_words(int K) { return 4 * ((K + 127) / 128); }
// bytes of the scan's shared memory: kAhead + 1 chunk buffers of 32 mask rows and 32 indices
__host__ __device__ inline int scan_smem(int K) { return (kAhead + 1) * 32 * (mask_words(K) + 1) * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ float box_area(float4 v) {
  return __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.0f), fmaxf(__fsub_rn(v.w, v.y), 0.0f));
}

// IoU(a, c) > thres, with a's area aa and c's area ca, rounded as the plain
// version: RN(inter / den) > thres. For thres >= 1e-6 the division is taken
// only within 2^-20 of the threshold: t = RN(thres * den) is within 2^-24 of
// thres * den and the margins within 2^-24 of their own, so inter above
// t (1 + 2^-20) puts inter / den above thres (1 + 2^-21) and its rounding
// above thres, and inter below t (1 - 2^-20) puts it below thres (1 - 2^-21)
// and its rounding below; den >= 1e-7 is never subnormal. Below 1e-6 a zero
// intersection skips the division only for thres >= 0, where 0 / den > thres
// is false whatever den is.
__device__ __forceinline__ bool iou_above(float4 a, float aa, float4 c, float ca, float thres) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(aa, ca), inter), 1e-7f);
  if (thres >= 1e-6f) {
    const float t = __fmul_rn(thres, den);
    if (inter > __fmul_rn(t, 1.0f + 0x1p-20f)) return true;
    if (inter < __fmul_rn(t, 1.0f - 0x1p-20f)) return false;
  } else if (inter == 0.0f && thres >= 0.0f) {
    return false;
  }
  return __fdiv_rn(inter, den) > thres;
}

__global__ void __launch_bounds__(1024) nms_sort_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores, const uint8_t* __restrict__ valid,
    float4* __restrict__ sboxes, int32_t* __restrict__ order, int32_t* __restrict__ count, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);
  int* unsorted = reinterpret_cast<int*>(key + N);
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const size_t base = static_cast<size_t>(b) * K;
  if (tid == 0) *unsorted = 0;
  for (int i = tid; i < N; i += T) {
    uint64_t k = ~0ull;  // padding sorts last
    if (i < K) {
      float s = valid[base + i] ? scores[base + i] : -INFINITY;
      if (s == 0.0f) s = 0.0f;  // -0.0 ties +0.0, as in argmax
      const uint32_t u = __float_as_uint(s);
      const uint32_t hi = (u & 0x80000000u) ? u : (u ^ 0x7fffffffu);  // descending score
      k = (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(i);
    }
    key[i] = k;
  }
  __syncthreads();
  // the main path's candidates come sorted from the top-K: then the sort is skipped
  for (int i = tid; i + 1 < K; i += T) {
    if (key[i] > key[i + 1]) *unsorted = 1;
  }
  __syncthreads();
  for (int size = 2; size <= N && *unsorted; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < N / 2; i += T) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const uint64_t x = key[lo], y = key[hi];
        if ((x > y) == ((lo & size) == 0)) { key[lo] = y; key[hi] = x; }
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < K; p += T) {
    const uint64_t k = key[p];
    const int i = static_cast<int>(static_cast<uint32_t>(k));
    const float* bx = boxes + (base + i) * 4;
    sboxes[base + p] = make_float4(bx[0], bx[1], bx[2], bx[3]);
    order[base + p] = i;
    const bool live = static_cast<uint32_t>(k >> 32) < kDead;
    const bool next_live = p + 1 < K && static_cast<uint32_t>(key[p + 1] >> 32) < kDead;
    if (live && !next_live) count[b] = p + 1;
    if (p == 0 && !live) count[b] = 0;
  }
}

// Word w (columns 32w .. 32w + 31) of rows row0 .. row0 + kMaskRows - 1:
// one word a thread, from the 32 column boxes in shared memory. A row's
// words below its own chunk are never read by the scan and not written.
__global__ void __launch_bounds__(kMaskRows) nms_mask_kernel(
    const float4* __restrict__ sboxes, const int32_t* __restrict__ count, uint32_t* __restrict__ mask,
    int K, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cbox = reinterpret_cast<float4*>(smem);
  float* carea = reinterpret_cast<float*>(smem + 32 * sizeof(float4));
  const int b = blockIdx.z, row0 = blockIdx.y * kMaskRows, w = blockIdx.x, col0 = 32 * w;
  const int n = count[b];
  if (row0 >= n || col0 >= n || col0 + 32 <= row0) return;  // past n_v or below the diagonal
  const size_t base = static_cast<size_t>(b) * K;
  const int ncol = min(32, n - col0), tid = threadIdx.x;
  if (tid < ncol) {
    const float4 v = sboxes[base + col0 + tid];
    cbox[tid] = v;
    carea[tid] = box_area(v);
  }
  __syncthreads();
  const int p = row0 + tid;
  if (p >= n || col0 + 32 <= p) return;
  const float4 r = sboxes[base + p];
  const float ra = box_area(r);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < ncol && col0 + j != p && iou_above(r, ra, cbox[j], carea[j], thres)) bits |= 1u << j;
  }
  mask[(base + p) * mask_words(K) + w] = bits;
}

// Start copying chunk c's mask rows (positions 32c .. 32c + 31 below n, from
// c's own 16-byte word group to the last live one) and original indices
// into buffer c % (kAhead + 1).
__device__ __forceinline__ void fetch_chunk(const uint4* mask_b, const int32_t* order_b, unsigned char* smem,
                                            int c, int n, int Wq, int q_end, int lane) {
  const int slot = c % (kAhead + 1), q0 = c >> 2, nq = q_end - q0, rows = min(32, n - 32 * c);
  uint4* rows_sm = reinterpret_cast<uint4*>(smem) + slot * 32 * Wq + q0;
  const uint4* src = mask_b + static_cast<size_t>(32 * c) * Wq + q0;
  // lane takes the (row, group) pairs lane, lane + 32, ... of rows x nq, stepped without dividing
  const int dr = 32 / nq, dq = 32 % nq;
  int r = lane / nq, q = lane - r * nq;
  while (r < rows) {
    cp_async16(smem_u32(rows_sm + r * Wq + q), src + static_cast<size_t>(r) * Wq + q);
    r += dr;
    q += dq;
    if (q >= nq) { q -= nq; ++r; }
  }
  int32_t* order_sm = reinterpret_cast<int32_t*>(reinterpret_cast<uint4*>(smem) + (kAhead + 1) * 32 * Wq);
  if (lane < rows) cp_async4(smem_u32(order_sm + slot * 32 + lane), order_b + 32 * c + lane);
}

// Slots: the bitset's words per lane (32 * 32 * Slots >= K), a compile-time
// count so that the bitset stays in registers.
template <int Slots>
__global__ void __launch_bounds__(32) nms_scan_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ count, const uint32_t* __restrict__ mask,
    int32_t* __restrict__ idx, uint8_t* __restrict__ ok, int K, int max_det) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, lane = threadIdx.x, W = mask_words(K), Wq = W / 4;
  const int n = count[b], nw = (n + 31) / 32, q_end = (nw + 3) / 4;
  const size_t base = static_cast<size_t>(b) * K;
  const uint4* mask_b = reinterpret_cast<const uint4*>(mask + base * W);
  const uint32_t* rows_sm = reinterpret_cast<const uint32_t*>(smem);
  const int32_t* order_sm = reinterpret_cast<const int32_t*>(smem) + (kAhead + 1) * 32 * W;
  int32_t* idx_b = idx + static_cast<size_t>(b) * max_det;
  uint8_t* ok_b = ok + static_cast<size_t>(b) * max_det;
  const uint32_t before = (1u << lane) - 1u;  // the lanes below this one

  uint32_t removed[Slots];
#pragma unroll
  for (int s = 0; s < Slots; ++s) removed[s] = 0;
  for (int c = 0; c < kAhead; ++c) {
    if (c < nw) fetch_chunk(mask_b, order + base, smem, c, n, Wq, q_end, lane);
    asm volatile("cp.async.commit_group;\n");
  }
  int emitted = 0;
  for (int c = 0; c < nw && emitted < max_det; ++c) {
    if (c + kAhead < nw) fetch_chunk(mask_b, order + base, smem, c + kAhead, n, Wq, q_end, lane);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead));  // chunk c has landed
    __syncwarp();
    const int slot = c % (kAhead + 1), p = 32 * c + lane;
    const uint32_t* tile = rows_sm + slot * 32 * W;
    uint32_t rc = 0;  // word c of the bitset, from lane c % 32
#pragma unroll
    for (int s = 0; s < Slots; ++s) {
      if (s == c >> 5) rc = removed[s];
    }
    rc = __shfl_sync(kFull, rc, c & 31);
    const bool free_p = p < n && !((rc >> lane) & 1u);
    const uint32_t avail = __ballot_sync(kFull, free_p);
    // earlier positions of this chunk that overlap p (bit q of row p = bit p of row q)
    const uint32_t over = p < n ? tile[lane * W + c] & before : 0u;
    uint32_t keep = avail;
    for (;;) {
      const uint32_t next = __ballot_sync(kFull, free_p && !(over & keep));
      if (next == keep) break;
      keep = next;
    }
    const int out = emitted + __popc(keep & before);
    keep = __ballot_sync(kFull, ((keep >> lane) & 1u) && out < max_det);  // no pick past max_det
    if ((keep >> lane) & 1u) {
      idx_b[out] = order_sm[slot * 32 + lane];
      ok_b[out] = 1;
    }
    emitted += __popc(keep);
#pragma unroll
    for (int s = 0; s < Slots; ++s) {  // OR the kept rows into the words past this chunk
      const int w = lane + 32 * s;
      if (w > c && w < nw) {
        uint32_t any = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((keep >> i) & 1u) any |= tile[i * W + w];
        }
        removed[s] |= any;
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
  asm volatile("cp.async.wait_all;\n");
  for (int u = emitted + lane; u < max_det; u += 32) {
    idx_b[u] = 0;
    ok_b[u] = 0;
  }
}

}  // namespace

// boxes: f32 (B, K, 4) xyxy with class offsets; scores: f32 (B, K); valid:
// bool (B, K); idx: int32 (B, max_det); ok: bool (B, max_det). Scratch the
// wrapper allocates: sboxes f32 (B, K, 4), order int32 (B, K), count int32
// (B), mask int32 (B, K, mask_words(K)); all 16-byte aligned. Returns
// cudaErrorInvalidValue unlaunched outside 1 <= K <= 10240, 1 <= B <= 65535.
extern "C" int fce_pick_suppress(const void* boxes, const void* scores, const void* valid, void* idx, void* ok,
                                 void* sboxes, void* order, void* count, void* mask, int B, int K, int max_det,
                                 float iou_thres, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > kMaxK || max_det < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int N = 1;
  while (N < K) N <<= 1;
  const int sort_threads = N / 2 < 32 ? 32 : (N / 2 > 1024 ? 1024 : N / 2);
  const int sort_bytes = N * 8 + 16, scan_bytes = scan_smem(K);
  // the main path's K = 1024 and the validator's 4096 each get their own bitset size
  auto* scan_kernel =
      K <= 1024 ? nms_scan_kernel<1> : K <= 4096 ? nms_scan_kernel<4> : nms_scan_kernel<kMaxSlots>;
  cudaError_t err = cudaSuccess;
  if (sort_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sort_bytes);
  }
  if (err == cudaSuccess && scan_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 sort_grid(B), sort_block(sort_threads);
  nms_sort_kernel<<<sort_grid, sort_block, sort_bytes, st>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), static_cast<const uint8_t*>(valid),
      static_cast<float4*>(sboxes), static_cast<int32_t*>(order), static_cast<int32_t*>(count), K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 mask_grid((K + 31) / 32, (K + kMaskRows - 1) / kMaskRows, B), mask_block(kMaskRows);
  nms_mask_kernel<<<mask_grid, mask_block, kMaskSmem, st>>>(
      static_cast<const float4*>(sboxes), static_cast<const int32_t*>(count), static_cast<uint32_t*>(mask), K,
      iou_thres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 scan_grid(B), scan_block(32);
  scan_kernel<<<scan_grid, scan_block, scan_bytes, st>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(count), static_cast<const uint32_t*>(mask),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(ok), K, max_det);
  return static_cast<int>(cudaGetLastError());
}
