// Batched greedy NMS for Hopper (sm_90a): one block per image.
//
// Replaces the TPU kernel fce_yolo_tpu/ops/pallas_nms.py (_nms_kernel,
// launched by pallas_pick_suppress). Per image, up to max_det steps: pick
// the argmax of the live scores (lowest index on ties, the jnp.argmax
// rule), stop once the row is empty, compute IoU of the pick against all K
// candidates, and kill every candidate with IoU > thres plus the pick.
// Returns idx (B, max_det) int32 and ok (B, max_det) bool; after the row is
// exhausted idx = 0 and ok = false, as both JAX versions give.
//
// What bounds it on the H100: not bytes (6 x K floats per image) but the
// serial chain of max_det dependent steps, each a block-wide reduction
// plus a K-wide pass. The design keeps the whole candidate set in shared
// memory (6 x 1024 x 4 B = 24 KB at K = 1024), reduces with warp shuffles
// and one shared-memory round, and exits the loop as soon as the row is
// empty. The TPU kernel vectorised the step across the batch on its single
// core; here the images are independent blocks, so a batch of B uses B of
// the 132 SMs (occupancy is an open question at small B).
//
// Exactness: the keep-set and order must equal the plain version bit for
// bit, so area, intersection and IoU use explicitly rounded operations in
// the JAX order inter / (((a_i + a_j) - inter) + 1e-7): without them nvcc
// contracts a - iw * ih into an FMA and flips boxes at the threshold.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (ov, oi) when larger, or equal with the lower index
__device__ __forceinline__ void arg_max_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ idx, uint8_t* __restrict__ ok,
    int K, int max_det, float iou_thres) {
  extern __shared__ float sm[];
  float* x1 = sm;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  float* live = area + K;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float neg_inf = -INFINITY;
  const float* bb = boxes + static_cast<size_t>(b) * K * 4;
  for (int j = tid; j < K; j += kThreads) {
    const float a = bb[4 * j], c = bb[4 * j + 1], d = bb[4 * j + 2], e = bb[4 * j + 3];
    x1[j] = a; y1[j] = c; x2[j] = d; y2[j] = e;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(d, a), 0.0f), fmaxf(__fsub_rn(e, c), 0.0f));
    live[j] = valid[static_cast<size_t>(b) * K + j] ? scores[static_cast<size_t>(b) * K + j] : neg_inf;
  }
  __syncthreads();

  int32_t* idx_b = idx + static_cast<size_t>(b) * max_det;
  uint8_t* ok_b = ok + static_cast<size_t>(b) * max_det;
  int t = 0;
  for (; t < max_det; ++t) {
    float v = neg_inf;
    int i = K;
    for (int j = tid; j < K; j += kThreads) arg_max_merge(v, i, live[j], j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      arg_max_merge(v, i, ov, oi);
    }
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? red_v[lane] : neg_inf;
      i = lane < kWarps ? red_i[lane] : K;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        arg_max_merge(v, i, ov, oi);
      }
      if (lane == 0) {
        s_pick = v > neg_inf ? i : -1;
        if (v > neg_inf) { idx_b[t] = i; ok_b[t] = 1; }
      }
    }
    __syncthreads();
    const int pick = s_pick;
    if (pick < 0) break;  // row exhausted (uniform across the block)
    const float px1 = x1[pick], py1 = y1[pick], px2 = x2[pick], py2 = y2[pick], pa = area[pick];
    for (int j = tid; j < K; j += kThreads) {
      const float iw = fmaxf(__fsub_rn(fminf(px2, x2[j]), fmaxf(px1, x1[j])), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(py2, y2[j]), fmaxf(py1, y1[j])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(pa, area[j]), inter), 1e-7f);
      const float iou = __fdiv_rn(inter, den);
      if (iou > iou_thres || j == pick) live[j] = neg_inf;
    }
    __syncthreads();
  }
  for (int u = t + tid; u < max_det; u += kThreads) { idx_b[u] = 0; ok_b[u] = 0; }
}

}  // namespace

// boxes: f32 (B, K, 4) xyxy with class offsets; scores: f32 (B, K);
// valid: bool (B, K); idx: int32 (B, max_det); ok: bool (B, max_det).
// The wrapper checks shapes, dtypes, contiguity and the shared-memory bound.
extern "C" int fce_pick_suppress(const void* boxes, const void* scores, const void* valid,
                                 void* idx, void* ok, int B, int K, int max_det,
                                 float iou_thres, void* stream) {
  const size_t smem = static_cast<size_t>(6) * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(ok), K, max_det, iou_thres);
  return static_cast<int>(cudaGetLastError());
}
