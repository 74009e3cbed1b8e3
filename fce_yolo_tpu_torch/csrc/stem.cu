// Fused YOLO11 stem for Hopper (sm_90a): uint8 NHWC image -> bf16 NHWC
// stride-4 C3k2 output, in ONE launch.
//
// Replaces the TPU kernel fce_yolo_tpu/ops/pallas_stem.py (_stem_kernel,
// _compute_tile): layers 0..2 of YOLO11 with BN and /255 folded into the
// weights (fold_stem_params):
//   L0  Conv 3x3 s2 + SiLU      (3 -> c0)
//   L1  Conv 3x3 s2 + SiLU      (c0 -> c1)
//   L2  C3k2(e=0.25): cv1 1x1 (c1 -> 2ch), n inner blocks (Bottleneck at
//       n/s, C3k at m/l/x) chained off the second half, cv2 1x1 over
//       concat(ya, yb, m_0..m_{n-1}) -> c2.
//
// What bounds it on the H100: the unfused chain writes and re-reads every
// intermediate (the L0 map alone is 4x the image's bytes times c0/3 in
// bf16). This kernel reads the uint8 image once and writes only the
// c2-channel output: one block owns a T x T output tile and recomputes its
// receptive-field halo (halo = one stride-4 row per 3x3 conv of the inner
// chain), so every intermediate lives in shared memory. The recompute makes
// it compute-heavy (~3.4 GMAC per 640x640 image at T = 8, the s form), more
// than FP32 FMA on the CUDA cores can do faster than cuDNN's unfused bf16
// convolutions, so every conv runs on the tensor cores as an implicit GEMM
// with mma.sync m16n8k16 (bf16 in, f32 accumulate): M = output positions
// of the stage's region, N = output channels, K = taps x input channels
// (padded per tap to 16), A gathered from the shared-memory activations, B
// read from the pre-arranged weights through L1. wgmma and TMA staging are
// the next step. Each stage stores bf16 after SiLU, the TPU kernel's
// rounding.
//
// Padding: every conv zero-pads symmetrically. A stage's buffer holds ZERO
// at positions outside the image at that stage's own resolution (the TPU
// kernel's _row_mask rule), never SiLU(bias). Positions at the edge of a
// block's region whose inputs fall outside the region read zeros; they are
// halo garbage that provably never reaches the T x T window.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInner = 4;  // inner-block repeats the argument struct holds
constexpr int kMaxArrays = 8 + 14 * kMaxInner;
constexpr int kPad = 8;       // extra bf16 per position: spreads A loads over the banks

struct StemArgs {
  const uint8_t* x;             // (B, H, W, 3)
  __nv_bfloat16* out;           // (B, H/4, W/4, c2)
  const __nv_bfloat16* w[kMaxArrays];  // fold_stem_params order, MMA layout
  int H, W, c0, c1, c2, ch, n, c3k, T, halo;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ inline int round16(int c) { return (c + 15) & ~15; }

// The fast exp and divide intrinsics: the result is rounded to bf16 right
// after, and the epilogue costs about as much as the MMAs (measured: IEEE
// expf and division make the whole kernel 15% slower, same error).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv stage on the tensor cores: k x k, stride s, symmetric pad k/2,
// folded bias, SiLU.
// Input: an (in_h x in_w) region with channel stride in_cs (bf16) whose
// top-left is global (in_y0, in_x0) at the input resolution; channels
// [cin, round16(cin)) read as zero (cin even). Weights: [cout][k*k][round16(cin)].
// Output: an (out_h x out_w) grid at global (out_y0, out_x0), stored at
// out + (oy * out_row + ox) * out_cs. Outputs outside [0, Hs) x [0, Ws) are
// stored as 0 (skip_outside == false) or not stored (skip_outside == true,
// the final stage writing to global memory). res, when given, is added
// after the bf16 rounding (residual shortcut), with the output's layout.
// Each warp computes a 16-position x (8 * NB)-channel tile at a time.
// PACKED (L0 only, input = image with 4 channels, k = 3): K runs over
// (tap, channel) = 36 in three chunks of 16 instead of one padded chunk per
// tap (measured 10% faster for the whole kernel); weights [cout][48].
template <int NB, bool PACKED>
__device__ void conv_stage(const __nv_bfloat16* in, int in_h, int in_w, int in_cs,
                           int in_y0, int in_x0, int cin,
                           __nv_bfloat16* out, int out_h, int out_w, int out_row, int out_cs,
                           int out_y0, int out_x0, int cout,
                           int k, int stride, const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias, int Hs, int Ws,
                           const __nv_bfloat16* res, bool skip_outside) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int pad = k / 2, kk = k * k, cinp = round16(cin);
  const int npos = out_h * out_w;
  const int mtiles = (npos + 15) / 16, ngroups = cout / (8 * NB);
  for (int item = warp; item < mtiles * ngroups; item += nwarps) {
    const int mt = item / ngroups, n0 = (item % ngroups) * 8 * NB;
    int pos[2], gy[2], gx[2];
    bool row_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // this thread's A/C rows: gid and gid + 8
      pos[h] = mt * 16 + gid + 8 * h;
      row_ok[h] = pos[h] < npos;
      const int p = row_ok[h] ? pos[h] : 0;
      gy[h] = out_y0 + p / out_w;
      gx[h] = out_x0 + p % out_w;
    }
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    if (PACKED) {  // L0: K = (tap, rgb0) = 36 -> three chunks of 16; weights [cout][48]
      for (int q = 0; q < 3; ++q) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tap = 4 * q + 2 * half + (tig >> 1), c = (tig & 1) * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ly = gy[h] * stride - pad + tap / 3 - in_y0;
            const int lx = gx[h] * stride - pad + tap % 3 - in_x0;
            const bool ok = tap < 9 && row_ok[h] && ly >= 0 && ly < in_h && lx >= 0 && lx < in_w;
            a[2 * half + h] = ok ? ld32(in + (ly * in_w + lx) * in_cs + c) : 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const __nv_bfloat16* wp = w + (n0 + 8 * j + gid) * 48 + 16 * q + 2 * tig;
          mma_bf16(acc[j], a, ld32(wp), ld32(wp + 8));
        }
      }
    }
    for (int tap = 0; tap < (PACKED ? 0 : kk); ++tap) {
      const int dy = tap / k, dx = tap % k;
      const __nv_bfloat16* rp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ly = gy[h] * stride - pad + dy - in_y0;
        const int lx = gx[h] * stride - pad + dx - in_x0;
        rp[h] = (row_ok[h] && ly >= 0 && ly < in_h && lx >= 0 && lx < in_w)
                    ? in + (ly * in_w + lx) * in_cs : nullptr;
      }
      const __nv_bfloat16* wt = w + (static_cast<size_t>(n0 + gid) * kk + tap) * cinp + 2 * tig;
#pragma unroll 2
      for (int c0 = 0; c0 < cinp; c0 += 16) {
        const int ca = c0 + 2 * tig, cb = ca + 8;
        uint32_t a[4];
        a[0] = (rp[0] && ca < cin) ? ld32(rp[0] + ca) : 0u;
        a[1] = (rp[1] && ca < cin) ? ld32(rp[1] + ca) : 0u;
        a[2] = (rp[0] && cb < cin) ? ld32(rp[0] + cb) : 0u;
        a[3] = (rp[1] && cb < cin) ? ld32(rp[1] + cb) : 0u;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const __nv_bfloat16* wp = wt + static_cast<size_t>(8 * j) * kk * cinp + c0;
          mma_bf16(acc[j], a, ld32(wp), ld32(wp + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int co = n0 + 8 * j + 2 * tig;
      const float b0 = __bfloat162float(bias[co]), b1 = __bfloat162float(bias[co + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!row_ok[h]) continue;
        const bool inside = gy[h] >= 0 && gy[h] < Hs && gx[h] >= 0 && gx[h] < Ws;
        if (!inside && skip_outside) continue;
        const int oy = pos[h] / out_w, ox = pos[h] % out_w;
        const int o = (oy * out_row + ox) * out_cs + co;
        float v0 = 0.0f, v1 = 0.0f;
        if (inside) {
          v0 = round_bf16(silu(acc[j][2 * h] + b0));
          v1 = round_bf16(silu(acc[j][2 * h + 1] + b1));
          if (res != nullptr) {
            v0 += __bfloat162float(res[o]);
            v1 += __bfloat162float(res[o + 1]);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <bool PACKED = false>
__device__ void conv(const __nv_bfloat16* in, int in_h, int in_w, int in_cs, int in_y0, int in_x0,
                     int cin, __nv_bfloat16* out, int out_h, int out_w, int out_row, int out_cs,
                     int out_y0, int out_x0, int cout, int k, int stride,
                     const __nv_bfloat16* w, const __nv_bfloat16* bias, int Hs, int Ws,
                     const __nv_bfloat16* res, bool skip_outside) {
  // The widest warp tile (NB x 8 channels, NB <= 4) that divides cout.
  // Measured on the H100 (s form, B = 16): reusing each gathered A fragment
  // across more MMAs beats balancing the warps over the tiles (narrower
  // tiles for balance: +25% time), and NB = 8 takes 223 registers (+50%).
  const int nb = cout % 32 == 0 ? 4 : cout % 16 == 0 ? 2 : 1;
  if (nb == 4) {
    conv_stage<4, PACKED>(in, in_h, in_w, in_cs, in_y0, in_x0, cin, out, out_h, out_w, out_row, out_cs,
                          out_y0, out_x0, cout, k, stride, w, bias, Hs, Ws, res, skip_outside);
  } else if (nb == 2) {
    conv_stage<2, PACKED>(in, in_h, in_w, in_cs, in_y0, in_x0, cin, out, out_h, out_w, out_row, out_cs,
                          out_y0, out_x0, cout, k, stride, w, bias, Hs, Ws, res, skip_outside);
  } else {
    conv_stage<1, PACKED>(in, in_h, in_w, in_cs, in_y0, in_x0, cin, out, out_h, out_w, out_row, out_cs,
                          out_y0, out_x0, cout, k, stride, w, bias, Hs, Ws, res, skip_outside);
  }
}

__global__ void __launch_bounds__(kThreads) stem_kernel(StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const int T = a.T, halo = a.halo, n = a.n, ch = a.ch;
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
  const int oy0 = blockIdx.y * T, ox0 = blockIdx.x * T;  // output tile, stride-4 grid
  const int R = T + 2 * halo, R1 = 2 * R + 1, R0 = 2 * R1 + 1;
  const int y2 = oy0 - halo, x2 = ox0 - halo;  // C3k2-stage region origin (H/4 grid)
  const int y1 = 2 * y2 - 1, x1 = 2 * x2 - 1;  // L0 region origin (H/2 grid)
  const int y0 = 2 * y1 - 1, x0 = 2 * x1 - 1;  // image region origin
  const int cys = (2 + n) * ch;                // channels of concat(ya, yb, m_i)
  // channel strides in shared memory (padded, see kPad)
  const int s0 = a.c0 + kPad, s1 = a.c1 + kPad, sy = cys + kPad;

  // shared memory: [A1][ IMG | A0 ] with [ YS | SCR ] overlaying IMG/A0
  // once L1 has consumed them
  __nv_bfloat16* A1 = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* P = smem + align16(R * R * s1 * 2);
  __nv_bfloat16* IMG = reinterpret_cast<__nv_bfloat16*>(P);  // RGB + a zero 4th channel
  __nv_bfloat16* A0 = reinterpret_cast<__nv_bfloat16*>(P + align16(R0 * R0 * 4 * 2));
  __nv_bfloat16* YS = reinterpret_cast<__nv_bfloat16*>(P);
  __nv_bfloat16* SCR = reinterpret_cast<__nv_bfloat16*>(P + align16(R * R * sy * 2));

  const uint8_t* xb = a.x + static_cast<size_t>(b) * a.H * a.W * 3;
  for (int p = threadIdx.x; p < R0 * R0; p += blockDim.x) {
    const int gy = y0 + p / R0, gx = x0 + p % R0;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const uint8_t* px = xb + (static_cast<size_t>(gy) * a.W + gx) * 3;
      v[0] = px[0]; v[1] = px[1]; v[2] = px[2];
    }
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(IMG + 4 * p);
    q[0] = __floats2bfloat162_rn(v[0], v[1]);  // 0..255 are exact in bf16
    q[1] = __floats2bfloat162_rn(v[2], 0.0f);
  }
  __syncthreads();

  const __nv_bfloat16* const* w = a.w;
  // L0: image -> A0 (R1 x R1 x c0), 3x3 s2
  conv<true>(IMG, R0, R0, 4, y0, x0, 4, A0, R1, R1, R1, s0, y1, x1, a.c0, 3, 2, w[0], w[1], H2, W2,
             nullptr, false);
  __syncthreads();
  // L1: A0 -> A1 (R x R x c1), 3x3 s2
  conv(A0, R1, R1, s0, y1, x1, a.c0, A1, R, R, R, s1, y2, x2, a.c1, 3, 2, w[2], w[3], H4, W4,
       nullptr, false);
  __syncthreads();
  // C3k2 cv1: A1 -> YS[:, 0:2ch] (ya | yb)
  conv(A1, R, R, s1, y2, x2, a.c1, YS, R, R, R, sy, y2, x2, 2 * ch, 1, 1, w[4], w[5], H4, W4,
       nullptr, false);
  __syncthreads();

  int wi = 6;
  for (int i = 0; i < n; ++i) {
    const __nv_bfloat16* yin = YS + (1 + i) * ch;  // ys[-1]
    __nv_bfloat16* yout = YS + (2 + i) * ch;
    if (!a.c3k) {  // Bottleneck(ch, ch, e=0.5): 3x3 ch -> ch/2 -> ch, + shortcut
      const int hh = ch / 2, sz = hh + kPad;
      conv(yin, R, R, sy, y2, x2, ch, SCR, R, R, R, sz, y2, x2, hh, 3, 1, w[wi], w[wi + 1],
           H4, W4, nullptr, false);
      __syncthreads();
      conv(SCR, R, R, sz, y2, x2, hh, yout, R, R, R, sy, y2, x2, ch, 3, 1, w[wi + 2], w[wi + 3],
           H4, W4, yin, false);
      __syncthreads();
      wi += 4;
    } else {  // C3k(ch, ch, n=2): cv1/cv2 1x1 -> c_, two 3x3 bottlenecks on a, cv3 1x1
      const int c_ = ch / 2, sab = ch + kPad, sz = c_ + kPad;
      __nv_bfloat16* AB = SCR;  // a | b interleaved per position
      __nv_bfloat16* Z = SCR + R * R * sab;
      conv(yin, R, R, sy, y2, x2, ch, AB, R, R, R, sab, y2, x2, c_, 1, 1, w[wi], w[wi + 1],
           H4, W4, nullptr, false);
      conv(yin, R, R, sy, y2, x2, ch, AB + c_, R, R, R, sab, y2, x2, c_, 1, 1, w[wi + 2],
           w[wi + 3], H4, W4, nullptr, false);
      __syncthreads();
      for (int j = 0; j < 2; ++j) {
        const int o = wi + 4 + 4 * j;
        conv(AB, R, R, sab, y2, x2, c_, Z, R, R, R, sz, y2, x2, c_, 3, 1, w[o], w[o + 1],
             H4, W4, nullptr, false);
        __syncthreads();
        conv(Z, R, R, sz, y2, x2, c_, AB, R, R, R, sab, y2, x2, c_, 3, 1, w[o + 2], w[o + 3],
             H4, W4, AB, false);
        __syncthreads();
      }
      conv(AB, R, R, sab, y2, x2, ch, yout, R, R, R, sy, y2, x2, ch, 1, 1, w[wi + 12],
           w[wi + 13], H4, W4, nullptr, false);
      __syncthreads();
      wi += 14;
    }
  }
  // C3k2 cv2 over the T x T window, straight to global memory
  __nv_bfloat16* ob = a.out + ((static_cast<size_t>(b) * H4 + oy0) * W4 + ox0) * a.c2;
  conv(YS, R, R, sy, y2, x2, cys, ob, T, T, W4, a.c2, oy0, ox0, a.c2, 1, 1, w[wi], w[wi + 1],
       H4, W4, nullptr, true);
}

// Shared-memory bytes one block needs at tile T: the carve-up above.
int stem_smem_bytes(int c0, int c1, int ch, int n, int c3k, int T) {
  const int halo = n * (c3k ? 4 : 2);
  const int R = T + 2 * halo, R1 = 2 * R + 1, R0 = 2 * R1 + 1;
  const int a1 = align16(R * R * (c1 + kPad) * 2);
  const int first = align16(R0 * R0 * 4 * 2) + align16(R1 * R1 * (c0 + kPad) * 2);
  const int scratch = c3k ? R * R * (ch + kPad + ch / 2 + kPad) : R * R * (ch / 2 + kPad);
  const int second = align16(R * R * ((2 + n) * ch + kPad) * 2) + align16(scratch * 2);
  return a1 + (first > second ? first : second);
}

}  // namespace

// x: uint8 (B, H, W, 3); wflat: the folded bf16 convs concatenated in
// fold_stem_params order, each weight as [cout][k*k][round16(cin)] (zero
// padded) followed by its bias [cout] (ops/stem.py stem_weights); out: bf16
// (B, H/4, W/4, c2). The wrapper checks shapes, dtypes, contiguity,
// channel multiples of 8 and n <= 4. The output tile is the largest of
// 8, 4, 2, 1 whose working set fits one block's shared memory on the
// current device (the s form at 640 px: 8, the m form: 4); a spec that fits
// none (the l/x forms, halo 8) returns cudaErrorInvalidValue unlaunched.
extern "C" int fce_fused_stem(const void* x, const void* wflat, void* out, int B, int H, int W,
                              int c0, int c1, int c2, int ch, int n, int c3k, void* stream) {
  if (n < 1 || n > kMaxInner) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int T = 8;
  while (T > 0 && stem_smem_bytes(c0, c1, ch, n, c3k, T) > smem_limit) T /= 2;
  if (T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = stem_smem_bytes(c0, c1, ch, n, c3k, T);
  StemArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H; a.W = W; a.c0 = c0; a.c1 = c1; a.c2 = c2; a.ch = ch; a.n = n; a.c3k = c3k;
  a.T = T; a.halo = n * (c3k ? 4 : 2);
  // element counts in fold_stem_params order: weight, then bias
  int sizes[kMaxArrays];
  int k = 0;
  auto add = [&](int taps, int cin, int cout) {
    sizes[k++] = cout * taps * round16(cin);
    sizes[k++] = cout;
  };
  sizes[k++] = c0 * 48;  // L0: K packed as (tap, rgb + 0) = 36, padded to 48
  sizes[k++] = c0;
  add(9, c0, c1);
  add(1, c1, 2 * ch);
  const int c_ = ch / 2;
  for (int i = 0; i < n; ++i) {
    if (c3k) {
      add(1, ch, c_); add(1, ch, c_);
      for (int j = 0; j < 2; ++j) { add(9, c_, c_); add(9, c_, c_); }
      add(1, 2 * c_, ch);
    } else {
      add(9, ch, c_); add(9, c_, ch);
    }
  }
  add(1, (2 + n) * ch, c2);
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(wflat);
  for (int i = 0; i < k; ++i) { a.w[i] = p; p += sizes[i]; }
  for (int i = k; i < kMaxArrays; ++i) a.w[i] = nullptr;

  cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  const int H4 = H / 4, W4 = W / 4;
  dim3 grid((W4 + T - 1) / T, (H4 + T - 1) / T, B);
  stem_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
