// Fused YOLO11 stem for Hopper (sm_90a): uint8 NHWC image -> bf16 NHWC
// stride-4 C3k2 output, in ONE launch.
//
// Replaces the TPU kernel fce_yolo_tpu/ops/pallas_stem.py::_stem_kernel
// (_compute_tile): layers 0..2 of YOLO11 with BN and /255 folded into the
// weights (fold_stem_params):
//   L0  Conv 3x3 s2 + SiLU      (3 -> c0)
//   L1  Conv 3x3 s2 + SiLU      (c0 -> c1)
//   L2  C3k2(e=0.25): cv1 1x1 (c1 -> 2ch), n inner blocks (Bottleneck at
//       n/s, C3k at m/l/x) chained off the second half, cv2 1x1 over
//       concat(ya, yb, m_0..m_{n-1}) -> c2.
// bf16 is stored after every SiLU, sums are f32 (the TPU kernel's rounding).
//
// Bound on the H100 (s form, 640 x 640, B = 16). Useful multiply-adds per
// image: L0 102,400*32*27 = 88.5 M; L1 25,600*64*288 = 471.9 M; cv1
// 25,600*64*64 = 104.9 M; the Bottleneck's two 3x3 convs 2 * 25,600*16*288
// = 236.0 M; cv2 25,600*128*96 = 314.6 M: 1.216 GMAC = 2.43 GFLOP. At B = 16,
// 38.9 GFLOP / 989 TFLOP/s (bf16 dense) = 0.039 ms; the bytes, 1.23 MB of
// uint8 in and 6.55 MB of bf16 out per image, take 124.5 MB / 3.35 TB/s =
// 0.037 ms. The bound is 0.039 ms: compute and bytes are within 5%.
//
// Design, against what held the first version back (times: PERF.md):
// 1. Halo recompute. A persistent block (one per SM, 512 threads) takes
//    (image, column strip, row band) work items and walks its strip top to
//    bottom, R stride-4 rows a step. Each stage keeps the rows the next
//    stage still needs in a line buffer (a window of rows that slides down
//    by R each step), so no row is computed twice vertically; only the
//    strip's side halo is, and ceil(2 halo / R) warm-up steps per band. A
//    stage at "lag" L (L 3x3 convs below cv1) computes the rows L above
//    cv1's, so every 3x3 conv finds its lower row already made. The host
//    takes the first (R, S) of (4, 32), (4, 28), (2, 32), ... whose buffers
//    and weights fit (s: R = 4 rows, S = 28 columns, 32 computed at L1 and
//    65 at L0, so L1 has M = 128 positions a step), and the band height
//    that gives the busiest block the fewest steps.
// 2. A operand. Every stage is an implicit GEMM on mma.sync m16n8k16 (bf16
//    in, f32 accumulate) whose A fragments come from ldmatrix.x4: each lane
//    gives the shared-memory row of one position's 8 channels. K runs over
//    (tap, 8-channel group) and a per-stage table holds each group's
//    offset, so there is no per-load branch. Layouts keep ldmatrix free of
//    bank conflicts: a position's channel stride is an odd multiple of 16
//    bytes, the L0 map is stored with even and odd columns apart (the
//    stride-2 L1 reads consecutive slots), and L0 reads pairs of rgb0
//    pixels straight from the widened image rows (K = 3 rows x 16).
// 3. B operand. The packed weights (ops/stem.py::stem_weights: [cout][K
//    padded to an odd multiple of 8]) are copied once per block into shared
//    memory and read with ldmatrix. At s all 96.5 KB stay resident; a form
//    whose weights do not fit (m: L1 alone is 150 KB) keeps what fits and
//    reads the rest through L1/L2 with 32-bit loads.
// 4. Overlap. The next step's image rows are fetched with cp.async (16
//    bytes where the rows allow) into the other half of a double buffer
//    while the current step computes; the uint8 -> bf16 widening runs from
//    shared memory. Measured: it gains 0-3% at s, where a step is bound by
//    its own instructions, not by the image's bytes.
// 5. Output. cv2 writes R row segments (strip x c2) to shared memory; they
//    leave in 16-byte stores, each output row segment contiguous.
// 6. mma.sync, not wgmma. A step's stages have 112..128 positions (585 at
//    L0) and 16..128 output channels: wgmma's 64-row tiles would leave each
//    stage one or two tiles for 16 warps. What bounds a step is the
//    instructions around the MMAs (set-up, epilogue, barriers): the last
//    gains came from removing them (an f32 bias table in shared memory,
//    division by multiply-high, branch-free zeroing).
//
// Padding: every conv zero-pads symmetrically. A stage's buffer holds ZERO
// at positions outside the image at that stage's own resolution (the TPU
// kernel's _row_mask rule), never SiLU(bias). Rows and columns a block
// computes beyond what its output needs read whatever the buffer holds;
// they never reach a needed position.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxInner = 4;          // inner-block repeats the argument struct holds
constexpr int kMaxStages = 3 + 7 * kMaxInner + 1;
constexpr int kMaxBufs = 6 + 5 * kMaxInner;

// buffers; scratch buffers of the inner blocks follow kFirstScratch
enum { kRaw, kImg, kL0, kL1, kYs, kOut, kFirstScratch };
// stage kinds: what the stage reads and where it writes
enum { kStageL0, kStageL1, kStageConv, kStageLast };

struct StageP {
  int kind, k, cin, cout, kp, groups, nb, sync;
  int lag, col0, width, rows;
  int in_buf, in_c, in_row0;
  int out_buf, out_c, out_row0;
  int res_buf, res_c, res_row0;
  int koff;  // first entry of this stage's K-offset table
  int wofs;  // element offset of the weight in the packed buffer (bias follows)
  int wsm;   // byte offset of the weight in shared memory, -1: read from global
  int bofs;  // first entry of this stage's bias in the shared f32 bias table
  unsigned wdiv;  // p / width == __umulhi(p, wdiv) (fast_div)
  unsigned mdiv;  // the same for the stage's count of 16-position tiles (> 1)
};

struct BufP {
  int off;   // byte offset in shared memory
  int rows;  // rows of the window
  int cs;    // channel stride (bf16 elements per position)
};

struct StemArgs {
  const uint8_t* x;     // (B, H, W, 3)
  __nv_bfloat16* out;   // (B, H/4, W/4, c2)
  const __nv_bfloat16* w;
  int B, H, W, c2, halo, S, Wc, R, warm, Hb, nbands, nstrips, items, nstages, rawb;
  int vec;              // bytes per cp.async of the image rows: 16 where rows allow, else 4
  int bias_off, nbias;  // the shared f32 bias table: byte offset, entries
  int ncarry;           // line buffers that carry rows from step to step
  int carry[kMaxBufs];
  StageP st[kMaxStages];
  BufP buf[kMaxBufs];
};

// channels + padding so that a position's stride is an odd multiple of 16 bytes
__host__ __device__ inline int chan_stride(int c) { return (c / 8) % 2 ? c : c + 8; }
__host__ __device__ inline int round16(int c) { return (c + 15) & ~15; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
// ceil(2^32 / d): __umulhi(p, m) == p / d while p * d < 2^32 (d >= 2)
__host__ __device__ inline unsigned div_magic(int d) { return 0xFFFFFFFFu / static_cast<unsigned>(d) + 1u; }
__device__ __forceinline__ int fast_div(int p, unsigned m) { return static_cast<int>(__umulhi(static_cast<unsigned>(p), m)); }

// SiLU with the fast exp and divide intrinsics: relative error ~2^-21 for
// every v, rounded to bf16 (2^-8) right after. (0.5 v (1 + tanh.approx(0.5 v))
// saves a MUFU op but cancels for negative v: 2^-11 of |tanh| against 1 +
// tanh = 0.036 at v = -4.)
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// One work item: image b, strip (stride-4 columns [X + halo, X + halo + S)),
// band (output rows [r0, rend)). Buffer column 0 is stride-4 column X; the
// step t window has L1 rows [a0 + R t, a0 + R t + R).
struct Item {
  int b, strip, X, r0, rend, a0, steps;
};

__device__ __forceinline__ Item item_geometry(const StemArgs& a, int item) {
  Item g;
  const int per_image = a.nstrips * a.nbands;
  g.b = item / per_image;
  const int rem = item % per_image;
  const int band = rem / a.nstrips;
  g.strip = rem % a.nstrips;
  g.X = g.strip * a.S - a.halo;
  g.r0 = band * a.Hb;
  g.rend = min(g.r0 + a.Hb, a.H / 4);
  g.a0 = g.r0 - a.R * a.warm + a.halo;  // warm-up steps: R * warm >= 2 * halo rows
  g.steps = a.warm + (g.rend - g.r0 + a.R - 1) / a.R;
  return g;
}

// Image columns a step reads: [4X - 3, 4X - 3 + Wimg); the uint8 bytes
// [blo, blo + words * vec) of each row cover the part inside the image,
// vec-byte aligned (vec = 16 needs rows of a multiple of 16 bytes).
__device__ __forceinline__ void raw_span(const StemArgs& a, const Item& g, int& blo, int& words) {
  const int wimg = 4 * a.Wc + 4, g0 = 4 * g.X - 3, v = a.vec;
  const int clo = max(g0, 0), chi = min(g0 + wimg, a.W);
  blo = (3 * clo) & -v;
  words = chi > clo ? (((3 * chi + v - 1) & -v) - blo) / v : 0;
}

__device__ __forceinline__ void fetch_image_rows(const StemArgs& a, unsigned char* smem, const Item g, int t, int half) {
  int blo, words;
  raw_span(a, g, blo, words);
  if (words == 0) return;
  const int gr0 = 4 * (g.a0 + a.R * t) - 3, rows = 4 * a.R + 3;
  const unsigned m = div_magic(max(words, 2));
  const uint8_t* xb = a.x + static_cast<size_t>(g.b) * a.H * a.W * 3 + blo;
  const uint32_t dst = smem_u32(smem + a.buf[kRaw].off + half * rows * a.rawb);
  for (int i = threadIdx.x; i < rows * words; i += kThreads) {
    const int r = words == 1 ? i : fast_div(i, m), k = i - r * words, gr = gr0 + r;
    if (gr < 0 || gr >= a.H) continue;
    const uint8_t* src = xb + static_cast<size_t>(gr) * a.W * 3 + a.vec * k;
    if (a.vec == 16) cp_async16(dst + r * a.rawb + 16 * k, src);
    else cp_async4(dst + r * a.rawb + 4 * k, src);
  }
}

// uint8 rows -> bf16 (r, g, b, 0) pixels, zero outside the image
__device__ __forceinline__ void widen_image(const StemArgs& a, unsigned char* smem, const Item g, int t, int half) {
  int blo, words;
  raw_span(a, g, blo, words);
  const int wimg = 4 * a.Wc + 4, g0 = 4 * g.X - 3, gr0 = 4 * (g.a0 + a.R * t) - 3, rows = 4 * a.R + 3;
  const unsigned m = div_magic(wimg);
  const uint8_t* raw = smem + a.buf[kRaw].off + half * rows * a.rawb;
  uint2* img = reinterpret_cast<uint2*>(smem + a.buf[kImg].off);
  for (int i = threadIdx.x; i < rows * wimg; i += kThreads) {
    const int r = fast_div(i, m), c = i - r * wimg, gr = gr0 + r, gc = g0 + c;
    uint2 v = make_uint2(0u, 0u);
    if (gr >= 0 && gr < a.H && gc >= 0 && gc < a.W) {
      const uint8_t* p = raw + r * a.rawb + 3 * gc - blo;
      __nv_bfloat162 rg = __floats2bfloat162_rn(p[0], p[1]);  // 0..255 are exact in bf16
      __nv_bfloat162 b0 = __floats2bfloat162_rn(p[2], 0.0f);
      v.x = *reinterpret_cast<uint32_t*>(&rg);
      v.y = *reinterpret_cast<uint32_t*>(&b0);
    }
    img[i] = v;
  }
}

// One stage over the step's positions: M = rows x width positions, N =
// cout, K = groups x 8. A warp takes a 16-position x (8 * NB)-channel tile at
// a time. BSM: the weights are in shared memory (ldmatrix), else global.
template <int NB, bool BSM>
__device__ __forceinline__ void run_stage(const StemArgs& a, const StageP s, unsigned char* smem, const int* koff,
                                          const float* btab, const Item g, int A) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int M = s.rows * s.width, mtiles = (M + 15) / 16, items = mtiles * (s.cout / (8 * NB));
  const int Wc = a.Wc, L0W = 2 * Wc + 1, S = a.S, halo = a.halo;
  const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(smem + a.buf[s.in_buf].off);
  const int in_cs = a.buf[s.in_buf].cs;
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem + a.buf[s.out_buf].off);
  const int out_cs = a.buf[s.out_buf].cs;
  const __nv_bfloat16* res = s.res_buf >= 0 ? reinterpret_cast<const __nv_bfloat16*>(smem + a.buf[s.res_buf].off)
                                            : nullptr;
  const int res_cs = s.res_buf >= 0 ? a.buf[s.res_buf].cs : 0;
  const __nv_bfloat16* wg = a.w + s.wofs;
  const uint32_t wsm = smem_u32(smem) + s.wsm;
  // this lane's ldmatrix row of B: channel (lane>>4)*8 + (lane&7), K half (lane>>3)&1
  const uint32_t brow = static_cast<uint32_t>((((lane >> 4) * 8 + (lane & 7)) * s.kp + ((lane >> 3) & 1) * 8) * 2);
  const int* ko = koff + s.koff + (lane >> 4);
  const int nq = s.groups / 2;
  const bool l0 = s.kind == kStageL0;
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;

  for (int it = warp; it < items; it += kWarps) {
    const int ng = mtiles > 1 ? fast_div(it, s.mdiv) : it, mt = it - ng * mtiles, n0 = ng * 8 * NB;
    float2 bias[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) bias[j] = *reinterpret_cast<const float2*>(btab + s.bofs + n0 + 8 * j + 2 * tig);
    // A: this lane's position (the last one again past M) at tap 0
    int abase;
    {
      const int p = min(mt * 16 + (lane & 15), M - 1);
      const int r = fast_div(p, s.wdiv), x = s.col0 + p - r * s.width;
      if (l0) abase = (2 * r * (4 * Wc + 4) + 2 * x) * 4;
      else if (s.kind == kStageL1) abase = (2 * r * L0W + x) * in_cs;
      else abase = ((s.in_row0 + r) * Wc + x - (s.k == 3)) * in_cs + s.in_c;
    }
    const uint32_t abase_u32 = smem_u32(in + abase);
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      uint32_t af[4];
      ldsm_x4(abase_u32 + ko[2 * q] * 2, af[0], af[1], af[2], af[3]);
      uint32_t bf[NB][2];
      if (BSM) {
        const uint32_t bq = wsm + brow + (n0 * s.kp + 16 * q) * 2;
        if (NB == 1) {
          ldsm_x2(bq, bf[0][0], bf[0][1]);
        } else {
#pragma unroll
          for (int jp = 0; jp < NB / 2; ++jp)
            ldsm_x4(bq + jp * 16 * s.kp * 2, bf[2 * jp][0], bf[2 * jp][1], bf[2 * jp + 1][0], bf[2 * jp + 1][1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const __nv_bfloat16* wp = wg + (n0 + 8 * j + gid) * s.kp + 16 * q + 2 * tig;
          bf[j][0] = __ldg(reinterpret_cast<const unsigned int*>(wp));
          bf[j][1] = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_bf16(acc[j], af, bf[j][0], bf[j][1]);
    }
    // epilogue: bias, SiLU, bf16 (+ residual, bf16 again); zero outside the image
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + gid + 8 * h;
      if (p >= M) continue;
      const int r = fast_div(p, s.wdiv), x = s.col0 + p - r * s.width;
      bool inside;
      int o, ro = 0;
      if (l0) {
        const int gy = 2 * A - 1 + r, gx = 2 * g.X - 1 + x;
        inside = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
        o = (r * L0W + ((x & 1) ? Wc + 1 + (x >> 1) : (x >> 1))) * out_cs;
      } else {
        const int gy = A - s.lag + r, gx = g.X + x;
        inside = gy >= 0 && gy < H4 && gx >= 0 && gx < W4;
        o = s.kind == kStageLast ? (r * S + x - halo) * out_cs
                                 : ((s.out_row0 + r) * Wc + x) * out_cs + s.out_c;
        if (res) ro = ((s.res_row0 + r) * Wc + x) * res_cs + s.res_c;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int co = n0 + 8 * j + 2 * tig;
        __nv_bfloat162 v = __floats2bfloat162_rn(silu(acc[j][2 * h] + bias[j].x), silu(acc[j][2 * h + 1] + bias[j].y));
        if (res) {
          const float2 y = __bfloat1622float2(v);
          const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + ro + co));
          v = __floats2bfloat162_rn(y.x + rv.x, y.y + rv.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o + co) = inside ? v : __floats2bfloat162_rn(0.0f, 0.0f);
      }
    }
  }
}

__device__ __forceinline__ void stage(const StemArgs& a, const StageP s, unsigned char* smem, const int* koff,
                                      const float* btab, const Item g, int A) {
  const bool bsm = s.wsm >= 0;
  if (s.nb == 4) {
    if (bsm) run_stage<4, true>(a, s, smem, koff, btab, g, A);
    else run_stage<4, false>(a, s, smem, koff, btab, g, A);
  } else if (s.nb == 2) {
    if (bsm) run_stage<2, true>(a, s, smem, koff, btab, g, A);
    else run_stage<2, false>(a, s, smem, koff, btab, g, A);
  } else {
    if (bsm) run_stage<1, true>(a, s, smem, koff, btab, g, A);
    else run_stage<1, false>(a, s, smem, koff, btab, g, A);
  }
}

// K offset (elements, from the position's tap-0 address) of each 8-channel
// group of a stage; padding groups point at group 0 (finite data, weight 0)
__device__ __forceinline__ int k_offset(const StemArgs& a, const StageP& s, int grp) {
  const int Wc = a.Wc;
  if (s.kind == kStageL0) return ((grp >> 1) * (4 * Wc + 4) + 2 * (grp & 1)) * 4;  // (dy, pixel pair)
  const int c8 = s.cin / 8, tap = grp / c8, c = 8 * (grp % c8);
  if (tap >= s.k * s.k) return 0;
  const int dy = tap / s.k, dx = tap % s.k, cs = a.buf[s.in_buf].cs;
  if (s.kind == kStageL1) return (dy * (2 * Wc + 1) + (dx == 0 ? 0 : dx == 1 ? Wc + 1 : 1)) * cs + c;
  return (dy * Wc + dx) * cs + c;
}

__global__ void __launch_bounds__(kThreads, 1) stem_kernel(const __grid_constant__ StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* koff = reinterpret_cast<int*>(smem);  // the K-offset tables come first
  float* btab = reinterpret_cast<float*>(smem + a.bias_off);
  // resident weights, biases as f32 and the K-offset tables, once per block
  for (int si = 0; si < a.nstages; ++si) {
    const StageP& s = a.st[si];
    for (int i = threadIdx.x; i < s.groups; i += kThreads) koff[s.koff + i] = k_offset(a, s, i);
    for (int i = threadIdx.x; i < s.cout; i += kThreads)
      btab[s.bofs + i] = __bfloat162float(a.w[s.wofs + s.cout * s.kp + i]);
    if (s.wsm < 0) continue;
    const uint4* src = reinterpret_cast<const uint4*>(a.w + s.wofs);
    uint4* dst = reinterpret_cast<uint4*>(smem + s.wsm);
    for (int i = threadIdx.x; i < s.cout * s.kp / 8; i += kThreads) dst[i] = src[i];
  }

  int item = blockIdx.x, t = 0, half = 0;
  Item g = item_geometry(a, item);
  if (item < a.items) fetch_image_rows(a, smem, g, 0, 0);
  asm volatile("cp.async.commit_group;\n");
  while (item < a.items) {
    int next = item, nt = t + 1;
    Item gn = g;
    if (nt == g.steps) {
      next = item + gridDim.x;
      nt = 0;
      if (next < a.items) gn = item_geometry(a, next);
    }
    if (next < a.items) fetch_image_rows(a, smem, gn, nt, half ^ 1);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");  // this step's rows; the next step's may still fly
    __syncthreads();
    widen_image(a, smem, g, t, half);
    __syncthreads();
    const int A = g.a0 + a.R * t;  // first L1 row of this step
    for (int si = 0; si < a.nstages; ++si) {
      stage(a, a.st[si], smem, koff, btab, g, A);
      if (a.st[si].sync) __syncthreads();
    }
    // the finished rows leave in 16-byte stores: thread -> (column, 8 channels)
    const int H4 = a.H / 4, W4 = a.W / 4, c8 = a.c2 / 8, ocs = a.buf[kOut].cs;
    const int oc = threadIdx.x % c8, ox0 = threadIdx.x / c8, oxs = kThreads / c8;
    const uint4* ob = reinterpret_cast<const uint4*>(smem + a.buf[kOut].off);
    for (int r = 0; r < a.R; ++r) {
      const int gy = A - a.halo + r;
      if (gy < g.r0 || gy >= g.rend || ox0 >= oxs) continue;
      uint4* orow = reinterpret_cast<uint4*>(a.out + (static_cast<size_t>(g.b) * H4 + gy) * W4 * a.c2);
      for (int x = ox0; x < a.S && g.strip * a.S + x < W4; x += oxs)
        orow[(g.strip * a.S + x) * c8 + oc] = ob[(r * a.S + x) * ocs / 8 + oc];
    }
    // slide the carried line buffers down R rows, R rows at a time (the copies overlap)
    for (int lo = 0;; lo += a.R) {
      bool more = false;
      for (int ci = 0; ci < a.ncarry; ++ci) {
        const BufP bp = a.buf[a.carry[ci]];
        if (bp.rows <= lo + a.R) continue;
        more = true;
        const int row16 = a.Wc * bp.cs / 8, n = (min(bp.rows, lo + 2 * a.R) - lo - a.R) * row16;
        uint4* base = reinterpret_cast<uint4*>(smem + bp.off) + lo * row16;
        for (int i = threadIdx.x; i < n; i += kThreads) base[i] = base[i + a.R * row16];
      }
      if (!more) break;
      __syncthreads();
    }
    __syncthreads();
    half ^= 1;
    item = next;
    t = nt;
    g = gn;
  }
  asm volatile("cp.async.wait_all;\n");
}

// ---------------------------------------------------------------- host plan

struct Plan {
  StemArgs a;
  int smem_bytes;
};

// The stage list for a form, its line buffers and the shared-memory carve-up
// at strip width S and R stride-4 rows a step, before any weight is made
// resident. Returns the bytes.
int plan_layout(StemArgs& a, int c0, int c1, int ch, int n, int c3k, int S, int R) {
  const int h = a.halo, Wc = S + 2 * h, c_ = ch / 2, cys = (2 + n) * ch;
  a.S = S;
  a.Wc = Wc;
  a.R = R;
  a.warm = (2 * h + R - 1) / R;
  int nst = 0, nbuf = kFirstScratch;
  a.ncarry = 0;
  for (int i = 0; i < kMaxBufs; ++i) a.buf[i] = BufP{0, 0, 0};
  a.buf[kImg].cs = 4;
  a.buf[kL0].cs = chan_stride(c0);
  a.buf[kL1].cs = chan_stride(c1);
  a.buf[kYs].cs = chan_stride(cys);
  a.buf[kOut].cs = chan_stride(a.c2);
  auto add_buf = [&](int c) { a.buf[nbuf].cs = chan_stride(c); return nbuf++; };
  int wofs = 0;
  auto add = [&](int kind, int k, int cin, int cout, int lag, int in_buf, int in_c, int out_buf, int out_c,
                 int res_buf, int res_c) {
    StageP& s = a.st[nst++];
    s = StageP{};
    s.kind = kind; s.k = k; s.cin = cin; s.cout = cout; s.sync = 1; s.lag = lag;
    const int K = kind == kStageL0 ? 48 : k * k * cin;
    s.kp = round16(K) + 8;
    s.groups = round16(K) / 8;
    s.in_buf = in_buf; s.in_c = in_c; s.out_buf = out_buf; s.out_c = out_c;
    s.res_buf = res_buf; s.res_c = res_c;
    s.wofs = wofs;
    s.wsm = -1;
    wofs += cout * s.kp + cout;
    if (kind == kStageL0) { s.rows = 2 * R + 1; s.col0 = 0; s.width = 2 * Wc + 1; }
    else { s.rows = R; s.col0 = lag; s.width = Wc - 2 * lag; }
    s.wdiv = div_magic(s.width);
    s.mdiv = div_magic(max((s.rows * s.width + 15) / 16, 2));
    return nst - 1;
  };
  add(kStageL0, 3, 4, c0, 0, kImg, 0, kL0, 0, -1, 0);
  add(kStageL1, 3, c0, c1, 0, kL0, 0, kL1, 0, -1, 0);
  add(kStageConv, 1, c1, 2 * ch, 0, kL1, 0, kYs, 0, -1, 0);
  for (int i = 0; i < n; ++i) {
    const int L = i * (c3k ? 4 : 2), yin = (1 + i) * ch, yout = (2 + i) * ch;
    if (!c3k) {  // Bottleneck(ch, ch, e=0.5): 3x3 ch -> ch/2 -> ch, + shortcut
      const int scr = add_buf(c_);
      add(kStageConv, 3, ch, c_, L + 1, kYs, yin, scr, 0, -1, 0);
      add(kStageConv, 3, c_, ch, L + 2, scr, 0, kYs, yout, kYs, yin);
    } else {  // C3k(ch, ch, n=2): cv1/cv2 1x1 -> c_, two 3x3 bottlenecks on a, cv3 1x1
      const int a0 = add_buf(c_), t1 = add_buf(c_), a1 = add_buf(c_), t2 = add_buf(c_), ab = add_buf(2 * c_);
      a.st[add(kStageConv, 1, ch, c_, L, kYs, yin, a0, 0, -1, 0)].sync = 0;
      add(kStageConv, 1, ch, c_, L, kYs, yin, ab, c_, -1, 0);
      add(kStageConv, 3, c_, c_, L + 1, a0, 0, t1, 0, -1, 0);
      add(kStageConv, 3, c_, c_, L + 2, t1, 0, a1, 0, a0, 0);
      add(kStageConv, 3, c_, c_, L + 3, a1, 0, t2, 0, -1, 0);
      add(kStageConv, 3, c_, c_, L + 4, t2, 0, ab, 0, a1, 0);
      add(kStageConv, 1, 2 * c_, ch, L + 4, ab, 0, kYs, yout, -1, 0);
    }
  }
  add(kStageLast, 1, cys, a.c2, h, kYs, 0, kOut, 0, -1, 0);
  a.nstages = nst;
  // row windows of the stride-4 line buffers: E = the deepest row a reader
  // needs below the newest L1 row, D = R + E - (the shallowest writer's lag)
  for (int bi = kL1; bi < nbuf; ++bi) {
    if (bi == kOut) continue;
    int E = 0, lw = 1 << 20;
    for (int si = 0; si < nst; ++si) {
      const StageP& s = a.st[si];
      if (s.kind != kStageL0 && s.in_buf == bi) E = max(E, s.lag + (s.k == 3));
      if (s.res_buf == bi) E = max(E, s.lag);
      if (s.out_buf == bi) lw = min(lw, s.lag);
    }
    a.buf[bi].rows = R + E - lw;
    if (a.buf[bi].rows > R) a.carry[a.ncarry++] = bi;
    for (int si = 0; si < nst; ++si) {
      StageP& s = a.st[si];
      if (s.kind != kStageL0 && s.kind != kStageL1 && s.in_buf == bi) s.in_row0 = E - s.lag - (s.k == 3);
      if (s.res_buf == bi) s.res_row0 = E - s.lag;
      if (s.out_buf == bi) s.out_row0 = E - s.lag;
    }
  }
  // carve-up: [K offsets][raw x2][IMG | L1][L0 | OUT][YS][scratch...]
  int koff = 0;
  a.nbias = 0;
  for (int si = 0; si < nst; ++si) {
    a.st[si].koff = koff;
    koff += a.st[si].groups;
    a.st[si].bofs = a.nbias;
    a.nbias += a.st[si].cout;
  }
  const int wimg = 4 * Wc + 4, img_rows = 4 * R + 3;
  a.rawb = align16(3 * wimg + 32);
  int off = align16(4 * koff);
  a.bias_off = off;
  off += align16(4 * a.nbias);
  a.buf[kRaw].off = off;
  off += align16(2 * img_rows * a.rawb);
  a.buf[kImg].off = a.buf[kL1].off = off;
  off += align16(max(img_rows * wimg * 4 * 2, R * Wc * a.buf[kL1].cs * 2));
  a.buf[kL0].off = a.buf[kOut].off = off;
  off += align16(max((2 * R + 1) * (2 * Wc + 1) * a.buf[kL0].cs * 2, R * S * a.buf[kOut].cs * 2));
  for (int bi = kYs; bi < nbuf; ++bi) {
    if (bi == kOut) continue;
    a.buf[bi].off = off;
    off += align16(a.buf[bi].rows * Wc * a.buf[bi].cs * 2);
  }
  return off;
}

// A warp tile of NB x 8 channels per stage: the fewest rounds of the
// block's warps, a round costing NB MMAs and two loads per K step plus a
// fixed set-up and epilogue (about 60 K steps' worth, from the first
// on-card phase profile).
int pick_nb(int mtiles, int cout, int ksteps) {
  int best = 1, best_cost = 1 << 30;
  for (int nb = 1; nb <= 4; nb *= 2) {
    if (cout % (8 * nb)) break;
    const int items = mtiles * cout / (8 * nb);
    const int cost = (items + kWarps - 1) / kWarps * (ksteps * (nb + 2) + 60);
    if (cost <= best_cost) { best = nb; best_cost = cost; }
  }
  return best;
}

}  // namespace

// x: uint8 (B, H, W, 3), 4-byte aligned; wflat: the folded bf16 convs in
// fold_stem_params order, each weight as [cout][K padded to an odd multiple
// of 8] (K = (tap, cin); L0: (dy, dx of 4, rgb + 0) = 48) followed by its
// bias [cout] (ops/stem.py stem_weights), 16-byte aligned; out: bf16 (B,
// H/4, W/4, c2). The wrapper checks shapes, dtypes, contiguity, channel
// multiples of 8 and n <= 4. Rows per step and strip width come from the
// device's shared memory per block (design point 1); weights are made
// resident while they fit. A spec whose line buffers fit no candidate (the
// l/x forms) returns cudaErrorInvalidValue unlaunched.
extern "C" int fce_fused_stem(const void* x, const void* wflat, void* out, int B, int H, int W,
                              int c0, int c1, int c2, int ch, int n, int c3k, void* stream) {
  if (n < 1 || n > kMaxInner || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  StemArgs a{};
  a.x = static_cast<const uint8_t*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.w = static_cast<const __nv_bfloat16*>(wflat);
  a.B = B; a.H = H; a.W = W; a.c2 = c2;
  a.vec = (3 * W) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 16 : 4;
  a.halo = n * (c3k ? 4 : 2);
  // (R, S) in order of preference: the first whose line buffers and all
  // weights fit, else the first whose line buffers fit
  const int cand[][2] = {{4, 32}, {4, 28}, {2, 32}, {4, 16}, {2, 16}, {2, 8}};
  int pick = -1, bytes = 0;
  for (int pass = 0; pass < 2 && pick < 0; ++pass) {
    for (int i = 0; i < 6 && pick < 0; ++i) {
      bytes = plan_layout(a, c0, c1, ch, n, c3k, cand[i][1], cand[i][0]);
      int wbytes = 0;
      for (int si = 0; si < a.nstages; ++si) wbytes += align16(a.st[si].cout * a.st[si].kp * 2);
      if (bytes + (pass == 0 ? wbytes : 0) <= smem_limit) pick = i;
    }
  }
  if (pick < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int si = 0; si < a.nstages; ++si) {  // resident weights while they fit
    StageP& s = a.st[si];
    const int wb = s.cout * s.kp * 2;
    if (bytes + wb <= smem_limit) { s.wsm = bytes; bytes += align16(wb); }
    s.nb = pick_nb((s.rows * s.width + 15) / 16, s.cout, s.groups / 2);
  }
  err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = sms * per_sm, H4 = H / 4, W4 = W / 4;
  a.nstrips = (W4 + a.S - 1) / a.S;
  // band height: the fewest steps on the busiest block (rounds of items x steps per item)
  long best = -1;
  for (int hb = a.R; hb < H4 + a.R; hb += a.R) {
    const int nbands = (H4 + hb - 1) / hb, items = B * a.nstrips * nbands;
    const long cost = static_cast<long>((items + slots - 1) / slots) * (a.warm + hb / a.R);
    if (best < 0 || cost < best) { best = cost; a.Hb = hb; a.nbands = nbands; a.items = items; }
  }
  const int grid = a.items < slots ? a.items : slots;
  stem_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
