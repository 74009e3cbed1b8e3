// Runs csrc/stem.cu's kernel on the CPU (see cuda_runtime.h). The test
// writes stem_emu.cu: stem.cu with the bodies of its inline-PTX helpers
// replaced by calls into this file and the launch replaced by emu_launch.
//
//   emu B H W c0 c1 c2 ch n c3k sms x.bin w.bin out.bin
//
// x.bin: uint8 (B, H, W, 3); w.bin: the packed bf16 weights; out.bin: bf16
// (B, H/4, W/4, c2). The kernel's plan goes to stderr. Exit 3: the entry
// point refused the spec.
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"
#define EMU_ASM(...)
#include "stem_emu.cu"

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim;
alignas(16) static unsigned char smem_store[262144];
unsigned char* g_smem = smem_store;
int g_sms = 4;
static std::unique_ptr<std::barrier<>> g_block;
static std::vector<std::unique_ptr<std::barrier<>>> g_warp;
static constexpr int kMaxThreads = 1024;

void __syncthreads() { g_block->arrive_and_wait(); }
static void warp_sync() { g_warp[threadIdx.x / 32]->arrive_and_wait(); }

// ldmatrix .x1/.x2/.x4: lane l receives, of matrix i, row l / 4 and its
// elements 2 (l % 4), 2 (l % 4) + 1; lane 8 i + j gives matrix i's row j
void emu_ldmatrix(uint32_t addr, int nmat, uint32_t* r) {
  static uint32_t addrs[kMaxThreads];
  const int t = threadIdx.x, w0 = t & ~31, l = t & 31;
  addrs[t] = addr;
  warp_sync();
  for (int i = 0; i < nmat; ++i) {
    const uint32_t a = addrs[w0 + 8 * i + l / 4];
    if (a % 16) {
      std::fprintf(stderr, "ldmatrix row address %u is not 16-byte aligned\n", a);
      std::abort();
    }
    std::memcpy(&r[i], g_smem + a + 4 * (l % 4), 4);
  }
  warp_sync();
}

static float half_of(uint32_t word, int hi) {
  return __bfloat162float(__nv_bfloat16{static_cast<unsigned short>(hi ? word >> 16 : word & 0xffff)});
}

// mma.sync m16n8k16 row.col bf16 -> f32, from the PTX fragment layouts
void emu_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  static uint32_t A[kMaxThreads][4], B[kMaxThreads][2];
  const int t = threadIdx.x, w0 = t & ~31, l = t & 31, gid = l >> 2, tig = l & 3;
  for (int i = 0; i < 4; ++i) A[t][i] = a[i];
  B[t][0] = b0;
  B[t][1] = b1;
  warp_sync();
  for (int h = 0; h < 2; ++h) {
    for (int e = 0; e < 2; ++e) {
      const int row = gid + 8 * h, col = 2 * tig + e;
      float s = c[2 * h + e];
      for (int k = 0; k < 16; ++k) {
        const uint32_t av = A[w0 + (row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
        const uint32_t bv = B[w0 + col * 4 + (k % 8) / 2][k >= 8];
        s += half_of(av, k % 2) * half_of(bv, k % 2);
      }
      c[2 * h + e] = s;
    }
  }
  warp_sync();
}

void emu_launch(int grid, int bytes, const StemArgs& a) {
  std::fprintf(stderr, "plan R=%d S=%d Wc=%d Hb=%d items=%d grid=%d smem=%d\n", a.R, a.S, a.Wc, a.Hb, a.items,
               grid, bytes);
  gridDim.x = grid;
  g_block = std::make_unique<std::barrier<>>(kThreads);
  g_warp.clear();
  for (int w = 0; w < kWarps; ++w) g_warp.push_back(std::make_unique<std::barrier<>>(32));
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(smem_store, 0xff, sizeof smem_store);  // NaN in every buffer a block has not written
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) threads.emplace_back([&a, t] { threadIdx.x = t; stem_kernel(a); });
    for (auto& th : threads) th.join();
  }
}

static std::vector<char> slurp(const char* path) {
  std::vector<char> v;
  FILE* f = std::fopen(path, "rb");
  if (!f) std::abort();
  char buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0) v.insert(v.end(), buf, buf + n);
  std::fclose(f);
  return v;
}

int main(int argc, char** argv) {
  if (argc != 14) return 2;
  const int B = std::atoi(argv[1]), H = std::atoi(argv[2]), W = std::atoi(argv[3]), c2 = std::atoi(argv[6]);
  g_sms = std::atoi(argv[10]);
  const std::vector<char> x = slurp(argv[11]), w = slurp(argv[12]);
  std::vector<char> out(static_cast<size_t>(B) * (H / 4) * (W / 4) * c2 * 2, 0);
  const int err = fce_fused_stem(x.data(), w.data(), out.data(), B, H, W, std::atoi(argv[4]), std::atoi(argv[5]),
                                 c2, std::atoi(argv[7]), std::atoi(argv[8]), std::atoi(argv[9]), nullptr);
  if (err) return 3;
  FILE* f = std::fopen(argv[13], "wb");
  std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return 0;
}
