// The shared part of the CUDA stand-in (see cuda_runtime.h): thread and
// block indices, shared memory, barriers, warp collectives, ldmatrix and
// mma.sync lane by lane, the grid runner and file helpers. Each kernel's
// driver (stem_main.cpp, nms_main.cpp) links against it.
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim, gridDim;
alignas(16) static unsigned char smem_store[262144];
unsigned char* g_smem = smem_store;
int g_sms = 4;
static std::unique_ptr<std::barrier<>> g_block;
static std::vector<std::unique_ptr<std::barrier<>>> g_warp;
static constexpr int kMaxThreads = 1024;

void __syncthreads() { g_block->arrive_and_wait(); }
static void warp_sync() { g_warp[threadIdx.x / 32]->arrive_and_wait(); }
void __syncwarp(unsigned) { warp_sync(); }

unsigned __ballot_sync(unsigned, int pred) {
  static int vote[kMaxThreads];
  const int t = threadIdx.x, w0 = t & ~31;
  vote[t] = pred != 0;
  warp_sync();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= static_cast<unsigned>(vote[w0 + l]) << l;
  warp_sync();
  return r;
}

uint64_t emu_shfl(uint64_t v, int src_lane) {
  static uint64_t vals[kMaxThreads];
  const int t = threadIdx.x;
  vals[t] = v;
  warp_sync();
  const uint64_t r = vals[(t & ~31) + src_lane];
  warp_sync();
  return r;
}

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

std::vector<char> emu_read_file(const char* path) {
  std::vector<char> v;
  FILE* f = std::fopen(path, "rb");
  if (!f) std::abort();
  char buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0) v.insert(v.end(), buf, buf + n);
  std::fclose(f);
  return v;
}

void emu_write_file(const char* path, const void* data, size_t bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) std::abort();
  std::fwrite(data, 1, bytes, f);
  std::fclose(f);
}

void emu_grid(dim3 grid, dim3 block, const std::function<void()>& body) {
  const int threads = static_cast<int>(block.x);
  if (threads < 1 || threads > kMaxThreads || threads % 32) {
    std::fprintf(stderr, "emu_grid: %d threads per block (1-D, whole warps, at most %d)\n", threads, kMaxThreads);
    std::abort();
  }
  gridDim = grid;
  blockDim = block;
  g_block = std::make_unique<std::barrier<>>(threads);
  g_warp.clear();
  for (int w = 0; w < threads / 32; ++w) g_warp.push_back(std::make_unique<std::barrier<>>(32));
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::memset(smem_store, 0xff, sizeof smem_store);  // NaN in every buffer a block has not written
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t) pool.emplace_back([&body, t] { threadIdx = dim3(t, 0, 0); body(); });
        for (auto& th : pool) th.join();
      }
    }
  }
}
