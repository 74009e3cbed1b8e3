// A CPU stand-in for the CUDA runtime pieces that the port's kernels
// (csrc/*.cu) use, so a kernel's source compiles with g++ and runs here:
// blocks one after another, one std::thread per CUDA thread, std::barrier
// for __syncthreads and for the warp collectives (runtime.cpp; ldmatrix and
// mma.sync are emulated lane by lane there). Float intrinsics are plain
// float operations: compiled with -ffp-contract=off they round as the card
// does. Test support for tests/test_torch_*_emulated.py only.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(x)
#define __restrict__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrMultiProcessorCount = 16,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, blockDim, gridDim;
extern unsigned char* g_smem;
extern int g_sms;

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an H100's opt-in shared memory per block; a few SMs keep the grid small
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : g_sms;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, int smem) {
  *n = std::min(233472 / (smem + 1024), 32);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// copies and events on the host: one stream, run in order, so a copy is a memcpy and an event times nothing
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1, cudaMemcpyDeviceToHost = 2 };
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n, cudaMemcpyKind, cudaStream_t) {
  std::memcpy(dst, src, n);
  return cudaSuccess;
}
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
typedef int cudaEvent_t;
inline cudaError_t cudaEventCreate(cudaEvent_t* e) { *e = 0; return cudaSuccess; }
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaEventElapsedTime(float* ms, cudaEvent_t, cudaEvent_t) { *ms = 0.0f; return cudaSuccess; }
inline cudaError_t cudaEventDestroy(cudaEvent_t) { return cudaSuccess; }
void __syncthreads();
inline size_t __cvta_generic_to_shared(const void* p) { return static_cast<const unsigned char*>(p) - g_smem; }

struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline unsigned __umulhi(unsigned a, unsigned b) { return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32); }
template <class T> T __ldg(const T* p) { return *p; }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

// warp collectives over the 32 lanes of the calling thread's warp; every lane takes part
void __syncwarp(unsigned mask = 0xffffffffu);
unsigned __ballot_sync(unsigned mask, int pred);
uint64_t emu_shfl(uint64_t v, int src_lane);
template <class T> T __shfl_sync(unsigned, T v, int src_lane) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  u = emu_shfl(u, src_lane & 31);
  std::memcpy(&v, &u, sizeof(T));
  return v;
}
template <class T> T __shfl_down_sync(unsigned mask, T v, unsigned delta) {
  const unsigned lane = threadIdx.x & 31;
  return __shfl_sync(mask, v, static_cast<int>(lane + delta < 32 ? lane + delta : lane));
}

void emu_ldmatrix(uint32_t addr, int nmat, uint32_t* r);
void emu_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1);

std::vector<char> emu_read_file(const char* path);
void emu_write_file(const char* path, const void* data, size_t bytes);

// Run body for every block of grid, each block with block.x threads.
void emu_grid(dim3 grid, dim3 block, const std::function<void()>& body);
// kernel<<<grid, block, smem, stream>>>(args...) with the stream dropped
template <class... P, class... A>
void emu_launch(dim3 grid, dim3 block, size_t, void (*kernel)(P...), A... args) {
  emu_grid(grid, block, [&] { kernel(args...); });
}
